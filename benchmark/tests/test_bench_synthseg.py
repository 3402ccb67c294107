"""The cell ``scan_synthseg`` cut to the CPU (4 base filters, two 24 x 28 x
22 scans padded to 32^3): it comes out correct; each planted fault and the
TF32 control do not; the configuration's FLOP count against a count by
hand; the configuration's tables against the program's."""

import dataclasses
import json
import tempfile
import time
from pathlib import Path

import pytest
import tiny  # noqa: F401  (puts the checkout on sys.path)
from tiny import ROOT

from benchmark import faults_synthseg, harness

CUT_CONFIG = dict(unet_feat_count=4)
CUT_TRAFFIC = dict(shape=[24, 28, 22], scans=2)
SEED = 2 ** 33 + 5


def cell() -> harness.Cell:
    c = harness.resolve(harness.load_manifest(ROOT), "scan_synthseg", ROOT)
    return dataclasses.replace(c, config=dict(c.config, **CUT_CONFIG),
                               traffic=dict(c.traffic, **CUT_TRAFFIC))


def execute(seconds: float = 1.0) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        return harness.execute(cell(), "cpu", SEED, seconds, False,
                               Path(tmp), time.perf_counter())


def test_the_cut_cell_is_correct():
    out = execute()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"scan_s", "setup_s"}


# the number each fault moves past its limit
MOVES = {"flipped_forward_left_out": "posterior_gap",
         "lr_swap_left_out": "posterior_gap", "skip_zeroed": "posterior_gap",
         "average_left_out": "posterior_error",
         "topology_skipped": "topology_mismatch"}


@pytest.mark.parametrize("fault", sorted(faults_synthseg.FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    faults_synthseg.FAULTS[fault](monkeypatch.setattr)
    out = execute()
    assert not out["correct"], out["checks"]
    check = out["checks"][MOVES[fault]]
    assert check["value"] > check["limit"], out["checks"]


def test_the_control_fails(tmp_path):
    """The reference in TF32 put in the program's place reads a posterior
    gap and a posterior error over their limits, where the program reads
    under them."""
    c = cell()
    run = harness.Run(c, "cpu", SEED, 0.0, False, tmp_path)
    drv = harness.load_module(harness.HERE / "drivers" /
                              "synth_loop.py").Driver(run)
    drv.setup()
    ok, rows = harness.judge(drv.readings(), c.limits)
    assert ok, rows
    control = drv.control()
    for name in ("posterior_gap", "posterior_error"):
        ok, rows = harness.judge({name: control[name]},
                                 {name: c.limits[name]})
        assert not ok, rows


def test_every_span_reader_reads_the_window(tmp_path):
    """With the program's recorder on over a cut window, each of the cell's
    ``program_span`` readers reads a number, and the stages they read lie
    inside the benchmark's span around each call."""
    from subcort_tpu_torch.utils import runtime

    c = cell()
    run = harness.Run(c, "cpu", SEED, 1.0, False, tmp_path)
    drv = harness.load_module(harness.HERE / "drivers" /
                              "synth_loop.py").Driver(run)
    drv.setup()
    runtime.clear_records()
    try:
        with runtime.recording():
            drv.window()
        got = {m["name"]: harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py").read(run)
            for m in c.per_layer if m["source"] == "program_span"}
    finally:
        runtime.clear_records()
    assert sorted(got) == ["synthseg_forward_s.synthseg",
                           "synthseg_readback_s.synthseg",
                           "synthseg_topology_s.synthseg"]
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert sum(got.values()) <= run.spans.mean("segment_synthseg")
    assert run.counts["forwards"] == 2 * run.counts["attempted"]


def test_flops_against_a_hand_count():
    """At 192 x 224 x 192, levels of 8,257,536, 1,032,192, 129,024,
    16,128 and 2,016 voxels at 24, 48, 96, 192 and 384 filters; two 3^3
    convolutions a level down (the first from 1 channel) and up (the
    first from the upsampled and the skip channels); the 1^3 output to
    33 classes."""
    c = harness.resolve(harness.load_manifest(ROOT), "scan_synthseg", ROOT)
    v = [8_257_536, 1_032_192, 129_024, 16_128, 2_016]
    f = [24, 48, 96, 192, 384]
    total = 2 * 27 * v[0] * (1 * 24 + 24 * 24)
    for k in range(1, 5):
        total += 2 * 27 * v[k] * (f[k - 1] * f[k] + f[k] * f[k])
    for k in range(4):
        total += 2 * 27 * v[k] * ((f[k + 1] + f[k]) * f[k] + f[k] * f[k])
    total += 2 * v[0] * 24 * 33
    assert total == 2_568_126_726_144
    assert c.flops.forward_flops(c.config, (192, 224, 192)) == total
    assert c.flops.scan_flops(c.config, (181, 217, 181)) == 2 * total \
        == 5_136_253_452_288


def test_the_configuration_states_the_program_tables():
    """The tables the configuration assumes are the ones the program
    defaults to (each non-background channel its own topological class, as
    ``keep_largest`` takes them), and its widths the published ones."""
    from subcort_tpu_torch.engine import synthseg
    from subcort_tpu_torch.models.synthseg import SynthSegSpec, num_params
    with open(ROOT / "benchmark/configs/synthseg_unet.json") as fh:
        cfg = json.load(fh)
    assert tuple(cfg["labels"]) == synthseg.LABELS
    assert tuple(map(tuple, cfg["lr_pairs"])) == synthseg.LR_PAIRS
    assert cfg["topology_classes"] == list(range(len(synthseg.LABELS)))
    assert tuple(cfg["structure_of"]) == synthseg.structure_of()
    spec = SynthSegSpec()
    assert (cfg["n_levels"], cfg["nb_conv_per_level"], cfg["conv_size"],
            cfg["unet_feat_count"], cfg["feat_multiplier"],
            cfg["num_classes"], cfg["bn_eps"]) == (
        spec.levels, spec.convs_per_level, spec.kernel, spec.base_filters,
        spec.multiplier, spec.num_classes, spec.bn_eps)
    assert cfg["parameters"] == num_params() == 13_242_849
    assert cfg["reduced"] == []
