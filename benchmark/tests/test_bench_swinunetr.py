"""The cell ``scan_swinunetr`` cut to the CPU (12 features, 5^3 windows, a
64^3 roi, two 64 x 100 x 60 scans: 3 windows each): it comes out correct;
each planted fault and the TF32 control do not; the span and counter
readers read the window; the configuration's FLOP count against a count
by hand; the configuration's widths against the program's."""

import dataclasses
import json
import tempfile
import time
from pathlib import Path

import pytest
import tiny  # noqa: F401  (puts the checkout on sys.path)
import torch
from tiny import ROOT

from benchmark import faults_swinunetr, harness

torch.set_num_threads(1)

CUT_CONFIG = dict(feature_size=12, window_size=5, roi=[64, 64, 64])
CUT_TRAFFIC = dict(shape=[64, 100, 60], scans=2)
SEED = 2 ** 33 + 5


@pytest.fixture()
def program_windows(monkeypatch):
    """The program's windows at the cut roi (the reference takes the
    configuration's)."""
    from subcort_tpu_torch.engine import swinunetr
    monkeypatch.setattr(swinunetr, "ROI", CUT_CONFIG["roi"][0])


def cell() -> harness.Cell:
    c = harness.resolve(harness.load_manifest(ROOT), "scan_swinunetr", ROOT)
    return dataclasses.replace(c, config=dict(c.config, **CUT_CONFIG),
                               traffic=dict(c.traffic, **CUT_TRAFFIC))


def execute(seconds: float = 1.0) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        return harness.execute(cell(), "cpu", SEED, seconds, False,
                               Path(tmp), time.perf_counter())


def driver(tmp_path, seconds: float = 0.0):
    run = harness.Run(cell(), "cpu", SEED, seconds, False, tmp_path)
    drv = harness.load_module(harness.HERE / "drivers" /
                              "swin_loop.py").Driver(run)
    drv.setup()
    return run, drv


def test_the_cut_cell_is_correct(program_windows):
    out = execute()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"scan_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults_swinunetr.FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, program_windows,
                                            fault):
    faults_swinunetr.FAULTS[fault](monkeypatch.setattr)
    out = execute()
    assert not out["correct"], out["checks"]
    check = out["checks"]["logit_error"]
    assert check["value"] > check["limit"], out["checks"]


def test_the_control_fails(tmp_path, program_windows):
    """The reference in TF32 put in the program's place reads a logit
    error over its limit, where the program reads under every limit."""
    run, drv = driver(tmp_path)
    c = run.cell
    ok, rows = harness.judge(drv.readings(), c.limits)
    assert ok, rows
    control = drv.control()
    ok, rows = harness.judge({"logit_error": control["logit_error"]},
                             {"logit_error": c.limits["logit_error"]})
    assert not ok, rows


def test_every_reader_reads_the_window(tmp_path, program_windows):
    """With the program's recorder on over a cut window, the encoder's and
    the decoder's span readers read a number, and the windows counted are
    the scans' windows."""
    from subcort_tpu_torch.utils import runtime

    run, drv = driver(tmp_path, 1.0)
    runtime.clear_records()
    try:
        with runtime.recording():
            drv.window()
        got = {m["name"]: harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py").read(run)
            for m in run.cell.per_layer if m["source"] == "program_span"}
    finally:
        runtime.clear_records()
    assert sorted(got) == ["decoder_device_ms.swinunetr",
                           "encoder_device_ms.swinunetr"]
    assert all(v is not None and v > 0 for v in got.values()), got
    assert run.counts["windows"] == 3 * run.counts["attempted"]
    assert run.counts["flops"] == run.counts["attempted"] * \
        run.cell.flops.scan_flops(run.cell.config, (64, 100, 60))


def test_readers_without_spans_read_nothing(tmp_path):
    """A program that records no span (the parent's, or an untraced run)
    leaves the span readers at None, and they do not raise."""
    from subcort_tpu_torch.utils import runtime

    runtime.clear_records()
    run = harness.Run(cell(), "cpu", SEED, 0.0, False, tmp_path)
    for name in ("encoder_device_ms.swinunetr", "decoder_device_ms.swinunetr",
                 "window_device_ms.swinunetr", "mfu.swinunetr",
                 "device_idle.swinunetr"):
        assert harness.load_module(
            harness.HERE / "metrics" / f"{name}.py").read(run) is None


def test_flops_against_a_hand_count():
    """One 128^3 window at the published widths, counted by hand: the patch
    embedding; per stage (side 64, 32, 16, 8; padded 70, 35, 21, 14) two
    blocks of qkv and output linears on the padded tokens, the MLP on the
    stage's tokens and 4 n^2 C a window of 343 tokens, then merging; the
    decoder's res blocks, transposed convolutions and output."""
    c = harness.resolve(harness.load_manifest(ROOT), "scan_swinunetr", ROOT)
    f = 48
    total = 2 * 64 ** 3 * 1 * f * 8
    for s, (side, pad) in enumerate(((64, 70), (32, 35), (16, 21),
                                     (8, 14))):
        ch = f * 2 ** s
        blk = (2 * pad ** 3 * ch * 3 * ch + 2 * pad ** 3 * ch * ch
               + 4 * side ** 3 * ch * 4 * ch
               + 4 * 343 ** 2 * ch * (pad // 7) ** 3)
        total += 2 * blk + 2 * (side // 2) ** 3 * 8 * ch * 2 * ch
    v = [128 ** 3 // 8 ** i for i in range(6)]

    def conv(vox, a, b, k):
        return 2 * vox * a * b * k ** 3

    total += conv(v[0], 1, f, 3) + conv(v[0], f, f, 3) + conv(v[0], 1, f, 1)
    for lv, ch in ((1, f), (2, 2 * f), (3, 4 * f), (5, 16 * f)):
        total += 2 * conv(v[lv], ch, ch, 3)
    for lv, a, b in ((4, 16 * f, 8 * f), (3, 8 * f, 4 * f),
                     (2, 4 * f, 2 * f), (1, 2 * f, f), (0, f, f)):
        total += (2 * v[lv + 1] * a * b * 8 + conv(v[lv], 2 * b, b, 3)
                  + conv(v[lv], b, b, 3) + conv(v[lv], 2 * b, b, 1))
    total += conv(v[0], f, 15, 1)
    assert total == 1_528_187_479_296
    assert c.flops.window_flops(c.config) == total
    assert c.flops.windows(c.config, (181, 217, 181)) == 12
    assert c.flops.scan_flops(c.config) == 12 * total == 18_338_249_751_552


def test_the_configuration_states_the_program_widths():
    from subcort_tpu_torch.engine import swinunetr
    from subcort_tpu_torch.models.swinunetr import (MASK_VALUE,
                                                    MERGE_OFFSETS,
                                                    SwinUNETRSpec, num_params)
    from benchmark import weights_swinunetr
    with open(ROOT / "benchmark/configs/swin_unetr.json") as fh:
        cfg = json.load(fh)
    spec = SwinUNETRSpec()
    assert (cfg["feature_size"], tuple(cfg["depths"]),
            tuple(cfg["num_heads"]), cfg["window_size"], cfg["patch_size"],
            cfg["mlp_ratio"], cfg["in_channels"], cfg["out_channels"]) == (
        spec.feature_size, spec.depths, spec.num_heads, spec.window_size,
        spec.patch_size, spec.mlp_ratio, spec.in_channels,
        spec.out_channels)
    assert cfg["parameters"] == num_params() == \
        weights_swinunetr.n_leaves(cfg) == 62_187_345
    assert (cfg["roi"], cfg["overlap"], cfg["sw_batch_size"],
            cfg["sigma_scale"], cfg["min_weight"]) == (
        [swinunetr.ROI] * 3, swinunetr.OVERLAP, swinunetr.SW_BATCH_SIZE,
        swinunetr.SIGMA_SCALE, swinunetr.MIN_WEIGHT)
    assert cfg["mask_value"] == MASK_VALUE
    assert len(MERGE_OFFSETS) == 8
    assert cfg["compute_dtype"] == "float32" and cfg["tf32"] is False
    manifest = harness.load_manifest(ROOT)
    conf = {c["name"]: c for c in manifest["configs"]}["swin_unetr"]
    assert conf["reduced"] == []
