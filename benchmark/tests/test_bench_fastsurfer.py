"""The cell ``scan_fastsurfer`` cut to the CPU (8 filters, a 32^3
conformed volume, two 24 x 28 x 22 scans): it comes out correct; each
planted fault and the TF32 control do not; the configuration's FLOP count
against a count by hand; the configuration's tables against the
program's."""

import dataclasses
import json
import math
import tempfile
import time
from pathlib import Path

import pytest
import tiny  # noqa: F401  (puts the checkout on sys.path)
from tiny import ROOT

from benchmark import faults_more, harness

CUT_CONFIG = dict(num_filters=8, height=32, width=32)
CUT_TRAFFIC = dict(shape=[24, 28, 22], scans=2, batch=8)
SEED = 2 ** 33 + 5


def cell() -> harness.Cell:
    c = harness.resolve(harness.load_manifest(ROOT), "scan_fastsurfer", ROOT)
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
    assert out["checks"]["flipped_voxels"]["value"] == 0


@pytest.mark.parametrize("fault", ["sagittal_left_out", "maxout_conv_branch",
                                   "thick_slices_shifted"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    faults_more.FAULTS[fault](monkeypatch.setattr)
    out = execute()
    assert not out["correct"], out["checks"]


def test_the_control_fails(tmp_path):
    """The reference in TF32 put in the program's place flips voxels where
    the program flips none; against the limit scaled to the cut's voxels
    (the limit counts over three MNI-sized scans) it fails."""
    c = cell()
    run = harness.Run(c, "cpu", SEED, 0.0, False, tmp_path)
    drv = harness.load_module(harness.HERE / "drivers" /
                              "views_loop.py").Driver(run)
    drv.setup()
    assert drv.readings()["flipped_voxels"] == 0
    numbers = drv.control()
    cut = len(drv.scans) * math.prod(CUT_TRAFFIC["shape"])
    full = 3 * math.prod(harness.resolve(
        harness.load_manifest(ROOT), "scan_fastsurfer", ROOT)
        .traffic["shape"])
    limits = {"flipped_voxels": {
        "limit": c.limits["flipped_voxels"]["limit"] * cut / full}}
    ok, rows = harness.judge(numbers, limits)
    assert not ok and numbers["flipped_voxels"] > 0, rows


def test_flops_against_a_hand_count():
    """Per 256 x 256 slice at 64 filters and 5 x 5 kernels: levels of
    65,536, 16,384, 4,096, 1,024 and (the bottleneck) 256 pixels; each
    encoder and decoder block two 5 x 5 and one 1 x 1 convolution, the
    first block's first from 7 channels; the 1 x 1 classifier."""
    c = harness.resolve(harness.load_manifest(ROOT), "scan_fastsurfer", ROOT)
    k5, k1 = 2 * 64 * 64 * 25, 2 * 64 * 64
    first = 65536 * (2 * 7 * 64 * 25 + k5 + k1)
    blocks = first + 65536 * (2 * k5 + k1)
    for hw in (16384, 4096, 1024):
        blocks += 2 * hw * (2 * k5 + k1)
    blocks += 256 * (2 * k5 + k1)
    axial = blocks + 2 * 65536 * 64 * 79
    sagittal = blocks + 2 * 65536 * 64 * 51
    assert axial == 61_545_119_744 and sagittal == 61_310_238_720
    assert c.flops.slice_flops(c.config, 79) == axial
    assert c.flops.scan_flops(c.config) == 256 * (2 * axial + sagittal) \
        == 47_206_522_421_248


def test_the_configuration_states_the_program_tables():
    """The tables the configuration assumes are the ones the program
    defaults to; the cell passes the configuration's."""
    from subcort_tpu_torch.engine import views
    with open(ROOT / "benchmark/configs/fastsurfer_cnn.json") as fh:
        cfg = json.load(fh)
    assert tuple(cfg["sagittal_to_full"]) == views.SAGITTAL_TO_FULL
    assert tuple(cfg["structure_of"]) == views.STRUCTURE_OF
    assert tuple(cfg["full_labels"]) == views.FULL_LABELS
    assert cfg["reduced"] == [] and cfg["num_filters"] == 64
