"""The cell ``register_mni`` cut to the CPU: it comes out correct; the FFD
stage skipped (at half the MNI size, where the planted warp is more than
an affine absorbs), the priors warped through the identity and the TF32
control do not; the plain NIfTI reader, the planted transform's inverse
and the fold count on their own."""

import dataclasses
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import tiny  # noqa: F401  (puts the checkout on sys.path)
from tiny import ROOT

from benchmark import faults_more, harness
from benchmark.drivers import register_loop
from benchmark.reference import resample as ref

SEED = 2 ** 33 + 5
SMALL = [40, 44, 40]
HALF = [90, 108, 90]


def cell(shape) -> harness.Cell:
    c = harness.resolve(harness.load_manifest(ROOT), "register_mni", ROOT)
    return dataclasses.replace(c, traffic=dict(c.traffic, shape=shape))


def execute(shape) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        return harness.execute(cell(shape), "cpu", SEED, 0.1, False,
                               Path(tmp), time.perf_counter())


def test_the_cut_cell_is_correct_and_an_ffd_skipped_is_not(monkeypatch):
    out = execute(HALF)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and set(out["metrics"]) == {"scan_s",
                                                             "setup_s"}
    faults_more.ffd_skipped(monkeypatch.setattr)
    out = execute(HALF)
    assert not out["correct"], out["checks"]
    assert out["checks"]["planted_error_mm"]["value"] > \
        out["checks"]["planted_error_mm"]["limit"]


def test_priors_through_the_identity_are_not_correct(monkeypatch):
    faults_more.priors_identity(monkeypatch.setattr)
    out = execute(SMALL)
    assert not out["correct"], out["checks"]
    assert out["checks"]["prior_gap"]["value"] > 0.5


def test_the_control_fails(tmp_path):
    c = cell(SMALL)
    run = harness.Run(c, "cpu", SEED, 0.0, False, tmp_path)
    drv = register_loop.Driver(run)
    drv.setup()
    numbers = drv.control()
    ok, rows = harness.judge(numbers, {k: c.limits[k] for k in numbers})
    assert not ok, rows


def test_the_plain_reader_reads_what_the_program_writes(tmp_path):
    from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii
    rng = np.random.default_rng(3)
    affine = np.diag([1.0, 1.0, 1.0, 1.0])
    affine[:3, 3] = (-90.0, -126.0, -72.0)
    for name, data in (
            ("priors.nii.gz", rng.random((6, 7, 5, 15), np.float32)),
            ("grid.nii", rng.random((4, 5, 6, 1, 3), np.float32)),
            ("mask.nii.gz", rng.random((6, 7, 5)) > 0.5),
            ("t1.nii.gz", rng.integers(0, 900, (6, 7, 5), np.int16))):
        save_nii(NiftiImage(data, affine), str(tmp_path / name))
        got, got_affine = ref.read_nifti(str(tmp_path / name))
        want = load_nii(str(tmp_path / name))
        assert np.array_equal(got, want.data)
        assert np.allclose(got_affine, want.affine)


def test_the_planted_inverse_and_the_fold_count():
    tr = harness.resolve(harness.load_manifest(ROOT), "register_mni",
                         ROOT).traffic
    grid = register_loop.planted_grid(tr, SMALL, SEED, "cpu")
    pts = ref.voxel_grid(SMALL, 10, 30, "cpu").reshape(-1, 3)
    inv = ref.inverse(grid, pts)
    back = inv + ref.deformation(*grid, inv)
    assert float((back - pts).norm(dim=-1).max()) < 1e-3
    assert float((inv - pts).norm(dim=-1).mean()) > 1.0
    det = ref.jacobian_det(grid, SMALL, "cpu")
    assert det.shape == tuple(s - 2 for s in SMALL) and float(det.min()) > 0
    # a control point pushed past its neighbours folds the transform
    disp = grid[0].clone()
    disp[3, 3, 3, 0] += 40.0
    assert int((ref.jacobian_det((disp, grid[1]), SMALL, "cpu") <= 0)
               .sum()) > 0


@pytest.mark.parametrize("precision", ["float32", "tf32"])
def test_resample_through_the_identity_is_the_volume(precision):
    """A zero control grid pulls every voxel from itself; in TF32 the
    coordinates round, and above 1024 voxels a coordinate moves."""
    vol = torch.rand((12, 10, 8, 2), generator=torch.Generator()
                     .manual_seed(1))
    nc = register_loop.grid_counts(vol.shape[:3], 4.0)
    zero = (torch.zeros(nc + (3,)), (4.0, 4.0, 4.0))
    out = ref.resample(vol, np.eye(4), zero, vol.shape[:3], np.eye(4),
                       precision)
    assert torch.equal(out, vol)
