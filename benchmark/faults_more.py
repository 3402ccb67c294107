"""Faults of the cells ``scan_fastsurfer`` and ``register_mni``, planted as
``faults.py``'s are (``fault(setattr)``).

    python3 benchmark/faults_more.py --workload <cell> --seeds ... \
        [--control ...] [--fault NAME --faulted ...]

is ``calibrate.py`` with these faults among its choices.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def sagittal_left_out(setattr_):
    """P aggregated over the axial and coronal views only."""
    from subcort_tpu_torch.engine import views
    setattr_(views, "VIEWS", tuple(v for v in views.VIEWS
                                   if v[0] != "sagittal"))


def maxout_conv_branch(setattr_):
    """Every block's maxout replaced by its convolution branch."""
    from subcort_tpu_torch.models import fastsurfer
    setattr_(fastsurfer, "_maxout", lambda conv_branch, other: conv_branch)


def thick_slices_shifted(setattr_):
    """Each thick slice taken one slice further along its view's axis."""
    from subcort_tpu_torch.engine import views
    real = views._thick_slices

    def shifted(padded, start, stop):
        last = padded.shape[0] - 2 * views.CONTEXT - 1
        if stop <= last:
            return real(padded, start + 1, stop + 1)
        return real(padded, start, stop)

    setattr_(views, "_thick_slices", shifted)


def ffd_skipped(setattr_):
    """The FFD stage returns its initial grid: the affine alone."""
    from subcort_tpu_torch.registration import driver, torch_ffd

    def affine_only(ref, flo, ref_affine=None, flo_affine=None,
                    init_affine=None, spacing_mm=10.0, **_):
        ref_affine = np.eye(4) if ref_affine is None else ref_affine
        a = np.eye(4) if init_affine is None else np.asarray(init_affine)
        sp = tuple(max(2.0, spacing_mm / float(np.linalg.norm(
            ref_affine[:3, j]))) for j in range(3))
        nc = torch_ffd._grid_counts(ref.shape, sp)
        ii, jj, kk = np.meshgrid(*[np.arange(n) for n in nc], indexing="ij")
        cp = np.stack([(ii - 1) * sp[0], (jj - 1) * sp[1], (kk - 1) * sp[2],
                       np.ones_like(ii, np.float64)], -1)
        w = np.einsum("ij,...j->...i", ref_affine[:3, :], cp)
        aw = w @ a[:3, :3].T + a[:3, 3]
        return torch_ffd.CppGrid((aw - w).astype(np.float32), sp,
                                 np.asarray(ref_affine)), []

    setattr_(driver, "register_ffd_torch", affine_only)


def priors_identity(setattr_):
    """The priors warped through the identity, not the fitted grid."""
    from subcort_tpu_torch.registration import driver
    real = driver.load_cpp_grid

    def identity(path, ref_affine):
        g = real(path, ref_affine)
        return g._replace(disp=np.zeros_like(g.disp))

    setattr_(driver, "load_cpp_grid", identity)


FAULTS = {f.__name__: f for f in (sagittal_left_out, maxout_conv_branch,
                                  thick_slices_shifted, ffd_skipped,
                                  priors_identity)}


if __name__ == "__main__":
    from benchmark import calibrate, faults
    faults.FAULTS.update(FAULTS)
    sys.exit(calibrate.main())
