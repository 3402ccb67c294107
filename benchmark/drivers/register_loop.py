"""Closed-loop registrations of an MNI-sized subject onto a template that
was made from it by a planted transform.

Traffic parameters (``traffic/<name>.json``): the subject is one scan of
``frozen.make_scan`` (int16 T1, 15 prior channels, ROI; ``shape``) drawn
from the seed. The planted transform maps a template voxel x to the
subject voxel T(x): a 12-dof affine about the volume's centre
(``rotation_deg`` about z, ``scales``, ``shift`` voxels) and a smooth warp
of at most ``warp_mm`` on a ``grid_mm`` control grid (Gaussian-smoothed
normal draws), both baked into one B-spline control grid as the program's
FFD stores it. The template is the subject pulled through T by the plain
resampler (``reference/resample.py``), its intensities remapped to
``max (t / max) ^ remap_power``; the template's atlas is the subject's
priors pulled through T. (``chip_smoke.py`` phase 12(c)'s inputs.) Both
are written as NIfTI in an atlas directory, the subject as ``T1.nii.gz``.

The window calls ``register_masks(subject, backend="torch",
similarity=...)`` back to back at its default iterations, the subject's
``tmp/`` cleared before each, for ``--seconds``, and stops after the call
that crosses it: ``scan_s`` is the window over the registrations.

The check, after the window, on the last call's ``tmp/`` files, read by
the plain NIfTI reader: ``planted_error_mm``, the mean distance over the
ROI between the program's transform (``transform.nii``) and the inverse of
T; ``prior_gap``, the largest difference between the program's warped
priors and the plain resampler's through the program's own control grid;
``mask_mismatch``, voxels where the program's ROI mask differs from its
priors' channels 0-12 summed, thresholded at 0 and dilated 5 times (the
reference's rule, ``bugcompat_mask_channels``); ``folded_voxels``, voxels
where the program's transform has det(J) <= 0.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch
from scipy import ndimage

from benchmark import frozen
from benchmark.reference import resample as ref

EYE = np.eye(4)
DILATE = 5
MASK_CHANNELS = 13
FILES = ("transf.txt", "transform.nii", "MNI_sub_probabilities.nii.gz",
         "MNI_subcortical_mask.nii.gz")


def grid_counts(shape, spacing: float):
    """Control counts of a grid of ``spacing`` voxels over ``shape`` (the
    SUBCORT_CPP lattice: ceil((s - 1) / spacing) + 4 a side)."""
    return tuple(int(np.ceil((s - 1) / spacing)) + 4 for s in shape)


def planted_grid(tr: dict, shape, seed: int, device):
    """(disp, spacing) of the planted transform T for ``seed``."""
    rz = np.deg2rad(float(tr["rotation_deg"]))
    c, s = np.cos(rz), np.sin(rz)
    m = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]) @ np.diag(
        tr["scales"])
    center = (np.asarray(shape) - 1) / 2.0
    shift = center - m @ center + np.asarray(tr["shift"], np.float64)
    sp = float(tr["grid_mm"])
    nc = grid_counts(shape, sp)
    rng = np.random.default_rng([seed, 1])
    smooth = ndimage.gaussian_filter(rng.standard_normal(nc + (3,)),
                                     (2, 2, 2, 0))
    smooth = smooth * float(tr["warp_mm"]) / np.abs(smooth).max()
    ii, jj, kk = np.meshgrid(*[np.arange(n) for n in nc], indexing="ij")
    cp = np.stack([(ii - 1) * sp, (jj - 1) * sp, (kk - 1) * sp], -1)
    disp = cp @ m.T + shift - cp + smooth
    return (torch.from_numpy(disp.astype(np.float32)).to(device),
            (sp, sp, sp))


class Driver:
    def __init__(self, run):
        self.run = run
        self.tr = run.cell.traffic

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from subcort_tpu_torch.io import NiftiImage, save_nii
        from subcort_tpu_torch.registration import driver as reg

        run, tr = self.run, self.tr
        self.reg = reg
        dev = run.device
        t0 = time.perf_counter()
        shape = tuple(tr.get("shape", frozen.MNI_SHAPE))
        image, atlas, roi = frozen.make_scan(
            np.random.default_rng([run.seed, 0]), shape)
        self.shape, self.roi = shape, roi
        self.planted = planted_grid(tr, shape, run.seed, dev)
        t1 = torch.from_numpy(image.astype(np.float32)).to(dev)
        template = ref.resample(t1, EYE, self.planted, shape, EYE)
        tmax = float(template.max())
        template = tmax * (template / tmax) ** float(tr["remap_power"])
        self.template_atlas = ref.resample(torch.from_numpy(atlas).to(dev),
                                           EYE, self.planted, shape, EYE)
        self.atlas_dir = os.path.join(run.workdir, "atlas")
        os.makedirs(self.atlas_dir)
        save_nii(NiftiImage(template.cpu().numpy()),
                 os.path.join(self.atlas_dir, reg.TEMPLATE_NAME))
        save_nii(NiftiImage(self.template_atlas.cpu().numpy()),
                 os.path.join(self.atlas_dir, reg.ATLAS_NAME))
        subject = os.path.join(run.workdir, "scans", "s01")
        os.makedirs(subject)
        self.scan = os.path.join(subject, "T1.nii.gz")
        save_nii(NiftiImage(image), self.scan)
        self.tmp = os.path.join(subject, "tmp")
        del t1, template, atlas, image
        run.setup_parts["inputs"] = time.perf_counter() - t0

        # warm-up: one registration (cuBLAS, the levels' captures, the
        # allocator's pools)
        t0 = time.perf_counter()
        self._one()
        run.setup_parts["warmup"] = time.perf_counter() - t0

    def _one(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)
        with self.run.spans("register_masks"):
            self.reg.register_masks(self.scan, atlas_dir=self.atlas_dir,
                                    backend="torch",
                                    similarity=self.tr["similarity"],
                                    device=self.run.device)

    # ------------------------------------------------------------ window
    def window(self) -> None:
        run = self.run
        run.spans.seconds.clear()
        run.trace.start()
        t0 = time.perf_counter()
        i = 0
        while True:
            self._one()
            i += 1
            tb = time.perf_counter()
            if tb - t0 >= run.seconds:
                break
        run.trace.stop()
        run.counts.update(attempted=i, failed=0)
        run.end_to_end["scan_s"] = (tb - t0) / i

    def release(self) -> None:
        pass

    # ------------------------------------------------------------ check
    def outputs(self) -> dict:
        """The last call's files, read by the plain reader."""
        missing = [f for f in FILES
                   if not os.path.exists(os.path.join(self.tmp, f))]
        if missing:
            raise RuntimeError(f"the registration wrote no {missing}")
        path = lambda f: os.path.join(self.tmp, f)  # noqa: E731
        return {"grid": ref.read_grid(path("transform.nii"), EYE,
                                      self.run.device),
                "priors": ref.read_nifti(path(FILES[2]))[0],
                "mask": ref.read_nifti(path(FILES[3]))[0]}

    def reference_priors(self, grid, precision: str = "float32"):
        return ref.resample(self.template_atlas, EYE, grid, self.shape, EYE,
                            precision)

    def check(self) -> dict:
        return judge(self, self.outputs())

    def readings(self) -> dict:
        """The check's numbers after one more registration, no window."""
        self._one()
        return self.check()

    def control(self) -> dict:
        """The control's numbers: the plain resampler with TF32-rounded
        coordinate products put in the program's place, through the grid
        of the set-up's registration."""
        out = self.outputs()
        want = self.reference_priors(out["grid"])
        low = self.reference_priors(out["grid"], "tf32")
        return {"prior_gap": float((low - want).abs().max())}


def judge(drv, out: dict) -> dict:
    """The numbers the check compares over one registration's outputs."""
    dev = drv.run.device
    grid = out["grid"]
    pts = torch.from_numpy(np.argwhere(drv.roi).astype(np.float32)).to(dev)
    program = ref.mapped(grid, pts, EYE, EYE)
    planted = ref.inverse(drv.planted, pts)
    error = float((program - planted).norm(dim=-1).mean())
    want = drv.reference_priors(grid)
    priors = torch.from_numpy(out["priors"]).to(dev)
    gap = float((priors - want).abs().max())
    rule = ndimage.binary_dilation(
        out["priors"][..., :MASK_CHANNELS].sum(-1) > 0, iterations=DILATE)
    mismatch = int(np.count_nonzero(rule != (out["mask"] != 0)))
    folded = int((ref.jacobian_det(grid, drv.shape, dev) <= 0).sum())
    return {"planted_error_mm": error, "prior_gap": gap,
            "mask_mismatch": float(mismatch),
            "folded_voxels": float(folded)}
