"""On-device B-spline FFD registration (port of
subcort_tpu/registration/jax_ffd.py): the differentiable second backend to
``tools/reg_f3d``.

Same transform model and file contract as the C++ tool (geometry.hpp
SUBCORT_CPP): a uniform cubic B-spline control grid over the reference
carrying TOTAL world displacement (affine baked in), optimized by Adam on

    D(ref, flo ∘ T)  +  be * ||Δ(d - d_affine)||²

over a 2-level image pyramid, where D is either SSD (``cost="ssd"``,
default, the twin of the C++ tool's) or negated normalized mutual
information (``cost="nmi"``). The reference's reg_f3d is NiftyReg's
NMI-driven FFD (cnn_cort/base.py:516-521); NMI is insensitive to
monotone/nonlinear intensity remaps between template and subject where SSD
is not. NMI here is a Parzen-window (cubic B-spline kernel) soft joint
histogram, accumulated as chunked (C,B)ᵀ@(C,B) matmuls so memory stays
bounded for full-size scans.

Everything is tensor code under autograd: the dense displacement is a
separable B-spline tensor evaluation of the control grid, the warp is a
differentiable trilinear gather (the gradient flows through the
coordinates; the floating image carries none), and the bending-energy
surrogate is a second-difference Laplacian on the control values relative
to their affine initialization (so pure affine motion is unpenalized),
mirroring the C++ implementation for cross-backend comparability.

Where the JAX package compiles a level into one ``lax.scan`` program, the
port captures one iteration of the level in a CUDA graph and replays it
(torch_backend.run_level; a plain loop on the CPU): what does not change
over a level (the B-spline matrices, the reference's Parzen weights and
with them the NMI's chunk split, the world grid) is built once per level,
Adam's state and step count live on the device, and the per-iteration
losses are written into a device vector that the caller reads once.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from subcort_tpu_torch.config import exact_float32, resolve_device
from subcort_tpu_torch.io import NiftiImage, save_nii
from subcort_tpu_torch.registration.torch_backend import (
    CppGrid, _apply_affine, _f32, _ref_world_coords, _to_numpy, _trilinear,
    adam_level, bspline_axis_matrices, bspline_dense_disp,
    contract_dense_disp, downsample2, run_level, spacing3)

NMI_CHUNK = 1 << 17


def _grid_counts(shape, spacing) -> Tuple[int, int, int]:
    """Control counts matching native geometry.hpp::make_grid (per-axis)."""
    sp = spacing3(spacing)
    return tuple(int(np.ceil((s - 1) / sp[i])) + 4
                 for i, s in enumerate(shape))


def _bending(d: torch.Tensor) -> torch.Tensor:
    """Sum of squared 6-neighbor Laplacians over interior control points."""
    lap = (d[:-2, 1:-1, 1:-1] + d[2:, 1:-1, 1:-1] +
           d[1:-1, :-2, 1:-1] + d[1:-1, 2:, 1:-1] +
           d[1:-1, 1:-1, :-2] + d[1:-1, 1:-1, 2:] -
           6.0 * d[1:-1, 1:-1, 1:-1])
    return torch.sum(lap * lap)


def _jac_det_rel(dd: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Relative Jacobian determinant of T(x) = A@x + dd(x) on the interior
    voxel grid. dd: (X,Y,Z,3) world displacement; A: (3,3) vox->world.
    Returns (X-2,Y-2,Z-2) det(∂T/∂x)/det(A): 1 = volume-preserving,
    <= 0 = folded (non-invertible) deformation."""
    cols = []
    for ax in range(3):
        sl_p = [slice(1, -1)] * 3
        sl_m = [slice(1, -1)] * 3
        sl_p[ax] = slice(2, None)
        sl_m[ax] = slice(0, -2)
        g = 0.5 * (dd[tuple(sl_p)] - dd[tuple(sl_m)])  # central differences
        cols.append(g + A[:, ax])
    det = torch.sum(cols[0] * torch.linalg.cross(cols[1], cols[2], dim=-1),
                    dim=-1)
    det_a = torch.sum(A[:, 0] * torch.linalg.cross(A[:, 1], A[:, 2], dim=-1))
    return det / det_a


def jacobian_stats(grid: CppGrid, shape, device=None) -> dict:
    """Fold diagnostics for a fitted FFD (NiftyReg's reg_f3d penalizes
    negative Jacobians; base.py:516-521): evaluates the dense deformation
    over the reference ``shape`` and reports min det(J)/det(A) and the
    folded-voxel fraction. min_jac <= 0 means the warp is non-invertible
    somewhere and warped priors there are unreliable."""
    device = resolve_device(device)
    with torch.no_grad(), exact_float32():
        dd = bspline_dense_disp(_f32(grid.disp, device),
                                spacing3(grid.spacing), shape)
        A = _f32(np.asarray(grid.ref_affine)[:3, :3], device)
        det = _jac_det_rel(dd, A)
        return {"min_jac": float(det.min()),
                "neg_fraction": float((det <= 0.0).float().mean())}


def _soft_hist_weights(x01: torch.Tensor, nbins: int) -> torch.Tensor:
    """(C,) intensities in [0,1] -> (C, nbins) cubic B-spline Parzen weights.

    Each row sums to 1 (cardinal B-spline partition of unity), so the
    histogram total is exactly the voxel count and stays constant under
    optimization. The cubic window (NiftyReg's choice) keeps the NMI
    gradient continuous; a linear hat kernel makes the cost landscape
    kinky enough that descent stalls."""
    t = x01 * (nbins - 3) + 1.0  # 4-bin support stays inside [0, nbins-1]
    centers = torch.arange(nbins, dtype=torch.float32, device=x01.device)
    d = torch.abs(t[:, None] - centers[None, :])
    near = 2.0 / 3.0 - d * d + 0.5 * d * d * d
    far = (2.0 - d) ** 3 / 6.0
    return torch.where(d <= 1.0, near,
                       torch.where(d < 2.0, far, torch.zeros_like(d)))


def _ref_hist_weights(ref01: torch.Tensor, nbins: int,
                      chunk: int = NMI_CHUNK) -> tuple:
    """Per-chunk (<= chunk, nbins) Parzen weights of the reference image.
    They carry no gradient and do not change over an optimiser level: a
    level computes them once."""
    return tuple(_soft_hist_weights(rc, nbins)
                 for rc in torch.split(ref01.reshape(-1), chunk))


def _nmi(ref01: torch.Tensor, warped01: torch.Tensor, nbins: int,
         chunk: int = NMI_CHUNK, ref_weights: Optional[tuple] = None
         ) -> torch.Tensor:
    """Normalized mutual information (Studholme) of two [0,1] volumes.

    Joint histogram via chunked Wᵣᵀ@W𝓌 matmuls, accumulated in chunk
    order; differentiable through the warped-image weights. The last chunk
    is short where the JAX package pads it with zero-weight rows, which
    add exact zeros to the histogram. ``ref_weights`` is
    :func:`_ref_hist_weights` of ``ref01`` where the caller has hoisted
    it."""
    n = ref01.numel()
    if ref_weights is None:
        ref_weights = _ref_hist_weights(ref01, nbins, chunk)
    H = torch.zeros((nbins, nbins), dtype=torch.float32, device=ref01.device)
    for wr, wc in zip(ref_weights, torch.split(warped01.reshape(-1), chunk)):
        H = H + wr.T @ _soft_hist_weights(wc, nbins)
    P = H / n
    eps = 1e-12
    pr = P.sum(1)
    pw = P.sum(0)
    hr = -torch.sum(pr * torch.log(pr + eps))
    hw = -torch.sum(pw * torch.log(pw + eps))
    hrw = -torch.sum(P * torch.log(P + eps))
    return (hr + hw) / torch.clamp(hrw, min=eps)


def nmi_normalisation(ref: torch.Tensor, flo: torch.Tensor):
    """Fixed normalization ranges of the NMI cost: the reference's own, and
    the floating image's extended to 0 (out-of-volume samples are 0),
    matching native/src/reg_f3d.cpp. Returns (ref01, flo_lo, fscale)."""
    rlo, rhi = ref.min(), ref.max()
    ref01 = torch.clamp((ref - rlo) / torch.clamp(rhi - rlo, min=1e-8),
                        0.0, 1.0)
    flo_lo = torch.clamp(flo.min(), max=0.0)
    flo_hi = torch.clamp(flo.max(), min=0.0)
    fscale = 1.0 / torch.clamp(flo_hi - flo_lo, min=1e-8)
    return ref01, flo_lo, fscale


def _level_loss(d_affine, ref, flo, ref_affine, flo_inv, spacing, be,
                cost="ssd", nbins=32, jw=0.0, vox_offset=0.0):
    """The loss of one FFD level as a function of the control values. All
    that does not depend on them is computed here, once."""
    shape = tuple(ref.shape)
    ref_world = _ref_world_coords(shape, ref_affine, ref.device)
    matrices = bspline_axis_matrices(shape, spacing, d_affine.shape[:3],
                                     vox_offset, ref.device)
    if cost == "nmi":
        ref01, flo_lo, fscale = nmi_normalisation(ref, flo)
        ref_weights = _ref_hist_weights(ref01, nbins)
    # the hinge's weight is made commensurate with the data term: SSD scales
    # with intensity² while the hinge is O(1)
    jw_eff = jw * (torch.mean(ref * ref) if cost == "ssd" else 1.0) \
        if jw > 0.0 else 0.0

    def loss_fn(d):
        dd = contract_dense_disp(d, matrices)
        fv = _apply_affine(flo_inv, ref_world + dd)
        warped = _trilinear(flo, fv)
        if cost == "nmi":
            w01 = torch.clamp((warped - flo_lo) * fscale, 0.0, 1.0)
            data = 2.0 - _nmi(ref01, w01, nbins,  # NMI in [1,2]; minimize
                              ref_weights=ref_weights)
        else:
            data = torch.mean((warped - ref) ** 2)
        loss = data + be * _bending(d - d_affine) / d.numel()
        if jw > 0.0:
            # folding penalty (NiftyReg reg_f3d analogue): push the relative
            # Jacobian determinant above a 0.5 margin everywhere (dd is
            # already materialized, so this costs a few elementwise volumes)
            detrel = _jac_det_rel(dd, ref_affine[:3, :3])
            loss = loss + jw_eff * torch.mean(
                torch.relu(0.5 - detrel) ** 2)
        return loss

    return loss_fn


def _optimize_level(disp, d_affine, ref, flo, ref_affine, flo_inv,
                    spacing: Tuple[float, float, float], iters: int,
                    be: float, lr: float, cost: str = "ssd", nbins: int = 32,
                    jw: float = 0.0, vox_offset: float = 0.0,
                    _eager: bool = False):
    """One pyramid level of Adam descent on the control values; tensors on
    one device. On the card the level is one captured iteration replayed
    (torch_backend.run_level; ``_eager`` runs it as a plain loop, for the
    comparisons). Returns (control values, per-iteration losses), the
    losses a device tensor read by the caller once."""
    loss_fn = _level_loss(d_affine, ref, flo, ref_affine, flo_inv, spacing,
                          be, cost, nbins, jw, vox_offset)
    # decay within the level: constant-lr Adam can oscillate/diverge once
    # near the optimum on long runs
    step, d, losses = adam_level(loss_fn, disp, iters, lr)
    run_level(step, iters, ref.device, eager=_eager, stage="ffd", cost=cost,
              shape=list(ref.shape), controls=list(disp.shape[:3]))
    return d, losses


def register_ffd_torch(ref: np.ndarray, flo: np.ndarray,
                       ref_affine: Optional[np.ndarray] = None,
                       flo_affine: Optional[np.ndarray] = None,
                       init_affine: Optional[np.ndarray] = None,
                       spacing_mm: float = 10.0,
                       iters: Tuple[int, int] = (60, 15),
                       be: Optional[float] = None, lr_mm: float = 0.4,
                       cost: str = "ssd", nbins: int = 32,
                       fold_penalty: float = 1.0, warn_folds: bool = True,
                       device=None, _eager: bool = False):
    """Register flo onto ref; returns (CppGrid, per-level loss arrays), the
    grid's displacements a numpy array.

    ``cost`` is "ssd" (default) or "nmi" (intensity-remap-robust, like the
    reference's NiftyReg reg_f3d). ``be`` defaults per cost: the NMI data
    term lives in [0,1] while SSD scales with intensity², so they need
    different bending weights (0.05 for SSD, 5e-4 for NMI).

    ``fold_penalty`` > 0 adds a Jacobian-determinant hinge penalty
    (NiftyReg's reg_f3d penalizes non-diffeomorphic warps) pushing
    det(J)/det(A) toward a 0.5 margin everywhere; the weight is internally
    scaled to the data term (see _level_loss) so the default 1.0 works at
    any intensity scale. ``fold_penalty=0.0`` restores the unpenalized fit;
    with ``warn_folds`` (default) a fitted transform that still folds emits
    a RuntimeWarning (diagnose with ``jacobian_stats``).

    The returned grid uses the native SUBCORT_CPP contract and can be
    consumed by ``tools/reg_resample`` or :func:`resample_through_cpp`.
    """
    if cost not in ("ssd", "nmi"):
        raise ValueError(f"cost must be 'ssd' or 'nmi', got {cost!r}")
    device = resolve_device(device)
    if be is None:
        be = 0.05 if cost == "ssd" else 5e-4
    ref_affine = np.eye(4) if ref_affine is None else np.asarray(ref_affine, np.float64)
    flo_affine = np.eye(4) if flo_affine is None else np.asarray(flo_affine, np.float64)
    A = np.eye(4) if init_affine is None else np.asarray(init_affine, np.float64)

    # per-axis control spacing: -sx is millimetres per axis (NiftyReg
    # semantics), so anisotropic voxels get anisotropic voxel-unit spacing
    # (a 1x1x3 mm scan must NOT get a 3x denser grid along z)
    spacing = tuple(
        max(2.0, spacing_mm / (float(np.linalg.norm(ref_affine[:3, j])) or 1.0))
        for j in range(3))
    ncx, ncy, ncz = _grid_counts(ref.shape, spacing)

    # affine baked into the initial control values: d(c) = A*w(c) - w(c)
    ii, jj, kk = np.meshgrid(np.arange(ncx), np.arange(ncy), np.arange(ncz),
                             indexing="ij")
    cp_vox = np.stack([(ii - 1) * spacing[0], (jj - 1) * spacing[1],
                       (kk - 1) * spacing[2], np.ones_like(ii, np.float64)], -1)
    w = np.einsum("ij,...j->...i", ref_affine[:3, :], cp_vox)
    aw = np.einsum("ij,...j->...i", A[:3, :],
                   np.concatenate([w, np.ones(w.shape[:-1] + (1,))], -1))
    d_affine = (aw - w).astype(np.float32)

    with exact_float32():
        d_aff = _f32(d_affine, device)
        ref_t = _f32(np.asarray(ref, np.float32), device)
        flo_t = _f32(np.asarray(flo, np.float32), device)

        # coarse level: half-res images; same world grid => spacing halves
        # in level-voxel units and the level affine doubles its columns
        ref_c, ref_affine_c = downsample2(ref_t, ref_affine)
        flo_c, flo_affine_c = downsample2(flo_t, flo_affine)

        losses = []
        # vox_offset 0.25: coarse voxel v sits at fine voxel 2v+0.5
        # (downsample2 centroid convention), so the coarse lattice is
        # evaluated at u=(v+0.25)/(sp/2): the SAME fine-frame control
        # positions the fine level, the baked d_affine anchors, and
        # save_cpp interpret the values at (reg_f3d.cpp applies the
        # identical offset).
        disp, l0 = _optimize_level(
            d_aff, d_aff, ref_c, flo_c, _f32(ref_affine_c, device),
            _f32(np.linalg.inv(flo_affine_c), device),
            tuple(s / 2.0 for s in spacing), int(iters[0]), be, lr_mm,
            cost=cost, nbins=nbins, jw=float(fold_penalty), vox_offset=0.25,
            _eager=_eager)
        losses.append(_to_numpy(l0))
        del ref_c, flo_c
        # the fine level refines an almost-converged state: halve the step
        # so fresh Adam moment estimates don't overshoot it
        disp, l1 = _optimize_level(
            disp, d_aff, ref_t, flo_t, _f32(ref_affine, device),
            _f32(np.linalg.inv(flo_affine), device),
            spacing, int(iters[1]), be, lr_mm / 2.0, cost=cost, nbins=nbins,
            jw=float(fold_penalty), _eager=_eager)
        losses.append(_to_numpy(l1))

    grid = CppGrid(disp=_to_numpy(disp), spacing=spacing,
                   ref_affine=np.asarray(ref_affine))
    if warn_folds:
        stats = jacobian_stats(grid, ref.shape, device)
        if stats["min_jac"] <= 0.0:
            warnings.warn(
                f"FFD transform folds: min det(J)/det(A) = "
                f"{stats['min_jac']:.4f} over {stats['neg_fraction']:.2%} of "
                "voxels; warped priors there are unreliable; consider "
                "fold_penalty > 0 or a larger bending weight", RuntimeWarning)
    return grid, losses


def save_cpp_grid(grid: CppGrid, path: str) -> None:
    """Write a SUBCORT_CPP transform.nii consumable by tools/reg_resample
    and both packages' resamplers (same sform contract as
    geometry.hpp::save_cpp): grid column j = ref column j * spacing_j
    (per-axis), translation shifted by one control spacing per axis (the
    phantom point before the edge)."""
    sp = spacing3(grid.spacing)
    disp = np.asarray(grid.disp, np.float32)[:, :, :, None, :]
    ra = np.asarray(grid.ref_affine, np.float64)
    affine = ra.copy()
    for j in range(3):
        affine[:3, j] = ra[:3, j] * sp[j]
    affine[:3, 3] = ra[:3, 3] - sum(sp[j] * ra[:3, j] for j in range(3))
    save_nii(NiftiImage(disp, affine), path)
