"""On-device 12-dof affine registration (port of
subcort_tpu/registration/jax_affine.py): the stage-1 twin of
``tools/reg_aladin``.

Reference counterpart: the NiftyReg ``reg_aladin`` call at
cnn_cort/base.py:510-513 (block-matching affine of the MNI template onto
the subject T1). The C++ tool rebuilds that algorithm (block matching +
LTS); this module instead descends the registration cost *through the
differentiable trilinear resampler* (torch_backend._trilinear), exactly like
the FFD stage, so ``backend="torch"`` is self-contained end to end and a
deployment without the native toolchain can still register.

Transform contract matches geometry.hpp / transf.txt:

    flo_world = A @ ref_world     (pull semantics, 4x4 row-major text file)

Parameterization: translation (mm), rotation (axis-angle via small Euler
angles), log-scale, and shear: 12 dof, composed around the reference
intensity centroid so rotation/scale don't drag translation. Initialized
from image moments (centroid shift + per-axis second-moment scale), then
optimized coarse-to-fine over a 3-level pyramid with Adam on
scale-normalized parameters, SSD or Parzen-window NMI data term (the same
costs as the FFD stage).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from subcort_tpu_torch.config import exact_float32, resolve_device
from subcort_tpu_torch.registration.torch_backend import (
    _apply_affine, _f32, _ref_world_coords, _to_numpy, _trilinear,
    adam_level, downsample2, run_level)
from subcort_tpu_torch.registration.torch_ffd import (_nmi,
                                                      _ref_hist_weights,
                                                      nmi_normalisation)

# per-parameter natural scales: Adam applies one lr to every coordinate, so
# parameters are optimized in normalized units and scaled here: 10 mm of
# translation is "1.0" like 0.1 rad of rotation is
_PSCALE = np.array([10.0, 10.0, 10.0,      # translation (mm)
                    0.1, 0.1, 0.1,         # rotation (rad)
                    0.1, 0.1, 0.1,         # log-scale
                    0.1, 0.1, 0.1], np.float32)  # shear


def _affine_from_params(pn: torch.Tensor, center: torch.Tensor,
                        pscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized params (12,) -> (4,4) world affine (flo = A @ ref).
    ``pscale`` is :data:`_PSCALE` on the device, where an optimiser level
    has hoisted it out of its iteration."""
    if pscale is None:
        pscale = _f32(_PSCALE, pn.device)
    p = pn * pscale
    t, r, ls, h = p[0:3], p[3:6], p[6:9], p[9:12]
    c, s = torch.cos(r), torch.sin(r)
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])

    def mat(rows):
        return torch.stack([torch.stack(row) for row in rows])

    Rx = mat([[one, zero, zero], [zero, c[0], -s[0]], [zero, s[0], c[0]]])
    Ry = mat([[c[1], zero, s[1]], [zero, one, zero], [-s[1], zero, c[1]]])
    Rz = mat([[c[2], -s[2], zero], [s[2], c[2], zero], [zero, zero, one]])
    Sh = mat([[one, h[0], h[1]], [zero, one, h[2]], [zero, zero, one]])
    M = Rz @ Ry @ Rx @ Sh @ torch.diag(torch.exp(ls))
    # compose about the centroid: flo = M @ (ref - c) + c + t
    top = torch.cat([M, (center - M @ center + t)[:, None]], dim=1)
    bottom = torch.stack([zero, zero, zero, one])[None, :]
    return torch.cat([top, bottom], dim=0)


def _level_loss(center, ref, flo, ref_affine, flo_inv, cost="ssd", nbins=32):
    """The loss of one affine level as a function of the normalized
    parameters; what does not depend on them is computed here, once."""
    ref_world = _ref_world_coords(tuple(ref.shape), ref_affine, ref.device)
    pscale = _f32(_PSCALE, ref.device)
    if cost == "nmi":
        ref01, flo_lo, fscale = nmi_normalisation(ref, flo)
        ref_weights = _ref_hist_weights(ref01, nbins)
    else:
        ones = torch.ones_like(flo)

    def loss_fn(q):
        A = _affine_from_params(q, center, pscale)
        fw = torch.einsum("ij,xyzj->xyzi", A[:3, :3], ref_world) + A[:3, 3]
        fv = _apply_affine(flo_inv, fw)
        warped = _trilinear(flo, fv)
        if cost == "nmi":
            w01 = torch.clamp((warped - flo_lo) * fscale, 0.0, 1.0)
            return 2.0 - _nmi(ref01, w01, nbins, ref_weights=ref_weights)
        # overlap weight: fraction of each pulled sample inside the floating
        # FOV (ones pulled through the same coords). Without it, reference
        # voxels whose samples fall outside score (0 - ref)^2 and the
        # optimizer shrinks scale to drag more of the floating image inside:
        # the classic SSD FOV bias (NiftyReg masks for the same reason).
        # No gradient: the weight selects the domain, it is not a free
        # variable to optimize (else shrinking overlap lowers the loss).
        with torch.no_grad():
            inb = _trilinear(ones, fv.detach())
        num = torch.sum(inb * (warped - ref) ** 2)
        return num / torch.clamp(torch.sum(inb), min=1.0)

    return loss_fn


def _optimize_level(pn, center, ref, flo, ref_affine, flo_inv,
                    iters: int, lr: float, cost: str = "ssd",
                    nbins: int = 32, dof: int = 12, _eager: bool = False):
    """One pyramid level of Adam descent; tensors on one device. ``dof``=6
    freezes scale/shear (rigid phase: the same rigid-then-affine schedule as
    block-matching aladin, which keeps the full fit from sliding into a
    shear+scale mixture that mimics rotation); 12 = full affine. On the
    card the level is one captured iteration replayed
    (torch_backend.run_level; ``_eager`` runs it as a plain loop, for the
    comparisons). Returns (parameters, per-iteration losses), both device
    tensors."""
    mask = _f32(np.concatenate(
        [np.ones(6), np.full(6, 1.0 if dof == 12 else 0.0)]), ref.device)
    loss_fn = _level_loss(center, ref, flo, ref_affine, flo_inv, cost, nbins)
    # masked parameters keep zero Adam moments
    step, q, losses = adam_level(loss_fn, pn, iters, lr, grad_mask=mask)
    run_level(step, iters, ref.device, eager=_eager, stage="affine",
              cost=cost, dof=dof, shape=list(ref.shape))
    return q, losses


def _moments(vol: np.ndarray, affine: np.ndarray):
    """Intensity-weighted world centroid + per-world-axis std-dev.

    Works entirely from 1-D/2-D marginals of the weight volume: with
    world coords p = M v + t, the world covariance is M Cov(v) M^T, and
    Cov(v) needs only E[v_i] and E[v_i v_j], three 1-D and three 2-D
    marginal sums. No full-volume coordinate meshgrids (an MNI-sized
    float64 meshgrid trio is ~170 MB of transients, built twice per
    registration)."""
    w = np.asarray(vol, np.float64)
    w = np.clip(w - w.min(), 0.0, None)
    total = w.sum() or 1.0
    idx = [np.arange(s, dtype=np.float64) for s in vol.shape]
    marg1 = [w.sum(axis=tuple(a for a in range(3) if a != i))
             for i in range(3)]
    mv = np.array([(marg1[i] * idx[i]).sum() / total for i in range(3)])
    centroid = affine[:3, :3] @ mv + affine[:3, 3]
    E2 = np.zeros((3, 3))
    for i in range(3):
        E2[i, i] = (marg1[i] * idx[i] ** 2).sum() / total
        for j in range(i + 1, 3):
            m2 = w.sum(axis=3 - i - j)  # axes (i, j) remain, in order
            E2[i, j] = E2[j, i] = (idx[i][:, None] * m2
                                   * idx[j][None, :]).sum() / total
    cov = E2 - np.outer(mv, mv)
    var = np.diag(affine[:3, :3] @ cov @ affine[:3, :3].T)
    return centroid, np.sqrt(np.maximum(var, 1e-8))


def register_affine_torch(ref: np.ndarray, flo: np.ndarray,
                          ref_affine: Optional[np.ndarray] = None,
                          flo_affine: Optional[np.ndarray] = None,
                          cost: str = "ssd", nbins: int = 32,
                          iters: Tuple[int, int, int] = (150, 60, 15),
                          lr: float = 0.05, device=None,
                          _eager: bool = False) -> np.ndarray:
    """Fit flo_world = A @ ref_world by multi-resolution gradient descent.

    Returns the (4,4) world affine in the transf.txt contract (float64),
    drop-in for the ``tools/reg_aladin -aff`` output consumed by both FFD
    backends and ``resample_through_affine``.
    """
    if cost not in ("ssd", "nmi"):
        raise ValueError(f"cost must be 'ssd' or 'nmi', got {cost!r}")
    device = resolve_device(device)
    ref_affine = np.eye(4) if ref_affine is None else np.asarray(ref_affine, np.float64)
    flo_affine = np.eye(4) if flo_affine is None else np.asarray(flo_affine, np.float64)
    ref = np.asarray(ref, np.float32)
    flo = np.asarray(flo, np.float32)

    # moments initialization: centroid shift + per-axis scale
    c_r, s_r = _moments(ref, ref_affine)
    c_f, s_f = _moments(flo, flo_affine)
    pn = np.zeros(12, np.float32)
    pn[0:3] = (c_f - c_r) / _PSCALE[0:3]
    pn[6:9] = np.log(np.clip(s_f / s_r, 0.5, 2.0)) / _PSCALE[6:9]

    # pyramid: /4, /2, /1 (same world frame at every level)
    levels = [(ref, ref_affine, flo, flo_affine)]
    for _ in range(2):
        r, ra = downsample2(*levels[0][:2])
        f, fa = downsample2(*levels[0][2:])
        levels.insert(0, (r, ra, f, fa))

    with exact_float32():
        center = _f32(c_r, device)
        pn_t = _f32(pn, device)
        # rigid phase at the coarsest level first (aladin's rigid-then-affine
        # schedule), then full 12-dof coarse-to-fine
        schedule = [(levels[0], iters[0], lr, 6)] + [
            (lv, it, level_lr, 12)
            for lv, it, level_lr in zip(levels, iters,
                                        (lr, lr / 2.0, lr / 4.0))]
        for (r, ra, f, fa), it, level_lr, dof in schedule:
            pn_t, _ = _optimize_level(
                pn_t, center, _f32(r, device), _f32(f, device),
                _f32(ra, device), _f32(np.linalg.inv(fa), device),
                int(it), float(level_lr), cost=cost, nbins=nbins, dof=dof,
                _eager=_eager)
        with torch.no_grad():
            A = _affine_from_params(pn_t, center)
    return np.asarray(_to_numpy(A), np.float64)
