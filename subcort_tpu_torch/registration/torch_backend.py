"""Device-side resampling backend (port of
subcort_tpu/registration/jax_backend.py).

A PyTorch twin of ``tools/reg_resample``: trilinear pull-resampling through
either a world affine or a SUBCORT_CPP B-spline control grid (see
native/src/geometry.hpp for the transform contracts). It warps the 15 prior
channels on the device in one pass, and is the differentiable resampler of
the on-device affine and FFD registration (torch_affine.py, torch_ffd.py),
whose optimiser levels it also runs (:func:`adam_level`, :func:`run_level`:
one level one device program, a CUDA graph of one iteration replayed).

Everything here is plain tensor code (``torch.einsum``, indexing): the JAX
package wrote no Pallas kernel for it either. The coordinates feed the
``transform.nii`` cross-runtime contract, so every public function runs its
device work with TF32 off (:func:`~subcort_tpu_torch.config.exact_float32`,
the counterpart of the JAX package's ``Precision.HIGHEST``).

Every public function takes a ``device``; ``None`` means
``select_device(Options())``, which raises without a card. CPU callers pass
``"cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from subcort_tpu_torch.config import exact_float32, resolve_device
from subcort_tpu_torch.io import load_nii
from subcort_tpu_torch.utils.graphs import WARMUP, GraphedStep, timed
from subcort_tpu_torch.utils.runtime import span

# optax.adam's defaults, the JAX package's optimiser
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# eager iterations of a level before one is captured (utils/graphs.py)
WARMUP_ITERS = WARMUP


class CppGrid(NamedTuple):
    """Control-point displacement grid (matches geometry.hpp::CppGrid)."""
    disp: np.ndarray        # (ncx, ncy, ncz, 3) world displacements
    spacing: object         # per-axis (sx, sy, sz) in reference voxel units
                            # (a scalar is accepted and means isotropic)
    ref_affine: np.ndarray  # (4, 4)


def spacing3(spacing) -> Tuple[float, float, float]:
    """Normalize a control spacing to a per-axis (sx, sy, sz) tuple.

    NiftyReg's ``reg_f3d -sx`` is millimetres *per axis*; on anisotropic
    voxels (e.g. clinical 1x1x3 mm) a single voxel-unit scalar would make
    the grid 3x denser along z than requested, so spacing is per-axis
    everywhere. Scalars mean isotropic."""
    arr = np.asarray(spacing, np.float64).reshape(-1)
    if arr.size == 1:
        arr = np.repeat(arr, 3)
    if arr.size != 3:
        raise ValueError(f"spacing must be scalar or length-3, got {spacing!r}")
    return tuple(float(s) for s in arr)


def downsample2(vol, affine=None):
    """Half-resolution 2x2x2 mean pool (odd tails dropped); numpy arrays or
    tensors alike. With ``affine``, also returns the half-res grid's world
    affine in the SAME world frame: columns double (voxels are 2x coarser)
    and the origin shifts to the 2x2x2 cell centroid. One implementation
    for every registration pyramid (affine + FFD levels) so coordinate-frame
    fixes cannot land in one copy and miss another."""
    x, y, z = (s - s % 2 for s in vol.shape)
    v = vol[:x, :y, :z].reshape(x // 2, 2, y // 2, 2, z // 2, 2).mean((1, 3, 5))
    if affine is None:
        return v
    a = np.asarray(affine, np.float64).copy()
    a[:3, 3] += 0.5 * a[:3, :3].sum(1)
    a[:3, :3] *= 2.0
    return v, a


def load_cpp_grid(path: str, ref_affine: np.ndarray) -> CppGrid:
    """Read a transform.nii written by reg_f3d (5D (ncx,ncy,ncz,1,3)); the
    displacements stay a numpy array on the host.

    Per-axis spacing is recovered column-wise: the grid sform's column j is
    the reference column j scaled by spacing_j (geometry.hpp::save_cpp)."""
    img = load_nii(path)
    if img.data.ndim != 5 or img.data.shape[3] != 1 or img.data.shape[4] != 3:
        raise ValueError(f"{path}: not a SUBCORT_CPP control grid")
    disp = np.asarray(img.data[:, :, :, 0, :], np.float32)
    ra = np.asarray(ref_affine)
    sp = tuple(
        float(np.linalg.norm(img.affine[:3, j]) /
              (np.linalg.norm(ra[:3, j]) or 1.0))
        for j in range(3))
    if not all(s > 0.0 for s in sp):
        # a zeroed sform column means this 5D NIfTI is not a control grid;
        # spacing 0 would divide by zero downstream (silent all-background
        # resamples); geometry.hpp::load_cpp applies the same guard
        raise ValueError(f"{path}: not a SUBCORT_CPP grid (zero spacing {sp})")
    return CppGrid(disp, sp, ra)


def linear_schedule(lr: float, step, iters: int):
    """Learning rate of optimiser step ``step`` (from 0): a linear decay
    from ``lr`` to ``0.1 * lr`` over ``iters`` steps, the JAX package's
    ``optax.linear_schedule(lr, 0.1 * lr, iters)``. ``step`` is an int, or
    a float32 tensor on the device (the level's own count, as optax's)."""
    t = max(int(iters), 1)
    if isinstance(step, torch.Tensor):
        return lr * (1.0 - 0.9 * torch.clamp(step, max=t) / t)
    return lr * (1.0 - 0.9 * min(step, t) / t)


def adam_level(loss_fn, x0: torch.Tensor, iters: int, lr: float,
               grad_mask: Optional[torch.Tensor] = None):
    """The state and the iteration of one optimiser level: ``iters`` steps
    of ``optax.adam(linear_schedule(lr, 0.1 * lr, iters))`` on
    ``loss_fn(x)`` from ``x0``, the JAX package's scan body with optax's
    arithmetic (float32 bias correction from the step count).

    The parameters, Adam's moments, the step count and an ``(iters,)``
    loss vector written at the count all live on ``x0``'s device, and
    ``step()`` updates them in place: it takes no host input and reads
    nothing back, so one call of it can be captured in a CUDA graph and
    replayed (:func:`run_level`). ``grad_mask`` multiplies the gradient
    (the affine's rigid phase). Returns ``(step, x, losses)``."""
    x = x0.detach().clone()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    losses = torch.zeros(iters, dtype=torch.float32, device=x.device)

    def step():
        xg = x.detach().requires_grad_(True)
        loss = loss_fn(xg)
        (g,) = torch.autograd.grad(loss, xg)
        with torch.no_grad():
            if grad_mask is not None:
                g = g * grad_mask
            c = count.to(torch.float32)
            mu.copy_((1.0 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
            mu_hat = mu / (1.0 - ADAM_B1 ** (c + 1.0))
            nu_hat = nu / (1.0 - ADAM_B2 ** (c + 1.0))
            rate = linear_schedule(lr, c, iters)
            x.add_(-rate * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)))
            losses.index_copy_(0, count.view(1), loss.detach().view(1))
            count.add_(1)

    return step, x, losses


def run_level(step, iters: int, device: torch.device, eager: bool = False,
              **facts) -> None:
    """Run one optimiser level: ``iters`` calls of ``step``
    (:func:`adam_level`'s), with TF32 off.

    On the CPU, and on the card when ``eager`` (tests and the smoke
    compare the two), a plain loop. Otherwise the counterpart of the JAX
    package's compiled ``lax.scan``: a :class:`~subcort_tpu_torch.utils.
    graphs.GraphedStep` (:data:`WARMUP_ITERS` eager iterations on this
    thread's capture stream, then one captured in a CUDA graph and
    replayed for the rest), so the level still runs exactly ``iters``
    iterations. A level with no iteration left to replay finishes eagerly.
    The graph goes when the level ends, and its memory pool back to the
    caching allocator. A failed capture or replay raises; nothing falls
    back to the loop.

    The level is one ``register.level`` span with ``facts`` (stage, cost,
    shape) as attributes, and the capture its ``graph.capture`` child.
    While spans record, the level also times itself and adds: ``iters``;
    ``replayed``; ``warmup_iters``; ``capture_ms`` (host ms to capture
    and instantiate the graph); ``device_ms_per_iter`` (CUDA events; None
    on the CPU) and ``host_enqueue_ms_per_iter`` over the replayed
    iterations (all of them in a plain loop); the same for the warm-up;
    and, on the card, ``reserved_bytes`` (the caching allocator's, graph
    pools included, at the level's end). That costs a few events and one
    synchronize, inside the span, which then ends with the level on the
    device."""
    with span("register.level", **facts) as rec:
        on = bool(rec)
        with exact_float32():
            if device.type == "cuda" and not eager:
                with GraphedStep(step, device) as graphed:
                    first, rest = graphed.run(iters, on)
            else:
                first, rest = timed(step, iters, device, on), None
        if not on:
            return
        replayed = rest is not None
        n_warm = WARMUP_ITERS if replayed else 0
        rec.set(iters=iters, replayed=replayed, warmup_iters=n_warm,
                capture_ms=graphed.capture_ms if replayed else None,
                warmup_device_ms_per_iter=None,
                warmup_enqueue_ms_per_iter=None)
        if replayed:
            device_ms, enqueue_ms = rest.per_call(iters - n_warm)
            warm_device_ms, warm_enqueue_ms = first.per_call(n_warm)
            rec.set(warmup_device_ms_per_iter=warm_device_ms,
                    warmup_enqueue_ms_per_iter=warm_enqueue_ms)
        else:
            device_ms, enqueue_ms = first.per_call(iters)
        rec.set(device_ms_per_iter=device_ms,
                host_enqueue_ms_per_iter=enqueue_ms)
        if device.type == "cuda":
            rec.set(reserved_bytes=torch.cuda.memory_reserved(device))


def _bspline_weights(t: torch.Tensor) -> torch.Tensor:
    t2, t3 = t * t, t * t * t
    return torch.stack([(1 - 3 * t + 3 * t2 - t3) / 6.0,
                        (4 - 6 * t2 + 3 * t3) / 6.0,
                        (1 + 3 * t + 3 * t2 - 3 * t3) / 6.0,
                        t3 / 6.0], dim=-1)


def _trilinear(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """vol (X,Y,Z[,C]); coords (..., 3) voxel coordinates; zeros outside.

    The explicit 8-corner form with a per-corner in-bounds test and clamped
    indices (not ``grid_sample``, which normalises coordinates to [-1, 1]
    and back in float32). The gradient flows through ``coords`` only: keep
    ``vol`` without ``requires_grad``, so that autograd builds no scatter
    into it."""
    dims = vol.shape[:3]
    c0 = torch.floor(coords)
    f = coords - c0
    c0 = c0.to(torch.int64)
    # per axis and per offset d in (0, 1): weight, in-bounds flag, clamped index
    axes = []
    for a in range(3):
        per_d = []
        for d in (0, 1):
            ci = c0[..., a] + d
            per_d.append((f[..., a] if d else 1 - f[..., a],
                          (ci >= 0) & (ci < dims[a]),
                          ci.clamp(0, dims[a] - 1)))
        axes.append(per_d)
    flat = vol.reshape((-1,) + tuple(vol.shape[3:]))
    zero = torch.zeros((), dtype=vol.dtype, device=vol.device)
    out = 0.0
    for wx, inx, ix in axes[0]:
        for wy, iny, iy in axes[1]:
            for wz, inz, iz in axes[2]:
                w = wx * wy * wz
                inb = inx & iny & inz
                v = flat[(ix * dims[1] + iy) * dims[2] + iz]
                if vol.ndim == 4:
                    w = w[..., None]
                    inb = inb[..., None]
                out = out + torch.where(inb, w * v, zero)
    return out


def _ref_world_coords(ref_shape, ref_affine, device) -> torch.Tensor:
    """(X, Y, Z, 3) world coordinates of every reference voxel."""
    device = torch.device(device)
    gx, gy, gz = torch.meshgrid(
        *[torch.arange(int(s), device=device) for s in ref_shape],
        indexing="ij")
    vox = torch.stack([gx, gy, gz, torch.ones_like(gx)],
                      dim=-1).to(torch.float32)
    return torch.einsum("ij,xyzj->xyzi", _f32(ref_affine, device),
                        vox)[..., :3]


def _f32(a, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a numpy array or a tensor."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def _apply_affine(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(4, 4) ``m`` applied to (X, Y, Z, 3) points in homogeneous form."""
    pts1 = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    return torch.einsum("ij,xyzj->xyzi", m[:3, :], pts1)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _resample_affine(flo: torch.Tensor, affine, flo_inv, ref_affine,
                     ref_shape) -> torch.Tensor:
    """The device program of :func:`resample_through_affine`: ``flo`` on
    its device in, the resampled tensor out."""
    w = _ref_world_coords(ref_shape, ref_affine, flo.device)
    fw = _apply_affine(_f32(affine, flo.device), w)
    return _trilinear(flo, _apply_affine(_f32(flo_inv, flo.device), fw))


def resample_through_affine(flo: np.ndarray, flo_affine: np.ndarray,
                            affine: np.ndarray, ref_shape, ref_affine,
                            device=None) -> np.ndarray:
    """Pull-resample ``flo`` (3D or 4D multichannel) into the reference grid
    through a world affine (flo_world = A . ref_world)."""
    device = resolve_device(device)
    with torch.no_grad(), exact_float32():
        out = _resample_affine(
            _f32(np.asarray(flo, np.float32), device), affine,
            np.linalg.inv(np.asarray(flo_affine)), ref_affine,
            tuple(int(s) for s in ref_shape))
    return _to_numpy(out)


def _bspline_axis_matrix(n: int, spacing, nc: int, vox_offset: float,
                         device) -> torch.Tensor:
    """Dense (n, nc) cubic B-spline evaluation matrix for one axis: row v
    holds the 4 basis weights of voxel v against the clamped control
    lattice (clip-accumulated at the edges, matching the gather loop this
    replaces). Dense-banded on purpose: nc is tiny (~20-40), so the three
    per-axis contractions are matmuls instead of 64 serialized gathers.

    ``vox_offset`` shifts this level's voxel coordinates into the canonical
    (finest-level) lattice frame: the half-resolution pyramid level maps
    coarse voxel v to fine voxel 2v+0.5, so it evaluates at
    u=(v+0.25)/(sp/2) (vox_offset=0.25); 0 = the canonical frame itself."""
    u = (torch.arange(n, dtype=torch.float32, device=device)
         + vox_offset) / spacing
    b = torch.floor(u).to(torch.int64)
    w = _bspline_weights(u - b)  # (n, 4)
    W = torch.zeros((n, nc), dtype=torch.float32, device=device)
    for a in range(4):
        W = W + w[:, a, None] * torch.nn.functional.one_hot(
            (b + a).clamp(0, nc - 1), nc).to(torch.float32)
    return W


def bspline_axis_matrices(shape, spacing, counts, vox_offset: float = 0.0,
                          device=None):
    """The three per-axis matrices of :func:`bspline_dense_disp`. They
    depend only on shape, spacing and ``vox_offset``: an optimiser level
    builds them once and contracts with them every iteration."""
    device = resolve_device(device)
    sp = spacing3(spacing)
    return tuple(_bspline_axis_matrix(int(shape[i]), sp[i], int(counts[i]),
                                      vox_offset, device) for i in range(3))


def contract_dense_disp(disp: torch.Tensor, matrices) -> torch.Tensor:
    """The three separable contractions of :func:`bspline_dense_disp`."""
    wx, wy, wz = matrices
    t = torch.einsum("xa,abck->xbck", wx, disp)
    t = torch.einsum("yb,xbck->xyck", wy, t)
    return torch.einsum("zc,xyck->xyzk", wz, t)


def bspline_dense_disp(disp: torch.Tensor, spacing, shape,
                       vox_offset: float = 0.0) -> torch.Tensor:
    """(ncx,ncy,ncz,3) control displacements -> (X,Y,Z,3) displacement at
    every reference voxel, as three separable tensor contractions.

    Mathematically identical to the naive 64-term gather accumulation
    (cubic B-spline tensor product, control i at voxel (i-1)*spacing_axis):
    12 effective taps instead of 64, no gathers, and the contractions are
    matmuls. ``spacing`` is per-axis (scalar = isotropic). Runs on
    ``disp``'s device."""
    return contract_dense_disp(disp, bspline_axis_matrices(
        shape, spacing, disp.shape[:3], vox_offset, disp.device))


def _resample_cpp(flo: torch.Tensor, disp, spacing, flo_inv, ref_affine,
                  ref_shape) -> torch.Tensor:
    """The device program of :func:`resample_through_cpp`: ``flo`` on its
    device in, the resampled tensor out."""
    d = bspline_dense_disp(_f32(disp, flo.device), spacing, ref_shape)
    w = _ref_world_coords(ref_shape, ref_affine, flo.device)
    return _trilinear(flo, _apply_affine(_f32(flo_inv, flo.device), w + d))


def resample_through_cpp(flo: np.ndarray, flo_affine: np.ndarray,
                         grid: CppGrid, ref_shape, ref_affine,
                         device=None) -> np.ndarray:
    """Pull-resample through a B-spline control grid (all channels in one
    pass: the reference's 15-subprocess loop becomes one device program)."""
    device = resolve_device(device)
    with torch.no_grad(), exact_float32():
        out = _resample_cpp(
            _f32(np.asarray(flo, np.float32), device), grid.disp,
            spacing3(grid.spacing), np.linalg.inv(np.asarray(flo_affine)),
            ref_affine, tuple(int(s) for s in ref_shape))
    return _to_numpy(out)
