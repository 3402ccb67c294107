"""Plain reference of registration's resampling and of its transforms.

Nothing of the program: a NIfTI-1 reader of the subset the program writes
(one ``.nii`` or ``.nii.gz`` file, little-endian, voxels in Fortran order,
``scl_slope``, the sform), the cubic B-spline deformation of a
``transform.nii`` control grid, trilinear pull-resampling with zeros
outside, the inverse of a transform by fixed-point iteration, and the
Jacobian determinant by central differences.

The control grid's contract (native/src/geometry.hpp, SUBCORT_CPP): a 5D
(ncx, ncy, ncz, 1, 3) float32 volume of world displacements whose sform's
column j is the reference's column j times the spacing ``s_j`` (reference
voxels); control i sits at reference voxel ``(i - 1) s``; voxel v takes
controls ``floor(v / s) .. floor(v / s) + 3`` (clamped to the grid) with
the cubic B-spline weights of ``v / s - floor(v / s)``. A reference voxel v
maps to the floating image's voxel ``inv(flo_affine) (ref_affine v +
d(v))``.

``precision`` is ``"float32"`` or ``"tf32"``, the control: the operands of
every coordinate product (the B-spline weights times the controls, the
affines times the points) rounded to TF32's 10-bit mantissa
(``reference/triplanar.py::to_tf32``).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np
import torch

from benchmark.reference.triplanar import to_tf32

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
           64: np.float64, 256: np.int8, 512: np.uint16}


def read_nifti(path: str):
    """(data in (X, Y, Z, ...) order, the 4 x 4 sform) of a NIfTI-1 file."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as fh:
        raw = fh.read()
    if struct.unpack_from("<i", raw, 0)[0] != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dims = struct.unpack_from("<8h", raw, 40)
    shape = tuple(int(d) for d in dims[1:dims[0] + 1])
    dtype = np.dtype(_DTYPES[struct.unpack_from("<h", raw, 70)[0]])
    offset = int(struct.unpack_from("<f", raw, 108)[0])
    slope, inter = struct.unpack_from("<2f", raw, 112)
    n = int(np.prod(shape))
    data = np.frombuffer(raw, dtype.newbyteorder("<"), n, offset)
    data = data.reshape(shape[::-1]).T
    if slope not in (0.0, 1.0) or inter != 0.0:
        data = data * np.float32(slope) + np.float32(inter)
    affine = np.eye(4)
    affine[:3] = np.asarray(struct.unpack_from("<12f", raw, 280),
                            np.float64).reshape(3, 4)
    return np.ascontiguousarray(data), affine


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return to_tf32(t)
    if precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return t


def _bspline(t: torch.Tensor):
    """The four cubic B-spline weights of fractions ``t``."""
    return ((1 - t) ** 3 / 6, (3 * t ** 3 - 6 * t ** 2 + 4) / 6,
            (-3 * t ** 3 + 3 * t ** 2 + 3 * t + 1) / 6, t ** 3 / 6)


def deformation(disp: torch.Tensor, spacing, points: torch.Tensor,
                precision: str = "float32") -> torch.Tensor:
    """(..., 3) world displacement at reference voxel coordinates ``points``
    (..., 3) of the control grid ``disp`` (ncx, ncy, ncz, 3): 64 controls
    each, gathered and weighted."""
    nc = disp.shape[:3]
    base, weights = [], []
    for a in range(3):
        u = points[..., a] / float(spacing[a])
        b = torch.floor(u)
        base.append(b.long())
        weights.append(_bspline(u - b))
    out = torch.zeros(points.shape, dtype=torch.float32, device=points.device)
    d = _round(disp, precision)
    for i in range(4):
        ix = (base[0] + i).clamp(0, nc[0] - 1)
        for j in range(4):
            iy = (base[1] + j).clamp(0, nc[1] - 1)
            wij = weights[0][i] * weights[1][j]
            for k in range(4):
                iz = (base[2] + k).clamp(0, nc[2] - 1)
                w = _round(wij * weights[2][k], precision)
                out += w[..., None] * d[ix, iy, iz]
    return out


def _affine(m: np.ndarray, pts: torch.Tensor, precision: str):
    a = _round(torch.as_tensor(np.asarray(m, np.float32)[:3, :3],
                               device=pts.device), precision)
    t = torch.as_tensor(np.asarray(m, np.float32)[:3, 3], device=pts.device)
    return _round(pts, precision) @ a.T + t


def trilinear(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``vol`` (X, Y, Z[, C]) at voxel coordinates ``coords`` (..., 3); a
    corner outside the volume counts 0."""
    dims = vol.shape[:3]
    c0 = torch.floor(coords)
    f = coords - c0
    c0 = c0.long()
    out = 0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = [c0[..., 0] + dx, c0[..., 1] + dy, c0[..., 2] + dz]
                inside = ((idx[0] >= 0) & (idx[0] < dims[0])
                          & (idx[1] >= 0) & (idx[1] < dims[1])
                          & (idx[2] >= 0) & (idx[2] < dims[2]))
                w = ((f[..., 0] if dx else 1 - f[..., 0])
                     * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                w = torch.where(inside, w, torch.zeros_like(w))
                v = vol[idx[0].clamp(0, dims[0] - 1),
                        idx[1].clamp(0, dims[1] - 1),
                        idx[2].clamp(0, dims[2] - 1)]
                out = out + (w[..., None] * v if vol.dim() == 4 else w * v)
    return out


def voxel_grid(shape, start: int, stop: int, device) -> torch.Tensor:
    """(stop - start, Y, Z, 3) float32 coordinates of x-slabs start..stop."""
    axes = [torch.arange(start, stop, device=device, dtype=torch.float32)]
    axes += [torch.arange(int(s), device=device, dtype=torch.float32)
             for s in shape[1:3]]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def mapped(grid, points: torch.Tensor, ref_affine, flo_affine,
           precision: str = "float32") -> torch.Tensor:
    """Floating-image voxel coordinates of reference voxels ``points``
    through ``grid`` = (disp tensor, spacing)."""
    disp, spacing = grid
    world = _affine(ref_affine, points, precision)
    world = world + deformation(disp, spacing, points, precision)
    return _affine(np.linalg.inv(flo_affine), world, precision)


@torch.no_grad()
def resample(flo: torch.Tensor, flo_affine, grid, ref_shape, ref_affine,
             precision: str = "float32", slab: int = 8) -> torch.Tensor:
    """``flo`` (X, Y, Z[, C]) pulled onto the reference grid through the
    control grid ``grid`` (disp tensor, spacing), slab by slab."""
    out = []
    for start in range(0, int(ref_shape[0]), slab):
        stop = min(start + slab, int(ref_shape[0]))
        pts = voxel_grid(ref_shape, start, stop, flo.device)
        out.append(trilinear(flo, mapped(grid, pts, ref_affine, flo_affine,
                                         precision)))
    return torch.cat(out)


def read_grid(path: str, ref_affine, device):
    """(disp tensor (ncx, ncy, ncz, 3), spacing) of a ``transform.nii``."""
    data, affine = read_nifti(path)
    if data.ndim != 5 or data.shape[3:] != (1, 3):
        raise ValueError(f"{path}: not a control grid")
    ra = np.asarray(ref_affine, np.float64)
    spacing = tuple(float(np.linalg.norm(affine[:3, j])
                          / np.linalg.norm(ra[:3, j])) for j in range(3))
    disp = torch.from_numpy(np.ascontiguousarray(data[:, :, :, 0, :],
                                                 np.float32)).to(device)
    return disp, spacing


@torch.no_grad()
def inverse(grid, points: torch.Tensor, iters: int = 40) -> torch.Tensor:
    """Voxel coordinates x with ``x + d(x) = points`` (identity affines),
    by fixed-point iteration ``x <- points - d(x)``: a contraction while
    the displacement's Jacobian stays under 1 in norm."""
    disp, spacing = grid
    x = points.clone()
    for _ in range(iters):
        x = points - deformation(disp, spacing, x)
    return x


@torch.no_grad()
def jacobian_det(grid, shape, device, slab: int = 16) -> torch.Tensor:
    """det of the Jacobian of ``v -> v + d(v)`` (identity affines) at the
    interior voxels, by central differences of the displacement."""
    disp, spacing = grid
    dets = []
    for start in range(1, int(shape[0]) - 1, slab):
        stop = min(start + slab, int(shape[0]) - 1)
        pts = voxel_grid(shape, start - 1, stop + 1, device)
        d = deformation(disp, spacing, pts)
        cols = []
        for ax in range(3):
            hi = [slice(1, -1)] * 3
            lo = [slice(1, -1)] * 3
            hi[ax], lo[ax] = slice(2, None), slice(0, -2)
            g = 0.5 * (d[tuple(hi)] - d[tuple(lo)])
            g[..., ax] += 1.0
            cols.append(g)
        dets.append(torch.linalg.det(torch.stack(cols, -1)))
    return torch.cat(dets)
