"""The dense scan's inputs derived on the device: the scan's nonzero
moments and the candidates' extent (:func:`scan_moments`), and the
candidates' prior rows and linear bbox indices (:func:`prior_rows`).

What the JAX package computes in numpy on its host for each scan
(:func:`~subcort_tpu_torch.ops.normalize.normalize_stats`, ``_bbox_of``
and the range check, ``_fcn_slab_inputs``' candidate indices,
``_atlas_vectors_host`` and ``_quantize_priors``), computed where the raw
scan, the centers and the prior block already lie; ``engine/infer.py``
derives every dense scan's inputs so. On a CUDA tensor each
function launches its kernel in ``csrc/scan_inputs.cu`` (its header says
what bounds it and how it works) on the current stream without a host
sync, or raises; on a CPU tensor it runs its plain version,
:func:`scan_moments_plain` or :func:`prior_rows_plain`, which compute the
same integers and the same rows bit for bit. ``LAUNCHES`` counts the calls
that reached a kernel.

Neither kernel replaces a TPU kernel: the JAX package derives these on its
host too.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from subcort_tpu_torch.utils.build import load_library
from subcort_tpu_torch.utils.graphs import count_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "scan_inputs.cu"

# the scan's voxel types and the prior rows' wire types, numbered as the
# kernels' source numbers them
VOXEL_TYPES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2,
               torch.uint16: 3}
ROW_TYPES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
             np.dtype(np.float16): 2, np.dtype(np.float32): 3}
CHANNELS = 15
# the fix-up's background channel
BACKGROUND = 14
# the kernels take fewer voxels and rows than this
MAX_ELEMENTS = 2 ** 31

LAUNCHES = 0
_LOCK = threading.Lock()


# ------------------------------------------------------------ plain
def scan_moments_plain(volume: torch.Tensor,
                       centers: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: int64 (9,) = the count of nonzero voxels
    of ``volume``, their sum and their sum of squares, then the (N, 3)
    ``centers``' per-axis minimum and maximum (int64's largest and smallest
    value where there are no centers)."""
    v = volume.reshape(-1).to(torch.int64)
    c = centers.reshape(-1, 3).to(torch.int64)
    if len(c):
        lo, hi = c.min(0).values, c.max(0).values
    else:
        info = torch.iinfo(torch.int64)
        lo = torch.full((3,), info.max, dtype=torch.int64)
        hi = torch.full((3,), info.min, dtype=torch.int64)
    return torch.cat([torch.stack([torch.count_nonzero(v), v.sum(),
                                   (v * v).sum()]), lo, hi])


def _numpy_sum(p: torch.Tensor) -> torch.Tensor:
    """Each row's float32 sum of its 15 values in numpy's order
    (``vecs.sum(axis=1)``): pairwise over the first 8, then the rest one
    by one."""
    c = p.unbind(1)
    s = ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5]) + (c[6] + c[7]))
    for k in range(8, CHANNELS):
        s = s + c[k]
    return s


def _wire(p: torch.Tensor, prior_dtype) -> torch.Tensor:
    """Float32 rows in ``prior_dtype`` as the JAX package's
    ``_quantize_priors`` writes them:
    uint8 and uint16 as ``np.round(p * scale).astype(...)`` (round half to
    even, then numpy's cast: to int32, INT32_MIN outside its range or for
    NaN, the low bits kept), float16 and float32 a plain cast."""
    dtype = np.dtype(prior_dtype)
    if dtype.kind == "u":
        bits = 8 * dtype.itemsize
        r = torch.round(p * float(2 ** bits - 1))
        i = torch.where((r >= -2.0 ** 31) & (r < 2.0 ** 31), r,
                        -2.0 ** 31).to(torch.int32)
        return (i & (2 ** bits - 1)).to(getattr(torch, dtype.name))
    return p.to(getattr(torch, dtype.name))


def prior_rows_plain(block: torch.Tensor, centers: Optional[torch.Tensor],
                     lo: Sequence[int], prior_dtype):
    """The kernel's plain version: (rows, lin). ``block`` is the (bx, by,
    bz, 15) float32 prior block of the bbox at ``lo`` (any strides);
    ``centers`` (N, 3) int32 voxels inside it, or None for every block
    voxel in C order. Each row takes the background fix-up of
    ``_atlas_vectors_host`` (a row whose float32 sum is 0 becomes channel
    14 = 1, the rest 0) and the wire type of the JAX package's
    ``_quantize_priors``; ``lin``
    is each center's int64 linear bbox index, None without centers."""
    bx, by, bz, _ = block.shape
    if centers is None:
        p, lin = block.reshape(-1, CHANNELS), None
    else:
        rel = centers.to(torch.int64) - torch.as_tensor(
            [int(v) for v in lo], dtype=torch.int64, device=centers.device)
        x, y, z = rel.unbind(1)
        lin = (x * by + y) * bz + z
        p = block[x, y, z]
    p = p.to(torch.float32)
    fix = torch.zeros(CHANNELS, dtype=torch.float32, device=p.device)
    fix[BACKGROUND] = 1.0
    p = torch.where((_numpy_sum(p) == 0)[:, None], fix, p)
    return _wire(p, prior_dtype), lin


# ------------------------------------------------------------ kernels
def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``SOURCE``."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.scan_moments_launch.argtypes = [p, i32, i64, p, i64, p, p]
    lib.scan_moments_launch.restype = i32
    lib.prior_rows_launch.argtypes = [p, i64, i64, i64, p, i64, i64, i64,
                                      i64, i32, p, p, p]
    lib.prior_rows_launch.restype = i32
    lib.scan_inputs_error_string.argtypes = [i32]
    lib.scan_inputs_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_once() -> ctypes.CDLL:
    return bind(load_library("scan_inputs", [SOURCE]))


def _library() -> ctypes.CDLL:
    with _LOCK:
        return _library_once()


def _add_launches(n: int) -> None:
    global LAUNCHES
    with _LOCK:
        LAUNCHES += n


def _launched(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.scan_inputs_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: error {err} ({msg})")
    count_launch(_add_launches)


def _check_centers(centers: torch.Tensor, device: torch.device) -> None:
    if (centers.dtype != torch.int32 or centers.dim() != 2
            or centers.shape[1] != 3):
        raise ValueError(f"centers must be (N, 3) int32, got {centers.dtype} "
                         f"of shape {tuple(centers.shape)}")
    if centers.device != device:
        raise ValueError(f"centers on {centers.device}, expected {device}")
    if centers.shape[0] >= MAX_ELEMENTS:
        raise ValueError(f"{centers.shape[0]} centers exceed one launch")


def _cuda_only(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {t.device}")


def scan_moments(volume: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """int64 (9,) on ``volume``'s device: the nonzero count, sum and sum of
    squares of the narrow-integer ``volume`` (int8, uint8, int16 or
    uint16), then the per-axis minimum and maximum of the (N, 3) int32
    ``centers``. A CUDA tensor launches ``scan_moments`` without a host
    sync, or raises; a CPU tensor takes :func:`scan_moments_plain`."""
    if volume.dtype not in VOXEL_TYPES:
        raise ValueError(f"no moments of a {volume.dtype} scan: the kernel "
                         f"takes {sorted(str(t) for t in VOXEL_TYPES)}")
    _check_centers(centers, volume.device)
    if volume.device.type == "cpu":
        return scan_moments_plain(volume, centers)
    _cuda_only(volume, "scan_moments")
    if not (volume.is_contiguous() and centers.is_contiguous()):
        raise ValueError("volume and centers must be contiguous")
    if volume.numel() >= MAX_ELEMENTS:
        raise ValueError(f"{volume.numel()} voxels exceed one launch")
    out = torch.empty(9, dtype=torch.int64, device=volume.device)
    lib = _library()
    with torch.cuda.device(volume.device):
        stream = torch.cuda.current_stream(volume.device).cuda_stream
        err = lib.scan_moments_launch(
            volume.data_ptr(), VOXEL_TYPES[volume.dtype], volume.numel(),
            centers.data_ptr(), centers.shape[0], out.data_ptr(), stream)
    _launched(lib, err, "scan_moments")
    return out


def prior_rows(block: torch.Tensor, centers: Optional[torch.Tensor],
               lo: Sequence[int], prior_dtype):
    """(rows, lin) on ``block``'s device, as :func:`prior_rows_plain`
    computes them: (N, 15) rows in ``prior_dtype`` (uint8, uint16, float16
    or float32) and the int64 (N,) linear bbox indices of ``centers``, or
    a row for every block voxel and None without centers. ``centers`` must
    lie inside the block: the kernel trusts them. A CUDA tensor launches
    ``prior_rows`` without a host sync, or raises; a CPU tensor takes
    :func:`prior_rows_plain`."""
    if np.dtype(prior_dtype) not in ROW_TYPES:
        raise ValueError(f"no prior rows in {np.dtype(prior_dtype)}: the "
                         f"kernel writes {[str(d) for d in ROW_TYPES]}")
    if (block.dtype != torch.float32 or block.dim() != 4
            or block.shape[3] != CHANNELS):
        raise ValueError(f"block must be (bx, by, bz, {CHANNELS}) float32, "
                         f"got {block.dtype} of shape {tuple(block.shape)}")
    if centers is not None:
        _check_centers(centers, block.device)
    if block.device.type == "cpu":
        return prior_rows_plain(block, centers, lo, prior_dtype)
    _cuda_only(block, "prior_rows")
    if not block.is_contiguous() or (centers is not None
                                     and not centers.is_contiguous()):
        raise ValueError("block and centers must be contiguous")
    bx, by, bz, _ = block.shape
    if bx * by * bz >= MAX_ELEMENTS:
        raise ValueError(f"a block of {bx * by * bz} voxels exceeds one "
                         "launch")
    dev = block.device
    n = bx * by * bz if centers is None else centers.shape[0]
    rows = torch.empty((n, CHANNELS),
                       dtype=getattr(torch, np.dtype(prior_dtype).name),
                       device=dev)
    lin = (None if centers is None
           else torch.empty(n, dtype=torch.int64, device=dev))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.prior_rows_launch(
            block.data_ptr(), bx, by, bz,
            None if centers is None else centers.data_ptr(), n,
            *(int(v) for v in lo), ROW_TYPES[np.dtype(prior_dtype)],
            rows.data_ptr(), None if lin is None else lin.data_ptr(), stream)
    _launched(lib, err, "prior_rows")
    return rows, lin
