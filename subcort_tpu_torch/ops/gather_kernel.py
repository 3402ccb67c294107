"""The tri-planar gather kernel: binding and wrapper.

Port of the TPU kernel subcort_tpu/ops/pallas_gather.py::
gather_triplanar_pallas. The kernel is CUDA C++ for Hopper
(``csrc/gather_triplanar.cu``; its header says what bounds it), built at
first use by :mod:`subcort_tpu_torch.utils.build` and called through
:mod:`ctypes`.

One wrapper covers both modes of the TPU kernel: single volume (the patch
engine; a padded (X', Y', Z') volume with (N, 3) centers) and subject stack
(training; (S, X', Y', Z') with (N, 4) rows (subject, x, y, z)). The TPU
layout helpers (``make_view_volumes*``, ``_pad_aligned``) and the
``SUBCORT_PALLAS_BLOCK`` knob have no counterpart: the kernel reads the
padded volume in place and takes any N.

On a CPU tensor the wrapper runs the plain version
(:mod:`subcort_tpu_torch.ops.patches`); on a CUDA tensor it launches the
kernel or raises. ``LAUNCHES`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from subcort_tpu_torch.ops.patches import (PATCH, Patches, gather_triplanar,
                                           gather_triplanar_subjects)
from subcort_tpu_torch.utils.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "gather_triplanar.cu"

LAUNCHES = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("gather_triplanar", [SOURCE])
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gather_triplanar_f32.argtypes = [p, p, i32, i64, i64, i64, i64,
                                         p, p, p, p]
    lib.gather_triplanar_f32.restype = i32
    lib.gather_triplanar_error_string.argtypes = [i32]
    lib.gather_triplanar_error_string.restype = ctypes.c_char_p
    return lib


def _check(padded: torch.Tensor, centers: torch.Tensor) -> None:
    if padded.dim() not in (3, 4):
        raise ValueError(f"padded must be (X', Y', Z') or (S, X', Y', Z'), "
                         f"got shape {tuple(padded.shape)}")
    cols = padded.dim()
    if centers.dim() != 2 or centers.shape[1] != cols:
        raise ValueError(f"a {cols - 1}-D padded volume takes (N, {cols}) "
                         f"centers, got shape {tuple(centers.shape)}")
    if padded.dtype != torch.float32:
        raise TypeError(f"padded must be float32, got {padded.dtype}")
    if centers.dtype != torch.int32:
        raise TypeError(f"centers must be int32, got {centers.dtype}")
    if min(padded.shape[-3:]) < PATCH:
        raise ValueError(f"padded spatial dims {tuple(padded.shape[-3:])} "
                         f"are smaller than one {PATCH}-voxel window")
    if centers.device != padded.device:
        raise ValueError(f"centers on {centers.device}, padded on "
                         f"{padded.device}")
    if not (padded.is_contiguous() and centers.is_contiguous()):
        raise ValueError("padded and centers must be contiguous")


def gather_triplanar_cuda(padded: torch.Tensor,
                          centers: torch.Tensor) -> Patches:
    """(axial, coronal, sagittal), three contiguous (N, 32, 32) float32.

    ``padded``: float32 volume zero-padded by 16, (X', Y', Z') or
    (S, X', Y', Z'); ``centers``: int32 (N, 3) or (N, 4) in original
    coordinates, which the caller keeps inside the volume. CPU tensors take
    the plain version; CUDA tensors launch the kernel.
    """
    global LAUNCHES
    _check(padded, centers)
    if padded.device.type == "cpu":
        if padded.dim() == 3:
            return gather_triplanar(padded, centers)
        return gather_triplanar_subjects(padded, centers)
    if padded.device.type != "cuda":
        raise ValueError(f"no gather for device {padded.device}")
    n = int(centers.shape[0])
    if n >= 2 ** 31:
        raise ValueError(f"{n} centers exceed one launch's grid")
    xp, yp, zp = (int(d) for d in padded.shape[-3:])
    outs = tuple(torch.empty((n, PATCH, PATCH), dtype=torch.float32,
                             device=padded.device) for _ in range(3))
    if n == 0:
        return outs
    lib = _library()
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream(padded.device).cuda_stream
        err = lib.gather_triplanar_f32(
            padded.data_ptr(), centers.data_ptr(), int(centers.shape[1]), n,
            xp, yp, zp, outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), stream)
    if err != 0:
        msg = lib.gather_triplanar_error_string(err).decode()
        raise RuntimeError(f"gather_triplanar launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES += 1
    return outs
