"""The tri-planar gather kernel: its layouts, binding and wrapper.

Port of the TPU kernel subcort_tpu/ops/pallas_gather.py::
gather_triplanar_pallas. The kernel is CUDA C++ for Hopper
(``csrc/gather_triplanar.cu``; its header says what bounds it and how it
copies), built at first use by :mod:`subcort_tpu_torch.utils.build` and
called through :mod:`ctypes`.

One wrapper covers both modes of the TPU kernel: single volume (the patch
engine; a padded (X', Y', Z') volume with (N, 3) centers) and subject stack
(training; (S, X', Y', Z') with (N, 4) rows (subject, x, y, z)).

The kernel reads two layouts of the padded volume, made once per volume
by :func:`prepare_gather_volume` in plain PyTorch (as the JAX package made
its ``make_view_volumes`` outside its kernel): ``xyz`` for the coronal and
sagittal windows and the z-major ``zxy`` for the axial window, so that
every window is 32 rows of 32 contiguous floats. Their innermost extents
round up to a multiple of 4 floats, because the Tensor Memory Accelerator
takes only global strides that are multiples of 16 bytes.

On the CPU the wrapper runs the plain version
(:mod:`subcort_tpu_torch.ops.patches`) on the padded volume; on the card
it launches the kernel on a :class:`GatherVolume` or raises, except at a
patch size other than 32, which takes the plain version on the card as
the JAX package takes its plain gather there. ``LAUNCHES`` counts kernel
launches, and nothing else: a launch recorded by a CUDA graph's capture
(:mod:`subcort_tpu_torch.utils.graphs`) counts once per replay.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

from subcort_tpu_torch.ops.patches import (HALF, PATCH, Patches,
                                           gather_triplanar,
                                           gather_triplanar_subjects)
from subcort_tpu_torch.utils.build import load_library
from subcort_tpu_torch.utils.graphs import count_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "gather_triplanar.cu"

# TMA global strides are multiples of 16 bytes: 4 float32
ALIGN = 4
# bytes each center writes: three 32x32 float32 windows
OUT_BYTES_PER_CENTER = 3 * PATCH * PATCH * 4

LAUNCHES = 0
# the multi-device patch engine launches from one thread per device
_COUNT_LOCK = threading.Lock()


class GatherVolume(NamedTuple):
    """The kernel's two layouts of one padded volume or subject stack.

    ``xyz``: (S, X', Y', Z'4) and ``zxy``: (S, Z', X', Y'4), contiguous
    float32, where Z'4 and Y'4 are Z' and Y' rounded up to a multiple of 4
    and the rounding pad is zero. ``stacked`` says whether the source was
    an (S, X', Y', Z') stack, which takes (N, 4) centers, or one volume
    (S = 1), which takes (N, 3).
    """

    xyz: torch.Tensor
    zxy: torch.Tensor
    stacked: bool

    @property
    def shape(self) -> tuple:
        """(S, X', Y', Z') of the padded source."""
        s, xp, yp, _ = self.xyz.shape
        return (int(s), int(xp), int(yp), int(self.zxy.shape[1]))

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def padded(self) -> torch.Tensor:
        """The padded source as a view of ``xyz``: (X', Y', Z') or
        (S, X', Y', Z')."""
        view = self.xyz[..., :self.shape[3]]
        return view if self.stacked else view[0]


def _add_launches(n: int) -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += n


def _round_up(n: int, k: int = ALIGN) -> int:
    return -(-n // k) * k


def prepare_gather_volume(padded: torch.Tensor) -> GatherVolume:
    """Both kernel layouts of a padded float32 volume (X', Y', Z') or stack
    (S, X', Y', Z'): a pad copy and a permute copy, about twice the
    volume's bytes, on the volume's device."""
    if padded.dim() not in (3, 4):
        raise ValueError(f"padded must be (X', Y', Z') or (S, X', Y', Z'), "
                         f"got shape {tuple(padded.shape)}")
    if padded.dtype != torch.float32:
        raise TypeError(f"padded must be float32, got {padded.dtype}")
    vol = padded if padded.dim() == 4 else padded[None]
    _, _, yp, zp = vol.shape
    xyz = F.pad(vol, (0, _round_up(zp) - zp)).contiguous()
    zxy = F.pad(vol.permute(0, 3, 1, 2), (0, _round_up(yp) - yp)).contiguous()
    return GatherVolume(xyz, zxy, padded.dim() == 4)


def window_index(centers: torch.Tensor, padded_shape) -> torch.Tensor:
    """(N, 3, 32, 32) int64 linear indices into the contiguous padded
    volume (X', Y', Z') or stack (S, X', Y', Z') of the axial, coronal and
    sagittal windows of each center: ``padded.take(window_index(...))`` is
    the gather."""
    shape = tuple(int(d) for d in padded_shape)
    xp, yp, zp = shape[-3:]
    c = centers.long()
    s = c[:, 0] if c.shape[1] == 4 else torch.zeros_like(c[:, 0])
    x, y, z = (c[:, k, None, None] for k in (-3, -2, -1))
    i = torch.arange(PATCH, device=c.device)[:, None]
    j = torch.arange(PATCH, device=c.device)[None, :]
    base = s[:, None, None] * xp

    def lin(a, b, d):
        return ((base + a) * yp + b) * zp + d

    return torch.stack([lin(x + i, y + j, z + HALF),
                        lin(x + i, y + HALF, z + j),
                        lin(x + HALF, y + i, z + j)], 1)


def gather_roofline_bytes(centers: torch.Tensor, padded_shape) -> int:
    """Bytes the gather must move at least: every distinct padded-volume
    voxel that a window of ``centers`` touches, read once, plus
    ``OUT_BYTES_PER_CENTER`` written per center."""
    shape = tuple(int(d) for d in padded_shape)
    n = int(centers.shape[0])
    touched = torch.zeros(int(torch.tensor(shape).prod()), dtype=torch.bool,
                          device=centers.device)
    if n:
        touched[window_index(centers, shape).reshape(-1)] = True
    return int(touched.sum()) * 4 + n * OUT_BYTES_PER_CENTER


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``SOURCE``."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gather_triplanar_f32.argtypes = [p, p, i64, i64, i64, i64, i64, i64,
                                         p, i32, i64, p, p, p, p]
    lib.gather_triplanar_f32.restype = i32
    lib.gather_triplanar_error_string.argtypes = [i32]
    lib.gather_triplanar_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_once() -> ctypes.CDLL:
    return bind(load_library("gather_triplanar", [SOURCE]))


def _library() -> ctypes.CDLL:
    # under the lock: threads that launch at once build and load it once
    with _COUNT_LOCK:
        return _library_once()


def _check_centers(centers: torch.Tensor, cols: int,
                   device: torch.device) -> None:
    if centers.dim() != 2 or centers.shape[1] != cols:
        raise ValueError(f"this volume takes (N, {cols}) centers, got shape "
                         f"{tuple(centers.shape)}")
    if centers.dtype != torch.int32:
        raise TypeError(f"centers must be int32, got {centers.dtype}")
    if centers.device != device:
        raise ValueError(f"centers on {centers.device}, volume on {device}")
    if not centers.is_contiguous():
        raise ValueError("centers must be contiguous")


def _check_padded(padded: torch.Tensor, centers: torch.Tensor) -> None:
    if padded.dim() not in (3, 4):
        raise ValueError(f"padded must be (X', Y', Z') or (S, X', Y', Z'), "
                         f"got shape {tuple(padded.shape)}")
    if padded.dtype != torch.float32:
        raise TypeError(f"padded must be float32, got {padded.dtype}")
    if min(padded.shape[-3:]) < PATCH:
        raise ValueError(f"padded spatial dims {tuple(padded.shape[-3:])} "
                         f"are smaller than one {PATCH}-voxel window")
    if not padded.is_contiguous():
        raise ValueError("padded must be contiguous")
    _check_centers(centers, padded.dim(), padded.device)


def _check_prepared(vol: GatherVolume, centers: torch.Tensor) -> None:
    s, xp, yp, zp = vol.shape
    want_xyz = (s, xp, yp, _round_up(zp))
    want_zxy = (s, zp, xp, _round_up(yp))
    if (tuple(vol.xyz.shape) != want_xyz
            or tuple(vol.zxy.shape) != want_zxy):
        raise ValueError(f"not a prepare_gather_volume layout: xyz "
                         f"{tuple(vol.xyz.shape)}, zxy {tuple(vol.zxy.shape)}")
    for t in (vol.xyz, vol.zxy):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the prepared layouts must be contiguous float32")
    if vol.zxy.device != vol.device:
        raise ValueError("xyz and zxy lie on different devices")
    if min(xp, yp, zp) < PATCH:
        raise ValueError(f"padded spatial dims {(xp, yp, zp)} are smaller "
                         f"than one {PATCH}-voxel window")
    if not vol.stacked and s != 1:
        raise ValueError(f"a single volume has S = 1, got {s}")
    _check_centers(centers, 4 if vol.stacked else 3, vol.device)


def takes_kernel(device: torch.device, patch: int) -> bool:
    """Whether :func:`gather_triplanar_cuda` launches the kernel: on a CUDA
    device at the kernel's 32x32 windows. Any other patch size takes the
    plain version on the same device, the JAX package's own rule
    (subcort_tpu/engine/train.py:465-467: the Pallas kernel only at
    ``patch_size == 32``); the CPU always takes it."""
    return device.type == "cuda" and patch == PATCH


def gather_triplanar_cuda(volume: torch.Tensor | GatherVolume,
                          centers: torch.Tensor,
                          patch: int = PATCH) -> Patches:
    """(axial, coronal, sagittal), three contiguous (N, patch, patch)
    float32.

    ``volume``: on the card, a :class:`GatherVolume` from
    :func:`prepare_gather_volume`; on the CPU, that or the float32 volume
    zero-padded by 16, (X', Y', Z') or (S, X', Y', Z'). ``centers``: int32
    (N, 3), or (N, 4) for a stack, in original coordinates, on the same
    device; the caller keeps them inside the volume. CPU tensors take the
    plain version; CUDA tensors launch the kernel, which takes 32x32
    windows only, as the TPU kernel did: another ``patch`` takes the plain
    version on the card, from ``volume.padded()``, and launches nothing
    (:func:`takes_kernel`).
    """
    if isinstance(volume, GatherVolume):
        _check_prepared(volume, centers)
    else:
        _check_padded(volume, centers)
    if volume.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no gather for device {volume.device}")
    if not takes_kernel(volume.device, patch):
        padded = (volume.padded() if isinstance(volume, GatherVolume)
                  else volume)
        if padded.dim() == 3:
            return gather_triplanar(padded, centers, patch)
        return gather_triplanar_subjects(padded, centers, patch)
    if not isinstance(volume, GatherVolume):
        raise ValueError("on the card the kernel reads the layouts of "
                         "prepare_gather_volume(padded), not the padded "
                         "tensor")
    n = int(centers.shape[0])
    if n >= 2 ** 31:
        raise ValueError(f"{n} centers exceed one launch")
    outs = tuple(torch.empty((n, PATCH, PATCH), dtype=torch.float32,
                             device=volume.device) for _ in range(3))
    if n == 0:
        return outs
    lib = _library()
    s, xp, yp, zp = volume.shape
    with torch.cuda.device(volume.device):
        stream = torch.cuda.current_stream(volume.device).cuda_stream
        err = lib.gather_triplanar_f32(
            volume.xyz.data_ptr(), volume.zxy.data_ptr(), s, xp, yp, zp,
            _round_up(yp), _round_up(zp), centers.data_ptr(),
            int(centers.shape[1]), n, outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), stream)
    if err != 0:
        msg = lib.gather_triplanar_error_string(err).decode()
        raise RuntimeError(f"gather_triplanar launch failed: error {err} "
                           f"({msg})")
    count_launch(_add_launches)
    return outs
