"""The tri-planar net's inference batch norm and PReLU as one pass.

Each of the five convolutions of each branch, in both engines, is followed
by Lasagne's inference BN, ``(x - mean) * (inv_std * gamma) + beta`` with
the stored tables, then PReLU: as PyTorch ops (``_BatchNorm.forward``,
then ``F.prelu``) four passes over the convolution's output.
:func:`bn_prelu` launches ``csrc/bn_prelu.cu`` (its header says what
bounds it and how it works), one pass that does the same operations in the
same order, rounded the same way in float32 or bfloat16, so its output
equals theirs bit for bit.

``models/triplanar.py::_Branch.bn_prelu`` is the one place either engine
runs BN and PReLU: on a card it calls :func:`bn_prelu` unless the BN takes
the batch's statistics (training) or autograd records the call, which the
kernel does not compute. :func:`bn_prelu` raises for what it cannot take.
``LAUNCHES`` counts its kernel launches, and :func:`thread_launches` this
thread's share, which the engines' span ``infer.forward`` carries as its
``bn_prelu`` attribute.

The kernel replaces no TPU kernel: the JAX package leaves these ops to
XLA, which fuses them itself.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from subcort_tpu_torch.utils.build import load_library
from subcort_tpu_torch.utils.graphs import count_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "bn_prelu.cu"

# the element types, numbered as the kernel's source numbers them
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# a launch takes fewer values than this; a larger tensor is split between
# samples, so one sample must be smaller
MAX_ELEMENTS = 2 ** 31
# the per-channel tables in shared memory, 16 B a channel: 224 KiB
MAX_CHANNELS = 14_336

LAUNCHES = 0
_LOCK = threading.Lock()
_THREAD = threading.local()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``SOURCE``."""
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.bn_prelu_launch.argtypes = [ctypes.c_int, p, p, i64, i64, i64,
                                    ctypes.POINTER(p), p]
    lib.bn_prelu_launch.restype = ctypes.c_int
    lib.bn_prelu_error_string.argtypes = [ctypes.c_int]
    lib.bn_prelu_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_once() -> ctypes.CDLL:
    return bind(load_library("bn_prelu", [SOURCE]))


def _library() -> ctypes.CDLL:
    with _LOCK:
        return _library_once()


def _add_launches(n: int) -> None:
    global LAUNCHES
    with _LOCK:
        LAUNCHES += n
    _THREAD.launches = thread_launches() + n


def thread_launches() -> int:
    """The kernel launches counted on this thread so far."""
    return getattr(_THREAD, "launches", 0)


def _refusal(x: torch.Tensor, tables) -> str:
    """What keeps the kernel from ``x`` and its five tables, or ''."""
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in tables):
        return (f"dtype: x {x.dtype}, tables "
                f"{sorted({str(t.dtype) for t in tables})}; the kernel "
                "takes float32 or bfloat16, tables of x's type")
    if x.dim() != 4 or not x.is_contiguous():
        return (f"layout: x of shape {tuple(x.shape)} and strides "
                f"{x.stride()}; the kernel takes a contiguous NCHW tensor")
    c = x.shape[1]
    if any(t.shape != (c,) or not t.is_contiguous() for t in tables):
        return (f"layout: tables of shapes {[tuple(t.shape) for t in tables]}"
                f"; the kernel takes {c} values each")
    if not 0 < c <= MAX_CHANNELS:
        return f"channels: {c}; the kernel takes 1 to {MAX_CHANNELS}"
    if c * x.shape[2] * x.shape[3] >= MAX_ELEMENTS:
        return (f"size: {c * x.shape[2] * x.shape[3]} values a sample; the "
                "kernel takes fewer than 2**31")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x,) + tables):
        return "autograd: the kernel computes no gradient"
    if x.device.type != "cuda" or any(t.device != x.device for t in tables):
        return (f"device: x on {x.device}, tables on "
                f"{sorted({str(t.device) for t in tables})}; the kernel "
                "takes one CUDA device")
    return ""


def bn_prelu(x: torch.Tensor, mean: torch.Tensor, inv_std: torch.Tensor,
             gamma: torch.Tensor, beta: torch.Tensor,
             alpha: torch.Tensor) -> torch.Tensor:
    """Lasagne's inference BN of the NCHW ``x`` with the per-channel
    tables, then PReLU with ``alpha``, as one kernel launch (a tensor of
    2**31 values or more: one a run of whole samples below that; an empty
    one: none) on the current stream of ``x``'s device, without a host
    sync: a new tensor, bit for bit ``F.prelu`` of the BN ops in ``x``'s
    dtype. Raises
    ``ValueError`` for what the kernel does not take: a dtype other than
    float32 or bfloat16 (tables of ``x``'s), a tensor that is not a
    contiguous NCHW one, tables not of its channels, more than
    ``MAX_CHANNELS`` channels, a sample of 2**31 values, a call that
    autograd records, a tensor off the card."""
    tables = (mean, inv_std, gamma, beta, alpha)
    refusal = _refusal(x, tables)
    if refusal:
        raise ValueError(f"no bn_prelu kernel for this call: {refusal}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    n, c, h, w = x.shape
    sample = c * h * w
    per = (MAX_ELEMENTS - 1) // sample
    step = per * sample * x.element_size()
    ptrs = (ctypes.c_void_p * 5)(*(t.data_ptr() for t in tables))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for k, lo in enumerate(range(0, n, per)):
            err = lib.bn_prelu_launch(
                DTYPES[x.dtype], x.data_ptr() + k * step,
                out.data_ptr() + k * step, min(per, n - lo) * sample, h * w,
                c, ptrs, stream)
            if err != 0:
                msg = lib.bn_prelu_error_string(err).decode()
                raise RuntimeError(
                    f"bn_prelu launch failed: error {err} ({msg})")
            count_launch(_add_launches)
    return out
