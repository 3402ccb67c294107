"""Device selection for the PyTorch port.

The configuration contract itself (``configuration.cfg``, :class:`Options`,
:func:`load_options`) is shared with the JAX package: ``subcort_tpu.config``
imports no jax, so the port reads the very same typed options. What differs
is the backend mapping of the reference's ``mode`` key
(load_options.py:54-57): the JAX package maps it onto ``JAX_PLATFORMS``
(``subcort_tpu/config.py::select_platform``); here it becomes an explicit
``torch.device`` that callers pass down.
"""

from __future__ import annotations

import contextlib
import re

import torch

from subcort_tpu.config import Options, load_options  # noqa: F401


def not_ported(feature: str, item: str) -> NotImplementedError:
    """The error every option outside the ported slice raises, naming the
    ROADMAP.md queue-A item that will bring it. Options are never rerouted
    silently to something that is ported."""
    return NotImplementedError(
        f"{feature} is not ported to subcort_tpu_torch yet "
        f"(ROADMAP.md, queue A: {item})")


def select_device(options: Options) -> torch.device:
    """Map ``mode`` to a ``torch.device``.

    ``cpu*`` -> CPU; ``cudaN`` / ``gpuN`` -> ``cuda:N``; ``gpu``, ``tpu`` and
    anything else -> ``cuda:0``. A CUDA device that is asked for and absent
    raises: the port never falls back to the CPU. The TF32 flags are left
    alone: ``segment_volume`` turns TF32 off for its own device work
    (:func:`exact_float32`).
    """
    mode = str(options.mode).strip().lower()
    if mode.startswith("cpu"):
        return torch.device("cpu")
    m = re.fullmatch(r"(?:cuda|gpu)(\d*)", mode)
    index = int(m.group(1)) if m and m.group(1) else 0
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"mode={options.mode!r} asks for a CUDA device, but torch sees "
            "none (set mode = cpu to run on the CPU)")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"mode={options.mode!r} asks for cuda:{index}, but only "
            f"{torch.cuda.device_count()} CUDA device(s) are present")
    return torch.device("cuda", index)


@contextlib.contextmanager
def exact_float32():
    """Full float32 convolutions and matmuls (TF32 off) inside the block;
    the caller's flags come back afterwards.

    cuDNN runs float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32 = True``), a 10-bit mantissa, while
    the reference's exact path is full float32
    (subcort_tpu/models/triplanar.py ``Precision.HIGHEST``).
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
