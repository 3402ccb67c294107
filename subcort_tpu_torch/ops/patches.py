"""Tri-planar patch gather: the plain PyTorch version, and the numpy twin.

Port of subcort_tpu/ops/patches.py (single volume, and the numpy
``gather_triplanar_np`` behind ``engine/data.py::generate_training_set``)
and subcort_tpu/engine/train.py::gather_triplanar_subjects (subject stack).
The torch functions are the plain versions of the hand-written CUDA kernel
in ``ops/gather_kernel.py``: the CPU path runs them, and the card compares
the kernel with them.

Semantics (the reference's ``get_patches``, base.py:272-308): a patch for
center ``c`` spans ``[c - 16, c + 16)`` per axis and is zero outside the
volume; axial = (x, y) plane at fixed z, coronal = (x, z) at fixed y,
sagittal = (y, z) at fixed x. With the volume zero-padded by 16 on every
side, the window for ``c`` starts at padded index ``c``. An index outside
the padded volume (a window wider than the padding) reads as jnp indexing
reads it: negative wraps once, past the end clamps.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

PATCH = 32
HALF = PATCH // 2

Patches = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def pad_volume(vol: torch.Tensor, half: int = HALF) -> torch.Tensor:
    """Zero-pad a 3D volume by ``half`` on both sides of every axis
    (padded index = original + half), contiguous."""
    return F.pad(vol, (half,) * 6).contiguous()


def _jax_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """``idx`` as jnp indexing reads it: a negative index wraps once, then
    every index is clamped into ``[0, size)``. Torch would raise past the
    end (on the card, a device-side assert)."""
    return torch.where(idx < 0, idx + size, idx).clamp_(0, size - 1)


def _windows(centers: torch.Tensor, patch: int, shape, shift: int = 0):
    c = centers.long()
    offs = torch.arange(patch, device=c.device)
    starts = c[:, -3:] + shift
    xs, ys, zs = (_jax_index(starts[:, k, None] + offs, shape[k])
                  for k in range(3))
    xc, yc, zc = (_jax_index(starts[:, k] + patch // 2, shape[k])
                  for k in range(3))
    return c, xs, ys, zs, xc, yc, zc


def gather_triplanar(padded: torch.Tensor, centers: torch.Tensor,
                     patch: int = PATCH) -> Patches:
    """(axial, coronal, sagittal), each (N, patch, patch), from a padded
    (X+2h, Y+2h, Z+2h) volume and (N, 3) centers in original coordinates."""
    _, xs, ys, zs, xc, yc, zc = _windows(centers, patch, padded.shape)
    axial = padded[xs[:, :, None], ys[:, None, :], zc[:, None, None]]
    coronal = padded[xs[:, :, None], yc[:, None, None], zs[:, None, :]]
    sagittal = padded[xc[:, None, None], ys[:, :, None], zs[:, None, :]]
    return axial, coronal, sagittal


def gather_triplanar_subjects(volumes: torch.Tensor, centers: torch.Tensor,
                              patch: int = PATCH) -> Patches:
    """Subject-stack form: ``volumes`` (S, X', Y', Z'), each subject padded
    by 16 (``HALF``, as ``build_training_index`` pads); ``centers`` (N, 4)
    rows (subject, x, y, z). The window for center ``c`` spans original
    ``[c - patch//2, c + patch - patch//2)``, so it starts at padded
    ``c + 16 - patch//2``."""
    c, xs, ys, zs, xc, yc, zc = _windows(centers, patch, volumes.shape[1:],
                                         HALF - patch // 2)
    sb = c[:, 0, None, None]
    axial = volumes[sb, xs[:, :, None], ys[:, None, :], zc[:, None, None]]
    coronal = volumes[sb, xs[:, :, None], yc[:, None, None], zs[:, None, :]]
    sagittal = volumes[sb, xc[:, None, None], ys[:, :, None], zs[:, None, :]]
    return axial, coronal, sagittal


def gather_atlas_vectors(atlas: torch.Tensor, centers: torch.Tensor,
                         bg_channel: int = 14) -> torch.Tensor:
    """Per-center prior vector with the background fix-up (base.py:388-394):
    ``atlas[x, y, z, :]`` for each (N, 3) center, and where a row sums to 0
    (outside every registered structure) the one-hot ``bg_channel`` row.
    The tensor counterpart of ``engine/infer.py::_atlas_vectors_host``
    (copy of subcort_tpu/ops/patches.py:69-82), on ``atlas``'s device."""
    c = centers.long()
    vec = atlas[c[:, 0], c[:, 1], c[:, 2], :]
    empty = vec.sum(dim=1) == 0
    onehot_bg = torch.zeros_like(vec)
    onehot_bg[:, bg_channel] = 1.0
    return torch.where(empty[:, None], onehot_bg, vec)


def gather_triplanar_np(vol: np.ndarray, centers: np.ndarray,
                        patch: int = PATCH):
    """Numpy twin of :func:`gather_triplanar` on an unpadded (X, Y, Z)
    volume, which it pads itself (copy of ops/patches.py:86-101)."""
    half = patch // 2
    padded = np.pad(vol, half)
    centers = np.asarray(centers)
    cx, cy, cz = centers[:, 0], centers[:, 1], centers[:, 2]
    offs = np.arange(patch)
    xs = cx[:, None] + offs
    ys = cy[:, None] + offs
    zs = cz[:, None] + offs
    axial = padded[xs[:, :, None], ys[:, None, :], (cz + half)[:, None, None]]
    coronal = padded[xs[:, :, None], (cy + half)[:, None, None], zs[:, None, :]]
    sagittal = padded[(cx + half)[:, None, None], ys[:, :, None], zs[:, None, :]]
    return axial, coronal, sagittal
