"""Intensity normalization (copy of subcort_tpu/ops/normalize.py).

A copy rather than an import: importing ``subcort_tpu.ops`` pulls in jax
through the package ``__init__``, and the port runs where jax is absent.

Reference semantics (train: base.py:146; inference: base.py:358): subtract
the mean and divide by the std of the *nonzero* voxels, statistics in
float64.
"""

from __future__ import annotations

import numpy as np


def normalize_stats(vol: np.ndarray):
    """(mean, std) over the NONZERO voxels, float64 (base.py:146 semantics).

    Zero voxels contribute nothing to sum/sum-of-squares, so the nonzero
    statistics come from whole-volume float64 reductions plus a nonzero
    count — a single pass with no boolean-mask materialization.
    """
    vol = np.asarray(vol)
    cnt = np.count_nonzero(vol)
    flat = vol.reshape(-1)
    s1 = float(flat.sum(dtype=np.float64))
    s2 = float(np.einsum("i,i->", flat, flat, dtype=np.float64))
    return stats_from_moments(cnt, s1, s2)


def stats_from_moments(count: int, total: float, squares: float):
    """(mean, std) from the nonzero count and the float64 sums of the
    values and of their squares: :func:`normalize_stats`' arithmetic and
    errors, which the device's integer moments share
    (``engine/infer.py``)."""
    if count == 0:
        raise ValueError("volume is identically zero; cannot normalize")
    mean = total / count
    var = squares / count - mean * mean
    if var <= 0.0:
        raise ValueError("nonzero voxels have zero variance; cannot normalize")
    return mean, float(np.sqrt(var))


def normalize_nonzero(vol: np.ndarray, dtype=np.float32):
    """(vol - mean(vol[vol!=0])) / std(vol[vol!=0]), stats in float64.

    Returns (normalized volume as ``dtype``, mean, std). Zero voxels are
    *included* in the output (they become ``-mean/std``), exactly as the
    reference does — only the statistics are restricted to nonzero voxels.
    """
    vol = np.asarray(vol)
    mean, std = normalize_stats(vol)
    out = (vol.astype(dtype) - dtype(mean)) * dtype(1.0 / std)
    return out, mean, std
