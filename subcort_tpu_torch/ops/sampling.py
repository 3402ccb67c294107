"""Voxel-coordinate sampling with an explicit, reproducible PRNG.

A copy of subcort_tpu/ops/sampling.py, because ``subcort_tpu.ops``
imports jax. Every function draws from the ``numpy.random.Generator`` it
is given, with the same calls in the same order as the original, so one
seed gives both packages the same training set. The reference's sampler
(base.py:310-331) used an unseeded ``random.shuffle``; ``rng=None`` keeps
that non-determinism.
"""

from __future__ import annotations

import numpy as np


def get_mask_voxels(mask: np.ndarray, size: int | None = None,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Coordinates of nonzero voxels as an (N, 3) int32 array, in
    ``np.nonzero`` (C) order, matching the reference (base.py:310-331).
    With ``size``, the list is shuffled and truncated: the reference's
    balanced sampling primitive (base.py:327-329)."""
    idx = np.stack(np.nonzero(mask), axis=1).astype(np.int32)
    if size is not None:
        if rng is None:
            rng = np.random.default_rng()
        perm = rng.permutation(idx.shape[0])
        idx = idx[perm[:size]]
    return idx


def balanced_negative_sample(labels: np.ndarray, n_positives: int,
                             neg_class: int = 15,
                             rng: np.random.Generator | None = None) -> np.ndarray:
    """``n_positives`` boundary-background voxels (class ``neg_class``):
    the reference's ``balance_neg`` path (base.py:163-166)."""
    return get_mask_voxels(labels == neg_class, size=n_positives, rng=rng)


def shuffle_consistent(arrays, rng: np.random.Generator):
    """One permutation applied to every array (same length each), in place
    of the reference's same-seed ``np.random.permutation`` x5
    (base.py:92-103)."""
    n = len(arrays[0])
    for a in arrays:
        if len(a) != n:
            raise ValueError("arrays must share leading dimension")
    perm = rng.permutation(n)
    return [np.asarray(a)[perm] for a in arrays]
