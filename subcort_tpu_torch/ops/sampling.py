"""Voxel-coordinate enumeration (copy of the inference half of
subcort_tpu/ops/sampling.py::get_mask_voxels; the shuffled/truncated form
and the training samplers come with the training slice). A copy because
``subcort_tpu.ops`` imports jax."""

from __future__ import annotations

import numpy as np


def get_mask_voxels(mask: np.ndarray) -> np.ndarray:
    """Coordinates of nonzero voxels as an (N, 3) int32 array, in
    ``np.nonzero`` (C) order, matching the reference (base.py:310-331)."""
    return np.stack(np.nonzero(mask), axis=1).astype(np.int32)
