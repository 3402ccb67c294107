"""Plain reference of the post-process (the reference's base.py:460-480):
for each structure class 1..14, label the 6-connected components of its
voxels and keep the one that overlaps the atlas ROI most; where none
overlaps, the largest. Everything else becomes 0."""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def keep_components(labels: np.ndarray, roi: np.ndarray,
                    num_classes: int = 15) -> np.ndarray:
    roi = np.asarray(roi) != 0
    out = np.zeros_like(labels)
    for c in range(1, num_classes):
        mask = labels == c
        comp, n = ndimage.label(mask)
        if n == 0:
            continue
        overlap = np.bincount(comp[mask & roi], minlength=n + 1)[1:]
        if overlap.max() > 0:
            keep = int(np.argmax(overlap)) + 1
        else:
            keep = int(np.argmax(np.bincount(comp[mask],
                                             minlength=n + 1)[1:])) + 1
        out[comp == keep] = c
    return out
