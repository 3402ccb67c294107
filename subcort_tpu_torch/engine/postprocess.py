"""Post-processing: per-class connected-component filtering against the
registered atlas mask.

Copy of subcort_tpu/engine/postprocess.py; copied because that module
imports jax. Reference: base.py:460-480. For each structure class 1..14,
label the connected components of the predicted mask and keep only the
component with the largest overlap with the binary subcortical atlas mask.
``bugcompat_argmax=True`` reproduces the reference's argmax over
components including background component 0 (SURVEY.md §2.3-7).

``cc_backend`` picks the labeler: ``"scipy"`` (host, the default) or
``"device"`` (min-label propagation on ``device``,
:func:`~subcort_tpu_torch.ops.connected.label_components_device`). Both
give the same component sets, so the filter keeps the same voxels.
"""

from __future__ import annotations

import functools
import os

import numpy as np
from scipy import ndimage

from subcort_tpu_torch.io import load_nii
from subcort_tpu_torch.ops.connected import (  # noqa: F401 (re-export)
    label_components_device, label_components_np)


def _filter_components(input_mask: np.ndarray, atlas_mask: np.ndarray,
                       num_classes: int,
                       label_fn=label_components_np) -> np.ndarray:
    filtered = np.zeros_like(input_mask)
    for l in range(1, num_classes):
        th = input_mask == l
        labels, num = label_fn(th)
        if num == 0:
            continue
        overlap_counts = np.bincount(
            labels[np.logical_and(th, atlas_mask)], minlength=num + 1)[1:]
        if overlap_counts.max(initial=0) > 0:
            winner = int(np.argmax(overlap_counts)) + 1
        else:
            # no component touches the atlas: keep the largest by size
            sizes = np.bincount(labels[th], minlength=num + 1)[1:]
            winner = int(np.argmax(sizes)) + 1
        filtered[labels == winner] = l
    return filtered


def post_process_segmentation(image_folder: str, input_mask: np.ndarray,
                              atlas_mask: np.ndarray | None = None,
                              num_classes: int = 15,
                              bugcompat_argmax: bool = False,
                              cc_backend: str = "scipy",
                              device=None) -> np.ndarray:
    """Filter a predicted label volume; returns a new volume.

    ``atlas_mask`` may be passed directly; otherwise it is read from
    ``<image_folder>/tmp/MNI_subcortical_mask.nii.gz`` (base.py:465).
    ``device`` is where ``cc_backend="device"`` labels (``None``: the
    card); the scipy backend ignores it.
    """
    if cc_backend == "device":
        label_fn = functools.partial(label_components_device, device=device)
    elif cc_backend == "scipy":
        label_fn = label_components_np
    else:
        raise ValueError(f"unknown cc_backend {cc_backend!r}")
    if atlas_mask is None:
        atlas_mask = load_nii(os.path.join(
            image_folder, "tmp", "MNI_subcortical_mask.nii.gz")).data
    atlas_mask = np.asarray(atlas_mask)
    if atlas_mask.dtype != np.bool_:
        atlas_mask = atlas_mask != 0

    if bugcompat_argmax:
        # reference scoring: per labeled region (INCLUDING region 0), the
        # count of voxels in th & atlas; argmax over all regions — must see
        # the full volume (the bug paints the background region).
        filtered = np.zeros_like(input_mask)
        for l in range(1, num_classes):
            th = input_mask == l
            labels, _ = ndimage.label(th)
            label_list = np.unique(labels)
            overlap = np.logical_and(th, atlas_mask)
            scores = ndimage.labeled_comprehension(
                overlap, labels, label_list, np.sum, float, 0)
            winner = label_list[int(np.argmax(scores))]
            filtered[labels == winner] = l
        return filtered

    # restrict labeling to the predicted-foreground bounding box (+1 halo so
    # components never touch the crop boundary)
    full = np.zeros_like(input_mask)
    sl = []
    for ax in range(input_mask.ndim):
        other = tuple(j for j in range(input_mask.ndim) if j != ax)
        idx = np.flatnonzero(input_mask.any(axis=other))
        if idx.size == 0:
            return full
        sl.append(slice(max(int(idx[0]) - 1, 0),
                        min(int(idx[-1]) + 2, input_mask.shape[ax])))
    sl = tuple(sl)
    full[sl] = _filter_components(input_mask[sl], atlas_mask[sl], num_classes,
                                  label_fn=label_fn)
    return full
