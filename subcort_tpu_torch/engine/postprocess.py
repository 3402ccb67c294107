"""Post-processing: per-class connected-component filtering against the
registered atlas mask.

Copy of the scipy path of subcort_tpu/engine/postprocess.py (and of
``label_components_np``, subcort_tpu/ops/connected.py:38); copied because
those modules import jax. Reference: base.py:460-480. For each structure
class 1..14, label the connected components of the predicted mask and keep
only the component with the largest overlap with the binary subcortical
atlas mask. ``bugcompat_argmax=True`` reproduces the reference's argmax
over components including background component 0 (SURVEY.md §2.3-7).

``cc_backend="device"`` (on-device min-label propagation) is not ported
yet and raises.
"""

from __future__ import annotations

import os

import numpy as np
from scipy import ndimage

from subcort_tpu_torch.config import not_ported
from subcort_tpu_torch.io import load_nii


def label_components_np(mask: np.ndarray):
    """scipy 6-connectivity labeling: (labels int32, num)."""
    labels, num = ndimage.label(mask)
    return labels.astype(np.int32), int(num)


def _filter_components(input_mask: np.ndarray, atlas_mask: np.ndarray,
                       num_classes: int) -> np.ndarray:
    filtered = np.zeros_like(input_mask)
    for l in range(1, num_classes):
        th = input_mask == l
        labels, num = label_components_np(th)
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
                              cc_backend: str = "scipy") -> np.ndarray:
    """Filter a predicted label volume; returns a new volume.

    ``atlas_mask`` may be passed directly; otherwise it is read from
    ``<image_folder>/tmp/MNI_subcortical_mask.nii.gz`` (base.py:465).
    """
    if cc_backend == "device":
        raise not_ported("cc_backend='device' (on-device connected "
                         "components)", "item 8, device CC")
    if cc_backend != "scipy":
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
    full[sl] = _filter_components(input_mask[sl], atlas_mask[sl], num_classes)
    return full
