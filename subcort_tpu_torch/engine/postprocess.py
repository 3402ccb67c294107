"""Post-processing: per-class connected-component filtering against the
registered atlas mask.

Copy of subcort_tpu/engine/postprocess.py; copied because that module
imports jax. Reference: base.py:460-480. For each structure class 1..14,
label the connected components of the predicted mask and keep only the
component with the largest overlap with the binary subcortical atlas mask.
``bugcompat_argmax=True`` reproduces the reference's argmax over
components including background component 0 (SURVEY.md §2.3-7).

``cc_backend`` picks where the filter runs (:func:`resolve_cc_backend`):
``"scipy"`` (the host's per-class loop), ``"device"`` (every class at once
on ``device``: the CUDA kernel on a card, its plain version on the CPU;
:func:`~subcort_tpu_torch.ops.connected.filter_components`) or ``"auto"``,
the default: ``"device"`` where that device is a card, else ``"scipy"``.
Both compute one function, so the filter keeps the same voxels. The
filter opens the span ``postprocess.filter`` (attributes ``voxels``, the
foreground crop's, and ``on_card``, 1 where the kernel ran).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from scipy import ndimage

from subcort_tpu_torch.config import resolve_device
from subcort_tpu_torch.io import load_nii
from subcort_tpu_torch.ops.connected import (  # noqa: F401 (re-export)
    MAX_CLASSES, filter_components, label_components_device,
    label_components_np)
from subcort_tpu_torch.ops.connected import \
    filter_components_np as _filter_components
from subcort_tpu_torch.utils.runtime import span


def resolve_cc_backend(cc_backend: str, device=None,
                       num_classes: int = 15) -> str:
    """``"scipy"`` or ``"device"`` for a ``cc_backend`` option. ``"auto"``
    is ``"device"`` where the device is a card (``device``, or, when it
    is None, the default card if one is present) and the classes fit the
    kernel's uint8 labels, else ``"scipy"``."""
    if cc_backend == "auto":
        on_card = (torch.cuda.is_available() if device is None
                   else torch.device(device).type == "cuda")
        return ("device" if on_card and num_classes <= MAX_CLASSES
                else "scipy")
    if cc_backend not in ("scipy", "device"):
        raise ValueError(f"unknown cc_backend {cc_backend!r}")
    return cc_backend


def _foreground_box(input_mask: np.ndarray):
    """The bounding box of the nonzero voxels with a 1-voxel halo (so that
    components never touch the crop's boundary), as slices; None when
    there are none. A max over the rows of the first axis gives its
    extent; the max over that extent of it, recursively, the others'."""
    if input_mask.size == 0:
        return None
    part = input_mask if input_mask.dtype.kind in "bu" else input_mask != 0
    sl = []
    for size in input_mask.shape:
        idx = np.flatnonzero(part.reshape(part.shape[0], -1).max(axis=1))
        if idx.size == 0:
            return None
        first, last = int(idx[0]), int(idx[-1])
        sl.append(slice(max(first - 1, 0), min(last + 2, size)))
        part = part[first:last + 1].max(axis=0)
    return tuple(sl)


def _filter_on_device(crop: np.ndarray, atlas_crop: np.ndarray,
                      num_classes: int, device: torch.device) -> np.ndarray:
    """:func:`filter_components` on ``device``: on a card the crop and its
    atlas go up in one pinned copy and the result comes back in one, the
    only host sync."""
    labels = (crop if crop.dtype == np.uint8 else
              np.where((crop > 0) & (crop < num_classes), crop,
                       0).astype(np.uint8))
    if device.type != "cuda":
        # from_numpy takes no negative strides, which a caller's view may have
        return filter_components(
            torch.from_numpy(np.ascontiguousarray(labels)).to(device),
            torch.from_numpy(np.ascontiguousarray(atlas_crop)).to(device),
            num_classes).cpu().numpy()
    staged = torch.empty((2,) + crop.shape, dtype=torch.uint8,
                         pin_memory=True)
    host = staged.numpy()
    host[0] = labels
    host[1] = atlas_crop
    on_card = staged.to(device, non_blocking=True)
    out = filter_components(on_card[0], on_card[1], num_classes)
    back = torch.empty(crop.shape, dtype=torch.uint8, pin_memory=True)
    back.copy_(out, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    return back.numpy()


def post_process_segmentation(image_folder: str, input_mask: np.ndarray,
                              atlas_mask: np.ndarray | None = None,
                              num_classes: int = 15,
                              bugcompat_argmax: bool = False,
                              cc_backend: str = "auto",
                              device=None) -> np.ndarray:
    """Filter a predicted label volume; returns a new volume.

    ``atlas_mask`` may be passed directly; otherwise it is read from
    ``<image_folder>/tmp/MNI_subcortical_mask.nii.gz`` (base.py:465).
    ``device`` is where ``cc_backend="device"`` filters (``None``: the
    card) and what ``"auto"`` looks at; the scipy backend ignores it.
    """
    backend = resolve_cc_backend(cc_backend, device, num_classes)
    if atlas_mask is None:
        atlas_mask = load_nii(os.path.join(
            image_folder, "tmp", "MNI_subcortical_mask.nii.gz")).data
    atlas_mask = np.asarray(atlas_mask)

    if bugcompat_argmax:
        if atlas_mask.dtype != np.bool_:
            atlas_mask = atlas_mask != 0
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

    # restrict labeling to the predicted-foreground bounding box
    full = np.zeros_like(input_mask)
    sl = _foreground_box(input_mask)
    if sl is None:
        return full
    crop, atlas_crop = input_mask[sl], atlas_mask[sl]
    if atlas_crop.dtype != np.bool_:
        atlas_crop = atlas_crop != 0
    dev = resolve_device(device) if backend == "device" else None
    with span("postprocess.filter", voxels=int(crop.size),
              on_card=int(dev is not None and dev.type == "cuda")):
        if dev is None:
            full[sl] = _filter_components(crop, atlas_crop, num_classes)
        else:
            full[sl] = _filter_on_device(crop, atlas_crop, num_classes, dev)
    return full


def filter_whole_volume(labels: torch.Tensor,
                        num_classes: int = 15) -> torch.Tensor:
    """:func:`post_process_segmentation` with a whole-volume atlas mask on
    ``labels``' device (a uint8 tensor): each class's largest component,
    by :func:`filter_components` over the whole volume at once, with
    nothing read back. The foreground crop the host path takes changes no
    voxel (its halo keeps every component inside it, in the same raster
    order)."""
    with span("postprocess.filter", voxels=int(labels.numel()),
              on_card=int(labels.is_cuda)):
        return filter_components(labels, torch.ones_like(labels),
                                 num_classes)
