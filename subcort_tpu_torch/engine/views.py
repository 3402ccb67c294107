"""Whole-scan inference by FastSurferCNN's three views (the multi-view path).

:func:`segment_views` takes a raw T1 and three
:class:`~subcort_tpu_torch.models.fastsurfer.FastSurferCNN` networks
(:class:`~subcort_tpu_torch.models.fastsurfer.FastSurferViews`) and
returns the port's 15-class labels at the input's geometry. It needs no
atlas, registration, candidates or prior rows. On the device:

1. **Conform.** Only 1 mm isotropic inputs with every axis at most 256
   (``size``) are taken; anything else raises (no resampling and no
   reorientation, where FastSurfer's ``conform.py`` would resample). The
   raw volume goes up once and is mapped linearly to uint8 from
   ``[min, q]`` to ``[0, 255]``, rounded half to even and clipped, ``q``
   the 0.999 quantile interpolated linearly between order statistics
   (``a + (b - a) t`` at rank ``0.999 (n - 1)``, in float64): the rule of
   FastSurfer's ``getscale`` / ``scalecrop``, as assumed here. It is
   padded centrally with zeros into ``size``^3; the network input is
   ``uint8 / 255`` in float32.
2. **Thick slices** per view on the device: the volume padded by 3 along
   the view's axis by edge replication, slice ``i`` taking slices ``i - 3
   .. i + 3`` as its 7 channels. Axial fixes axis 2, coronal axis 1,
   sagittal axis 0 (the port's convention); in-plane ``(H, W)`` are the
   other two axes in increasing order.
3. **Forward** each view over all ``size`` slices in batches of ``batch``,
   accumulating ``P = 0.4 softmax(axial) + 0.4 softmax(coronal) + 0.2
   softmax(sagittal)[..., sagittal_to_full]`` into one ``size^3 x 79``
   float32 buffer.
4. **Labels**: ``structure_of[argmax P]``, cropped back to the input's
   shape and read back once.

``sagittal_to_full`` (79 indices into the sagittal network's 51 classes)
and ``structure_of`` (79 entries: the port's class 1-14, else 0) default
to :data:`SAGITTAL_TO_FULL` and :data:`STRUCTURE_OF`, which this module
assumes: FastSurfer's own tables (``map_prediction_sagittal2full``,
``FastSurfer_ColorLUT.tsv``) are not in the repository. The 79 classes are
FreeSurfer's labels :data:`FULL_LABELS`; the port's classes 1-14 are
FreeSurfer's 10, 11, 12, 13, 17, 18, 26 (left thalamus, caudate, putamen,
pallidum, hippocampus, amygdala, accumbens) and 49, 50, 51, 52, 53, 54, 58
(the right ones).

The call is one ``views.segment`` span, with ``views.upload`` (``bytes``),
``views.conform`` (``bytes``), one ``views.forward`` per view (``view``,
its index in :data:`VIEWS`; ``slices``; ``batches``: thick slices, the
enqueue of the view's batches and of its accumulation),
``views.aggregate`` (argmax, the maps, the crop) and ``views.readback``
(``bytes``: the wait for the device and the copy) under it. :data:`SLICES`
counts the slices forwarded.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from subcort_tpu_torch.config import exact_float32
from subcort_tpu_torch.utils.runtime import span

# (name, axis the view fixes, weight of its softmax in P)
VIEWS = (("axial", 2, 0.4), ("coronal", 1, 0.4), ("sagittal", 0, 0.2))
SIZE = 256
CONTEXT = 3          # slices on each side of a thick slice
QUANTILE = 0.999
ZOOM_TOLERANCE = 1e-3

# slices forwarded through a view's network, over the process
SLICES = 0
_COUNT_LOCK = threading.Lock()

_LEFT = (2, 4, 5, 7, 8, 10, 11, 12, 13, 17, 18, 26, 28, 31)
_RIGHT = (41, 43, 44, 46, 47, 49, 50, 51, 52, 53, 54, 58, 60, 63)
_MIDLINE = (14, 15, 16, 24, 77)
_CORTEX = (1002, 1003, 1005, 1006, 1007, 1008, 1009, 1010, 1011, 1012, 1013,
           1014, 1015, 1016, 1017, 1018, 1019, 1020, 1021, 1022, 1023, 1024,
           1025, 1026, 1027, 1028, 1029, 1030, 1031, 1034, 1035)
_CORTEX_RIGHT = (2002, 2005, 2010, 2012, 2013, 2014, 2016, 2017, 2021, 2022,
                 2023, 2024, 2025, 2028)
# FreeSurfer labels of the 79 classes and of the sagittal network's 51
FULL_LABELS = tuple(sorted((0,) + _LEFT + _RIGHT + _MIDLINE + _CORTEX
                           + _CORTEX_RIGHT))
SAGITTAL_LABELS = tuple(sorted((0,) + _LEFT + _MIDLINE + _CORTEX))
_UNLATERAL = dict(zip(_RIGHT, _LEFT))
SAGITTAL_TO_FULL = tuple(
    SAGITTAL_LABELS.index(_UNLATERAL.get(lab, lab - 1000 if lab > 2000
                                         else lab))
    for lab in FULL_LABELS)
# the port's classes 1..14
STRUCTURE_LABELS = (10, 11, 12, 13, 17, 18, 26, 49, 50, 51, 52, 53, 54, 58)
STRUCTURE_OF = tuple(STRUCTURE_LABELS.index(lab) + 1
                     if lab in STRUCTURE_LABELS else 0
                     for lab in FULL_LABELS)


def _add_slices(n: int) -> None:
    global SLICES
    with _COUNT_LOCK:
        SLICES += n


def check_conformable(shape, zooms, size: int = SIZE,
                      path: str = "the multi-view path") -> None:
    """Raise ``ValueError`` unless a volume of ``shape`` and voxel sizes
    ``zooms`` (mm) is 3D, 1 mm isotropic and at most ``size`` a side;
    ``path`` names the caller in the message."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError(f"{path} takes a 3D scan, got shape {shape}")
    z = np.asarray(zooms, np.float64).reshape(-1)[:3]
    if z.size != 3 or np.abs(z - 1.0).max() > ZOOM_TOLERANCE:
        raise ValueError(f"{path} takes 1 mm isotropic voxels (no "
                         f"resampling), got {tuple(z)}")
    if max(shape) > size:
        raise ValueError(f"{path} takes at most {size} voxels a side (no "
                         f"resampling), got {shape}")


def zooms_of(affine: np.ndarray) -> np.ndarray:
    """Voxel sizes (mm) of a NIfTI affine: its columns' norms."""
    return np.sqrt((np.asarray(affine, np.float64)[:3, :3] ** 2).sum(0))


def order_statistics(flat_sorted: torch.Tensor, quantiles) -> list:
    """For each quantile ``q`` of an ascending flat volume, ``(a, b, t)``
    in float64: the order statistics at ranks ``floor(q (n - 1))`` and the
    next (the last where there is none) and the fraction ``t`` of the rank
    between them; one read-back of them all."""
    n = flat_sorted.numel()
    ranks, fractions = [], []
    for q in quantiles:
        pos = q * (n - 1)
        k = int(np.floor(pos))
        ranks += [k, min(k + 1, n - 1)]
        fractions.append(pos - k)
    picks = [float(v) for v in flat_sorted[torch.tensor(
        ranks, device=flat_sorted.device)].double().cpu()]
    return [(picks[2 * i], picks[2 * i + 1], t)
            for i, t in enumerate(fractions)]


def conform_range(flat_sorted: torch.Tensor) -> tuple:
    """(lo, hi) in float64 of an ascending flat volume: its minimum and the
    0.999 quantile, ``a + (b - a) t`` between the order statistics around
    rank ``0.999 (n - 1)`` (one read-back)."""
    (lo, _, _), (a, b, t) = order_statistics(flat_sorted, (0.0, QUANTILE))
    return lo, a + (b - a) * t


def conform(raw: torch.Tensor, size: int = SIZE):
    """The conformed ``size``^3 uint8 volume of a raw 3D volume on its
    device, and the offsets at which the input sits in it."""
    lo, hi = conform_range(torch.sort(raw.reshape(-1)).values)
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    u = ((raw.double() - lo) * scale).round_().clamp_(0, 255).to(torch.uint8)
    offsets = tuple((size - s) // 2 for s in raw.shape)
    out = torch.zeros((size,) * 3, dtype=torch.uint8, device=raw.device)
    out[tuple(slice(o, o + s) for o, s in zip(offsets, raw.shape))] = u
    return out, offsets


def view_volume(volume: torch.Tensor, axis: int) -> torch.Tensor:
    """The volume with the view's slice axis first and edge-replicated by
    :data:`CONTEXT` on both sides of it: (size + 6, H, W)."""
    rest = [a for a in range(3) if a != axis]
    v = volume.permute(axis, *rest)
    return torch.cat([v[:1].expand(CONTEXT, -1, -1), v,
                      v[-1:].expand(CONTEXT, -1, -1)]).contiguous()


def _thick_slices(padded: torch.Tensor, start: int, stop: int):
    """(stop - start, 7, H, W) thick slices ``start .. stop - 1`` of a
    :func:`view_volume`."""
    rows = (torch.arange(start, stop, device=padded.device)[:, None]
            + torch.arange(2 * CONTEXT + 1, device=padded.device)[None])
    return padded[rows]


def _accumulate(prob: torch.Tensor, soft: torch.Tensor, axis: int,
                start: int, stop: int, weight: float) -> None:
    """``prob[slices start..stop of axis] += weight * soft`` with ``soft``
    (B, 79, H, W) laid out as ``prob`` (X, Y, Z, 79)."""
    if axis == 2:
        prob[:, :, start:stop].add_(soft.permute(2, 3, 0, 1), alpha=weight)
    elif axis == 1:
        prob[:, start:stop].add_(soft.permute(2, 0, 3, 1), alpha=weight)
    else:
        prob[start:stop].add_(soft.permute(0, 2, 3, 1), alpha=weight)


def view_probabilities(nets, volume: torch.Tensor, batch: int = 16,
                       sagittal_to_full: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
    """The aggregated ``P`` (size^3 x classes, float32) of a conformed
    float32 volume on the nets' device; every view's batches enqueued,
    nothing read back."""
    table = torch.as_tensor(SAGITTAL_TO_FULL if sagittal_to_full is None
                            else sagittal_to_full, device=volume.device)
    size = volume.shape[0]
    prob = torch.zeros(tuple(volume.shape) + (len(table),),
                       dtype=torch.float32, device=volume.device)
    for i, (name, axis, weight) in enumerate(VIEWS):
        net = getattr(nets, name)
        n_batches = -(-size // batch)
        with span("views.forward", view=i, slices=size, batches=n_batches):
            padded = view_volume(volume, axis)
            for start in range(0, size, batch):
                stop = min(start + batch, size)
                soft = torch.softmax(net(_thick_slices(padded, start, stop)),
                                     dim=1)
                if name == "sagittal":
                    soft = soft.index_select(1, table)
                _accumulate(prob, soft, axis, start, stop, weight)
                _add_slices(stop - start)
            del padded, soft
    return prob


def segment_views(nets, image: np.ndarray, zooms, device=None,
                  batch: int = 16,
                  sagittal_to_full: Optional[Sequence[int]] = None,
                  structure_of: Optional[Sequence[int]] = None,
                  size: Optional[int] = None, request=None) -> np.ndarray:
    """The port's 15-class labels (uint8, ``image``'s shape) of one raw T1
    by the three view networks ``nets`` (the module docstring says how).
    ``device`` defaults to the nets'; ``request`` names the call's spans
    (None: the span open on this thread's, else a fresh one). The device
    work runs with TF32 off. ``size`` is the conformed side (None:
    :data:`SIZE`)."""
    size = SIZE if size is None else int(size)
    image = np.asarray(image)
    check_conformable(image.shape, zooms, size)
    if device is None:
        device = next(nets.parameters()).device
    device = torch.device(device)
    structure = torch.as_tensor(STRUCTURE_OF if structure_of is None
                                else structure_of, dtype=torch.uint8,
                                device=device)
    with span("views.segment", request), torch.no_grad(), exact_float32():
        with span("views.upload", bytes=image.nbytes):
            raw = torch.from_numpy(np.ascontiguousarray(image)).to(device)
        with span("views.conform", bytes=size ** 3):
            conformed, offsets = conform(raw, size)
            volume = conformed.to(torch.float32).div_(255.0)
            del raw, conformed
        prob = view_probabilities(nets, volume, batch, sagittal_to_full)
        del volume
        with span("views.aggregate"):
            crop = prob[tuple(slice(o, o + s)
                              for o, s in zip(offsets, image.shape))]
            labels = structure[crop.argmax(-1)]
            del prob, crop
        with span("views.readback", bytes=labels.numel()):
            if labels.is_cuda:
                host = torch.empty(labels.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(labels, non_blocking=True)
                torch.cuda.current_stream(device).synchronize()
                return host.numpy()
            return labels.numpy().copy()
