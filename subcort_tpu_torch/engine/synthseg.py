"""Whole-scan inference by SynthSeg's 3D U-Net (the whole-volume path).

:func:`segment_synthseg` takes a raw T1 and a
:class:`~subcort_tpu_torch.models.synthseg.SynthSegUNet` and returns the
port's 15-class labels at the input's geometry, after SynthSeg's
``predict.py`` (Billot et al., Medical Image Analysis 86, 2023;
github.com/BBillot/SynthSeg). It needs no atlas, registration, candidates
or prior rows. Everything runs on the device, with TF32 off:

1. **Input.** Only 1 mm isotropic inputs of at most 256 a side are taken
   (:func:`~subcort_tpu_torch.engine.views.check_conformable`); nothing is
   resampled or reoriented, and axis 0 is taken as right-left.
2. **Normalisation** (:func:`normalize`): the raw volume goes up once, is
   clipped to its 0.5 and 99.5 percentiles and mapped to [0, 1] in
   float64, then cast to float32. A percentile is NumPy's default: rank
   ``q (n - 1)`` between two order statistics ``a <= b`` at fraction
   ``t``, ``a + (b - a) t`` below ``t = 0.5`` and ``b - (b - a) (1 - t)``
   from it, read from the sorted volume as the views path's conform reads
   its quantile (:func:`~subcort_tpu_torch.engine.views.order_statistics`).
3. **Padding**: zeros around the volume, centrally, up to multiples of
   ``2 ** levels`` (32 at the published widths).
4. **Two forwards** (:data:`PASSES`): the volume, and the volume flipped
   along axis 0, whose softmax is flipped back and its left/right channels
   swapped (:data:`LR_PAIRS`); ``P = (softmax_1 + softmax_2) / 2``, laid
   out (classes, X, Y, Z).
5. **Post-process** (``predict.py::postprocess``, not ``--fast``), on the
   padded volume, 6-connected: the non-background posteriors zeroed
   outside the largest component of ``sum_{k >= 1} P_k > 0.25``; then for
   each topological class, its channels zeroed outside the largest
   component of the union of their ``P_k > 0.25`` masks; then ``P``
   divided by its sum over the classes. The largest components come from
   the component filter kernel (``ops/connected.py::filter_components``,
   ``csrc/filter_components.cu``, its uint8 entry point) in two launches:
   the brain mask, then every class's mask at once, stacked along axis 0
   with the class's number as its label (classes never merge, and a
   mask that touches no atlas keeps its largest component, the first in
   raster order at a tie, as SynthSeg's ``np.argmax`` over scipy's
   component sizes does).
6. **Labels**: ``structure_of[argmax P]`` over the 33 classes, cropped to
   the input's shape and read back once. With ``post_process=False`` step
   5 is skipped: the argmax of the flip-averaged ``P``.

:data:`LABELS` (SynthSeg's 33 FreeSurfer labels, ascending), the
topological classes (each non-background label its own) and the
left/right pairs are this module's assumptions: SynthSeg's label and
topology tables are not in the repository. The port's classes 1-14 are
FreeSurfer's 10, 11, 12, 13, 17, 18, 26, 49, 50, 51, 52, 53, 54, 58
(:data:`~subcort_tpu_torch.engine.views.STRUCTURE_LABELS`).

The call is one ``synthseg.segment`` span, with ``synthseg.upload``
(``bytes``), ``synthseg.normalize`` (``voxels``: sort, percentiles, clip,
map, padding), one ``synthseg.forward`` a pass (``flipped``, ``voxels``:
the enqueue of the net and its softmax), ``synthseg.posteriors`` (flip
back, swap, average), ``synthseg.topology`` (``classes``, ``launches``),
``synthseg.labels`` (renormalisation, argmax, table, crop) and
``synthseg.readback`` (``bytes``: the wait for the device and the copy)
under it. :data:`FORWARDS` counts the forwards run.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from subcort_tpu_torch.config import exact_float32, resolve_device
from subcort_tpu_torch.engine.views import (STRUCTURE_LABELS,
                                            check_conformable,
                                            order_statistics)
from subcort_tpu_torch.ops.connected import filter_components
from subcort_tpu_torch.utils.runtime import span

# SynthSeg's segmentation labels, ascending: background, 14 left and 14
# right structures, 4 midline ones
LABELS = (0, 2, 3, 4, 5, 7, 8, 10, 11, 12, 13, 14, 15, 16, 17, 18, 24, 26,
          28, 41, 42, 43, 44, 46, 47, 49, 50, 51, 52, 53, 54, 58, 60)
LR_PAIRS = ((2, 41), (3, 42), (4, 43), (5, 44), (7, 46), (8, 47), (10, 49),
            (11, 50), (12, 51), (13, 52), (17, 53), (18, 54), (26, 58),
            (28, 60))
PERCENTILES = (0.5, 99.5)
THRESHOLD = 0.25
MAX_SIZE = 256
# the forwards a scan runs: whether each takes the volume flipped along
# axis 0 (flip averaging)
PASSES = (False, True)

# forwards run, over the process
FORWARDS = 0
_COUNT_LOCK = threading.Lock()


def _add_forwards(n: int) -> None:
    global FORWARDS
    with _COUNT_LOCK:
        FORWARDS += n


def structure_of(labels: Sequence[int] = LABELS) -> tuple:
    """The port's class (1-14, else 0) of each FreeSurfer label."""
    return tuple(STRUCTURE_LABELS.index(lab) + 1
                 if lab in STRUCTURE_LABELS else 0 for lab in labels)


def lr_permutation(labels: Sequence[int] = LABELS) -> tuple:
    """Channel ``i`` of a flipped forward's output holds the class of
    ``labels[perm[i]]``'s mirror: each label's left/right partner, or the
    label itself (the background, midline structures, a partner not in
    ``labels``)."""
    partner = dict(LR_PAIRS)
    partner.update((b, a) for a, b in LR_PAIRS)
    labels = list(labels)
    return tuple(labels.index(partner[lab])
                 if partner.get(lab) in labels else i
                 for i, lab in enumerate(labels))


def percentile_range(flat_sorted: torch.Tensor) -> tuple:
    """(lo, hi) in float64 of an ascending flat volume: its
    :data:`PERCENTILES` by NumPy's default interpolation (one read-back)."""
    out = []
    for a, b, t in order_statistics(flat_sorted,
                                    [p / 100 for p in PERCENTILES]):
        d = b - a
        out.append(a + d * t if t < 0.5 else b - d * (1 - t))
    return tuple(out)


def normalize(raw: torch.Tensor) -> torch.Tensor:
    """``raw`` clipped to its percentile range and mapped to [0, 1] in
    float64 (zeros where the range is empty), as float32 on its device."""
    lo, hi = percentile_range(torch.sort(raw.reshape(-1)).values)
    v = raw.double().clamp_(lo, hi)
    if hi > lo:
        v.sub_(lo).div_(hi - lo)
    else:
        v.zero_()
    return v.float()


def pad(volume: torch.Tensor, multiple: int):
    """``volume`` zero-padded centrally to multiples of ``multiple`` a
    side, and the offsets at which it sits in the result."""
    return pad_to(volume, tuple(-(-s // multiple) * multiple
                                for s in volume.shape))


def pad_to(volume: torch.Tensor, shape):
    """``volume`` zero-padded centrally to ``shape`` (no side less than
    its own; an odd extra voxel at the end), and the offsets at which it
    sits in the result."""
    offsets = tuple((p - s) // 2 for p, s in zip(shape, volume.shape))
    out = volume.new_zeros(shape)
    out[tuple(slice(o, o + s) for o, s in zip(offsets, volume.shape))] = \
        volume
    return out, offsets


def _small(values, device: torch.device, dtype=torch.int64) -> torch.Tensor:
    """A few host numbers on ``device`` without waiting for its queue: a
    pageable copy to a card would wait for the work enqueued before it."""
    t = torch.tensor(list(values), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _softmax(net, x: torch.Tensor) -> torch.Tensor:
    """(classes, X, Y, Z) softmax of one forward of (1, 1, X, Y, Z)."""
    return torch.softmax(net(x), 1)[0]


def _swap_lr(soft: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """A flipped forward's channels put back in label order."""
    return soft.index_select(0, perm)


def _posteriors(net, image: np.ndarray, device: torch.device,
                labels: Sequence[int]):
    """(P, offsets): the flip-averaged ``P`` of the padded volume, spans of
    the call open on this thread."""
    with span("synthseg.upload", bytes=image.nbytes):
        raw = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    with span("synthseg.normalize", voxels=image.size):
        x, offsets = pad(normalize(raw), 2 ** net.spec.levels)
        del raw
        x = x[None, None]
    perm = _small(lr_permutation(labels), device)
    softs = []
    for flipped in PASSES:
        with span("synthseg.forward", flipped=int(flipped),
                  voxels=x.numel()):
            softs.append(_softmax(net, torch.flip(x, (2,)) if flipped
                                  else x))
            _add_forwards(1)
    del x
    with span("synthseg.posteriors"):
        prob = None
        for flipped in PASSES:
            soft = softs.pop(0)
            if flipped:
                soft = _swap_lr(torch.flip(soft, (1,)), perm)
            prob = soft if prob is None else prob.add_(soft)
            del soft
        prob.mul_(1.0 / len(PASSES))
    return prob, offsets


def _prepare(net, image, zooms, device):
    image = np.asarray(image)
    check_conformable(image.shape, zooms, MAX_SIZE, "SynthSeg's path")
    device = resolve_device(device)
    on = next(net.parameters()).device
    if on != device:
        raise ValueError(f"the net is on {on}, the call asks for {device}")
    return image, device


def flip_averaged_posteriors(net, image: np.ndarray, zooms, device=None,
                             labels: Optional[Sequence[int]] = None):
    """(P, offsets): the flip-averaged posteriors (classes x the padded
    volume, float32, on ``device``; ``None``: the card) of one raw T1 by
    ``net``, steps 1-4 of the module docstring, and the offsets of the
    input in the padded volume. Nothing is read back."""
    image, device = _prepare(net, image, zooms, device)
    with torch.no_grad(), exact_float32():
        return _posteriors(net, image, device,
                           LABELS if labels is None else labels)


def keep_largest(prob: torch.Tensor) -> int:
    """In place on ``P`` (classes, X, Y, Z): step 5's component steps (the
    brain mask, then each non-background channel as its own topological
    class). Returns the filter's launches."""
    spatial = tuple(prob.shape[1:])
    n = prob.shape[0] - 1
    dev = prob.device
    zeros = torch.zeros((max(n, 1) * spatial[0],) + spatial[1:],
                        dtype=torch.uint8, device=dev)
    fg = prob[1:]
    brain = (fg.sum(0) > THRESHOLD).to(torch.uint8)
    fg.mul_(filter_components(brain, zeros[:spatial[0]], 2))
    if not n:
        return 1
    numbers = torch.arange(1, n + 1, dtype=torch.uint8, device=dev)
    stacked = (fg > THRESHOLD).to(torch.uint8).mul_(numbers.view(-1, 1, 1, 1))
    kept = filter_components(stacked.view((-1,) + spatial[1:]), zeros,
                             n + 1).view(stacked.shape) != 0
    del stacked
    fg.mul_(kept)
    return 2


def segment_synthseg(net, image: np.ndarray, zooms, device=None,
                     labels: Optional[Sequence[int]] = None,
                     post_process: bool = True, request=None) -> np.ndarray:
    """The port's 15-class labels (uint8, ``image``'s shape) of one raw T1
    by ``net`` (the module docstring says how). ``device`` is where it runs
    (``None``: the card), the net's; ``labels`` the FreeSurfer label of
    each output channel (None: :data:`LABELS`); ``post_process`` runs step
    5; ``request`` names the call's spans
    (None: the span open on this thread's, else a fresh one)."""
    image, device = _prepare(net, image, zooms, device)
    labels = LABELS if labels is None else tuple(labels)
    if len(labels) != net.spec.num_classes:
        raise ValueError(f"{len(labels)} labels for a net of "
                         f"{net.spec.num_classes} classes")
    table = _small(structure_of(labels), device, torch.uint8)
    with span("synthseg.segment", request), torch.no_grad(), exact_float32():
        prob, offsets = _posteriors(net, image, device, labels)
        if post_process:
            n = len(labels) - 1
            with span("synthseg.topology", classes=n, launches=1 + (n > 0)):
                keep_largest(prob)
        with span("synthseg.labels"):
            if post_process:
                prob.div_(prob.sum(0))
            crop = tuple(slice(o, o + s)
                         for o, s in zip(offsets, image.shape))
            out = table[prob.argmax(0)[crop]]
            del prob
        with span("synthseg.readback", bytes=out.numel()):
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                torch.cuda.current_stream(device).synchronize()
                return host.numpy()
            return out.numpy().copy()
