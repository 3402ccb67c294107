"""Whole-scan inference by SwinUNETR over overlapping windows (the
sliding-window path).

:func:`segment_swinunetr` takes a raw T1 and a
:class:`~subcort_tpu_torch.models.swinunetr.SwinUNETR` and returns the
port's 15-class labels at the input's shape, as MONAI's
``sliding_window_inference`` runs the net in the BRATS21 scripts of
``Project-MONAI/research-contributions`` (``SwinUNETR/BRATS21``: roi 128,
overlap 0.5, ``sw_batch_size`` 4, Gaussian blending). It needs no atlas,
registration, candidates or prior rows. Everything runs on the device,
with TF32 off:

1. **Input.** Only 1 mm isotropic inputs of at most 256 a side are taken
   (:func:`~subcort_tpu_torch.engine.views.check_conformable`); nothing is
   resampled or reoriented.
2. **Normalisation** (:func:`normalize`, MONAI's ``NormalizeIntensityd(
   nonzero=True, channel_wise=True)``): the nonzero voxels less their mean,
   over their population standard deviation (1 where that is 0), in
   float64, then float32; zero voxels stay zero.
3. **Padding**: a side under the window's (128) is zero-padded centrally
   to it (the extra voxel at the end), as MONAI pads; no other side is.
4. **Windows** (:func:`window_starts`): along each axis of side ``s``,
   starts ``min(i * step, s - roi)`` for ``i < ceil((s - roi) / step) +
   1``, ``step = int(roi * (1 - overlap))`` (MONAI's scan interval and
   ``dense_patch_slices``); the windows are the product of the axes'
   starts in raster order, run through the net ``sw_batch_size`` at a
   time. An MNI-sized scan (181 x 217 x 181) takes 2 x 3 x 2 = 12.
5. **Blend**: each window's logits weighted by :func:`gaussian` and added
   into one float32 buffer of the padded scan's size, the weights into
   another; the logits are their quotient.
6. **Labels**: the argmax over the classes, cropped to the input; with
   ``post_process`` each class's largest 6-connected component
   (``post_process_segmentation`` with a whole-volume mask), on the
   device's filter where ``cc_backend`` resolves to ``device`` (a card
   under ``auto``) and one read-back, else scipy's after the read-back.

The call is one ``swinunetr.segment`` span, with ``swinunetr.upload``
(``bytes``), ``swinunetr.normalize`` (``voxels``), per batch of windows a
``swinunetr.forward`` (``windows``, and ``encoder_ms`` and ``decoder_ms``:
milliseconds of the encoder and of the rest of the net, by CUDA events on
a card, by the host's clock elsewhere, taken only while spans record and
set once the scan's read-back has waited for the device) and a
``swinunetr.blend`` (the adds), ``swinunetr.labels`` (the argmax and
the device's ``postprocess.filter`` under it) and ``swinunetr.readback``
(``bytes``) under it; scipy's ``postprocess.filter`` follows the
read-back. :data:`WINDOWS` counts the windows run.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
import numpy as np
import torch

from subcort_tpu_torch.config import exact_float32, resolve_device
from subcort_tpu_torch.engine.postprocess import (filter_whole_volume,
                                                  post_process_segmentation,
                                                  resolve_cc_backend)
from subcort_tpu_torch.engine.synthseg import pad_to
from subcort_tpu_torch.engine.views import check_conformable
from subcort_tpu_torch.utils.runtime import span

# the BRATS21 scripts' window, overlap and windows a batch (read at each
# call; the tests cut them)
ROI = 128
OVERLAP = 0.5
SW_BATCH_SIZE = 4
SIGMA_SCALE = 0.125
MIN_WEIGHT = 1e-3
MAX_SIZE = 256

# windows run through the net, over the process
WINDOWS = 0
_COUNT_LOCK = threading.Lock()


def _add_windows(n: int) -> None:
    global WINDOWS
    with _COUNT_LOCK:
        WINDOWS += n


def axis_starts(side: int, roi: int = ROI, overlap: float = OVERLAP) -> list:
    """The windows' starts along an axis of ``side`` (at least ``roi``)."""
    if side == roi:
        return [0]
    step = max(int(roi * (1 - overlap)), 1)
    count = math.ceil((side - roi) / step) + 1
    return [min(i * step, side - roi) for i in range(count)]


def window_starts(shape, roi: int = ROI, overlap: float = OVERLAP) -> list:
    """The start (x, y, z) of each window over a scan of ``shape``, each
    side padded to ``roi`` first where it is less, in the order they
    run."""
    return list(itertools.product(*(axis_starts(max(int(s), roi), roi,
                                                overlap) for s in shape)))


def gaussian(roi: int = ROI, sigma_scale: float = SIGMA_SCALE,
             device=None) -> torch.Tensor:
    """(roi, roi, roi) float32: ``prod_a exp(-(p_a - (roi - 1) / 2)^2 /
    (2 sigma^2))``, ``sigma = sigma_scale * roi``, over its maximum, at
    least :data:`MIN_WEIGHT`."""
    p = torch.arange(roi, dtype=torch.float32, device=device) - (roi - 1) / 2
    g = torch.exp(p * p / (-2 * (sigma_scale * roi) ** 2))
    w = g[:, None, None] * g[None, :, None] * g[None, None, :]
    return (w / w.max()).clamp_(min=MIN_WEIGHT)


def normalize(raw: torch.Tensor) -> torch.Tensor:
    """``raw``'s nonzero voxels less their mean over their population
    standard deviation (1 where it is 0), in float64; zeros stay; as
    float32 on its device. Nothing is read back."""
    v = raw.double()
    nz = raw != 0
    n = nz.sum()
    mean = torch.where(nz, v, 0.0).sum() / n
    dev = torch.where(nz, v - mean, 0.0)
    std = (dev.square_().sum() / n).sqrt_()
    std = torch.where(std == 0, 1.0, std)
    return torch.where(nz, (v - mean) / std, v).float()


class _Timer:
    """The encoder's and the rest's milliseconds of one batch, set on its
    span once the device has run it."""

    def __init__(self, record, device: torch.device):
        self.record = record
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def read(self) -> None:
        a, b, c = self.marks
        if self.cuda:
            enc, dec = a.elapsed_time(b), b.elapsed_time(c)
        else:
            enc, dec = 1e3 * (b - a), 1e3 * (c - b)
        self.record.set(encoder_ms=enc, decoder_ms=dec)


def _blend(net, x: torch.Tensor) -> tuple:
    """(logits, timers): the blended logits (classes, padded scan) of the
    padded volume ``x`` and the batches' timers, spans of the call open
    on this thread."""
    device = x.device
    roi = ROI
    weight = gaussian(roi, device=device)
    starts = window_starts(tuple(x.shape), roi, OVERLAP)
    acc = torch.zeros((net.spec.out_channels,) + tuple(x.shape),
                      device=device)
    total = torch.zeros(tuple(x.shape), device=device)
    timers = []
    for i in range(0, len(starts), SW_BATCH_SIZE):
        batch = starts[i:i + SW_BATCH_SIZE]
        cuts = [tuple(slice(s, s + roi) for s in start) for start in batch]
        with span("swinunetr.forward", windows=len(batch)) as record:
            timer = _Timer(record, device) if record else None
            windows = torch.stack([x[c] for c in cuts])[:, None]
            if timer:
                timer.mark()
            hidden = net.encode(windows)
            if timer:
                timer.mark()
            logits = net.decode(windows, hidden)
            del hidden, windows
            if timer:
                timer.mark()
                timers.append(timer)
            _add_windows(len(batch))
        with span("swinunetr.blend"):
            for j, c in enumerate(cuts):
                acc[(slice(None),) + c].addcmul_(logits[j], weight)
                total[c] += weight
            del logits
    return acc.div_(total), timers


def _prepare(net, image, zooms, device):
    image = np.asarray(image)
    check_conformable(image.shape, zooms, MAX_SIZE, "SwinUNETR's path")
    device = resolve_device(device)
    on = next(net.parameters()).device
    if on != device:
        raise ValueError(f"the net is on {on}, the call asks for {device}")
    return image, device


def _logits(net, image: np.ndarray, device: torch.device) -> tuple:
    """(logits cropped to the input, timers), spans open on this
    thread."""
    with span("swinunetr.upload", bytes=image.nbytes):
        raw = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    with span("swinunetr.normalize", voxels=image.size):
        x, offsets = pad_to(normalize(raw),
                            tuple(max(s, ROI) for s in image.shape))
        del raw
    logits, timers = _blend(net, x)
    crop = (slice(None),) + tuple(slice(o, o + s)
                                  for o, s in zip(offsets, image.shape))
    return logits[crop], timers


def blended_logits(net, image: np.ndarray, zooms,
                   device=None) -> torch.Tensor:
    """The blended logits (classes x ``image``'s shape, float32, on
    ``device``; ``None``: the card) of one raw T1 by ``net``, steps 1-5
    of the module docstring. Nothing is read back."""
    image, device = _prepare(net, image, zooms, device)
    with torch.no_grad(), exact_float32():
        return _logits(net, image, device)[0]


def _read_back(labels: torch.Tensor) -> np.ndarray:
    with span("swinunetr.readback", bytes=labels.numel()):
        if labels.is_cuda:
            host = torch.empty(labels.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(labels, non_blocking=True)
            torch.cuda.current_stream(labels.device).synchronize()
            return host.numpy()
        return labels.numpy().copy()


def segment_swinunetr(net, image: np.ndarray, zooms, device=None,
                      request=None, *, post_process: bool = True,
                      cc_backend: str = "auto") -> np.ndarray:
    """The port's 15-class labels (uint8, ``image``'s shape) of one raw T1
    by ``net`` (the module docstring says how). ``device`` is where it
    runs (``None``: the card), the net's; ``request`` names the call's
    spans (None: the span open on this thread's, else a fresh one);
    ``post_process`` keeps each class's largest component, where
    ``cc_backend`` says."""
    image, device = _prepare(net, image, zooms, device)
    classes = net.spec.out_channels
    on_device = post_process and resolve_cc_backend(
        cc_backend, device, classes) == "device"
    with span("swinunetr.segment", request), torch.no_grad(), \
            exact_float32():
        logits, timers = _logits(net, image, device)
        with span("swinunetr.labels"):
            labels = logits.argmax(0).to(torch.uint8)
            del logits
            if on_device:
                labels = filter_whole_volume(labels, classes)
        out = _read_back(labels)
        for timer in timers:
            timer.read()
        if post_process and not on_device:
            out = post_process_segmentation(
                None, out, atlas_mask=np.ones(out.shape, bool),
                num_classes=classes, cc_backend="scipy")
        return out
