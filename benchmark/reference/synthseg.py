"""Plain reference of SynthSeg's 3D U-Net, its flip averaging and its
post-process.

Billot, Greve, Puonti, Thielscher, Van Leemput, Fischl, Dalca and Iglesias,
"SynthSeg: Segmentation of brain MRI scans of any contrast and resolution
without retraining", Medical Image Analysis 86 (2023) 102789;
github.com/BBillot/SynthSeg, ``SynthSeg/predict.py`` and its U-Net
(``ext/neuron`` ``unet`` through ``ext/lab2im``). Plain ``torch``
operations on a dict of state-dict leaves, NumPy and scipy, nothing of the
program and nothing of JAX:

    conv    F.conv3d, 3 x 3 x 3, zero padding 1, with its bias
    bn(x)   (x - running_mean) / sqrt(running_var + 1e-3) * weight + bias
    level   bn(elu(conv(elu(conv(x)))))          (``down<l>``, ``up<l>``)
    net     down0 .. down4, a 2 x 2 x 2 max-pool after each but the last;
            up3 .. up0 on cat[nearest x2 upsampling, the down level's
            output]; ``likelihood``, a 1 x 1 x 1 conv to the logits

``precision`` is ``"float32"`` (TF32 off for matmuls and cuDNN) or
``"tf32"``, the control: every convolution's operands rounded to TF32's
10-bit mantissa (``reference/triplanar.py::to_tf32``), products
accumulated in float32.

The scan (``posteriors``): the raw volume clipped to its 0.5 and 99.5
percentiles (``np.percentile``) and mapped to [0, 1] (``lab2im``'s
``rescale_volume``), in float64, then float32; zero-padded centrally to
multiples of ``2 ** levels``; ``P = 0.5 (softmax(net(x)) + swap(flip(
softmax(net(flip(x))))))``, the flips along axis 0 and ``swap`` putting
each left/right pair's channels back. The post-process
(``postprocess``) is ``predict.py::postprocess``'s, not ``--fast``, on the
padded volume: the non-background posteriors zeroed outside the largest
6-connected component (scipy, ``get_largest_connected_component``) of
``sum_{k >= 1} P_k > 0.25``; each topological class's channels zeroed
outside the largest component of the union of their ``P_k > 0.25``; ``P``
divided by its sum; its argmax.

Departures from SynthSeg, each the benchmark's assumption:

- no resampling to 1 mm, no alignment to RAS: 1 mm inputs are taken as
  they are, axis 0 as right-left;
- the posteriors' Gaussian smoothing (``predict``'s ``sigma_smoothing``)
  is left out;
- the tables: the 33 labels ascending, the left/right pairs and the
  topological classes (each non-background label its own) come from the
  configuration, as SynthSeg's label files are not in the repository;
- ``P`` is laid out (classes, X, Y, Z), so NumPy's sums over the classes
  run in another order than SynthSeg's over a last axis;
- the labels are mapped to the port's 15 classes (``structure_of``) and
  cropped to the input's shape.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from benchmark.reference.triplanar import full_float32, to_tf32

EPS = 1e-3
PERCENTILES = (0.5, 99.5)
THRESHOLD = 0.25


def levels_of(p: dict) -> int:
    n = 0
    while f"down{n}.conv0.weight" in p:
        n += 1
    return n


def _conv(x, p, key, precision):
    w, b = p[key + ".weight"], p[key + ".bias"]
    if precision == "tf32":
        x, w = to_tf32(x), to_tf32(w)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return F.conv3d(x, w, b, padding=w.shape[-1] // 2)


def _bn(x, p, key, calibrate=False):
    shape = (1, -1, 1, 1, 1)
    if calibrate:
        var, mean = torch.var_mean(x, (0, 2, 3, 4), correction=0)
        p[key + ".running_mean"], p[key + ".running_var"] = mean, var
    mean = p[key + ".running_mean"].view(shape)
    var = p[key + ".running_var"].view(shape)
    return ((x - mean) / torch.sqrt(var + EPS) * p[key + ".weight"].view(shape)
            + p[key + ".bias"].view(shape))


def level(p: dict, name: str, x, precision: str = "float32",
          calibrate: bool = False):
    """One level ``name`` (``down<l>`` or ``up<l>``) of the leaves ``p``;
    with ``calibrate`` its BN first takes its input's mean and biased
    variance over (N, X, Y, Z) as its running statistics (into ``p``)."""
    i = 0
    while f"{name}.conv{i}.weight" in p:
        x = F.elu(_conv(x, p, f"{name}.conv{i}", precision))
        i += 1
    return _bn(x, p, f"{name}.bn", calibrate)


def forward(p: dict, x, precision: str = "float32", calibrate: bool = False):
    """Logits (N, classes, X, Y, Z) of (N, 1, X, Y, Z) (``calibrate``:
    :func:`level`'s)."""
    levels = levels_of(p)
    skips = []
    for lv in range(levels):
        x = level(p, f"down{lv}", x, precision, calibrate)
        if lv < levels - 1:
            skips.append(x)
            x = F.max_pool3d(x, 2)
    for lv in range(levels - 2, -1, -1):
        up = F.interpolate(x, scale_factor=2, mode="nearest")
        x = level(p, f"up{lv}", torch.cat([up, skips[lv]], 1), precision,
                  calibrate)
    return _conv(x, p, "likelihood", precision)


# ------------------------------------------------------------------ the scan
def normalize(image: np.ndarray) -> np.ndarray:
    """``lab2im.edit_volumes.rescale_volume(image, 0, 1, 0.5, 99.5)`` on
    the volume in float64 (as ``nibabel``'s ``get_fdata`` loads it), as
    float32."""
    v = np.asarray(image, np.float64)
    lo = np.percentile(v, PERCENTILES[0])
    hi = np.percentile(v, PERCENTILES[1])
    clipped = np.clip(v, lo, hi)
    if lo != hi:
        out = 0.0 + (clipped - lo) / (hi - lo) * (1.0 - 0.0)
    else:
        out = np.zeros_like(clipped)
    return out.astype(np.float32)


def pad(volume: np.ndarray, multiple: int):
    """(``volume`` zero-padded centrally to multiples of ``multiple``, the
    offsets of the input in it)."""
    shape = [-(-s // multiple) * multiple for s in volume.shape]
    offsets = tuple((p - s) // 2 for p, s in zip(shape, volume.shape))
    out = np.zeros(shape, volume.dtype)
    out[tuple(slice(o, o + s) for o, s in zip(offsets, volume.shape))] = \
        volume
    return out, offsets


def lr_swap(labels, lr_pairs) -> list:
    """Index of each channel's left/right partner (itself where none)."""
    labels = list(labels)
    out = list(range(len(labels)))
    for a, b in lr_pairs:
        if a in labels and b in labels:
            out[labels.index(a)] = labels.index(b)
            out[labels.index(b)] = labels.index(a)
    return out


@torch.no_grad()
def posteriors(params: dict, image: np.ndarray, labels, lr_pairs, device,
               precision: str = "float32"):
    """(P, offsets): the flip-averaged posteriors (classes, X, Y, Z) of the
    padded volume on ``device``, float32, and the input's offsets in it."""
    vol, offsets = pad(normalize(image), 2 ** levels_of(params))
    x = torch.from_numpy(vol).to(device)[None, None]
    swap = torch.as_tensor(lr_swap(labels, lr_pairs), device=device)
    with full_float32():
        p1 = torch.softmax(forward(params, x, precision), 1)[0]
        p2 = torch.softmax(forward(params, torch.flip(x, (2,)), precision),
                           1)[0]
        p2 = torch.flip(p2, (1,))[swap]
        return 0.5 * (p1 + p2), offsets


def largest_component(mask: np.ndarray) -> np.ndarray:
    """``lab2im.edit_volumes.get_largest_connected_component``: the largest
    6-connected component, the first by scipy's numbering at a tie."""
    components, n = ndimage.label(mask)
    if n == 0:
        return mask.copy()
    return components == np.argmax(np.bincount(components.flat)[1:]) + 1


def postprocess(prob: np.ndarray, topology_classes) -> np.ndarray:
    """The argmax (X, Y, Z) of ``prob`` (classes, X, Y, Z) after
    ``predict.py::postprocess``; ``prob`` is left as it was."""
    prob = np.array(prob, np.float32)
    fg = prob[1:]
    fg *= largest_component(fg.sum(0) > THRESHOLD)
    masks = prob > THRESHOLD
    classes = np.asarray(topology_classes)
    for c in np.unique(classes)[1:]:
        idx = np.where(classes == c)[0]
        keep = largest_component(np.any(masks[idx], 0))
        for i in idx:
            prob[i] *= keep
    with np.errstate(invalid="ignore", divide="ignore"):
        prob /= prob.sum(0)
    return prob.argmax(0)


def crop_labels(index: np.ndarray, offsets, shape, structure_of):
    """The port's labels of an argmax over the padded volume, cropped."""
    crop = tuple(slice(o, o + s) for o, s in zip(offsets, shape))
    return np.asarray(structure_of, np.uint8)[np.asarray(index)[crop]]


def posterior_gap(prob: torch.Tensor, index: torch.Tensor) -> float:
    """The largest ``max_k P_k - P_L`` over the voxels, ``L`` the class
    judged (``index``, the shape of ``prob[0]``): 0 where ``L`` is P's
    choice, small at a near-tie."""
    chosen = prob.gather(0, index.to(prob.device).long()[None])[0]
    return float((prob.max(0).values - chosen).max())


def posterior_error(prob: torch.Tensor, other: torch.Tensor) -> float:
    """The largest ``|P_k - P'_k|`` over the classes and the voxels."""
    return float((prob - other.to(prob.device)).abs().max())
