"""Plain reference of FastSurferCNN v1 and its view aggregation.

Henschel et al., "FastSurfer - a fast and accurate deep learning based
neuroimaging pipeline", NeuroImage 219 (2020); github.com/Deep-MI/FastSurfer,
``FastSurferCNN/models/networks.py`` and ``sub_module.py``. Plain ``torch``
operations on a dict of state-dict leaves under FastSurfer's keys, nothing
of the program and nothing of JAX:

    bn(x)   = (x - running_mean) / sqrt(running_var + 1e-5) * weight + bias
    prelu   = one slope per block, x if x >= 0 else slope * x
    CDB-input: x1 = bn1(conv0(bn0(x))); x2 = bn2(conv1(prelu(x1)))
               out = bn3(conv2(prelu(max(x2, x1))))
    CDB:       x1 = max(bn1(conv0(prelu(x))), x); x2 = bn2(conv1(prelu(x1)))
               out = bn3(conv2(prelu(max(x2, x1))))
    encoder:   b = block(x), then max_pool2d(b, 2, 2) with its indices
    decoder:   block(max(max_unpool2d(x, indices), skip))
    net:       encode1..4, bottleneck, decode4..1, 1x1 classifier (logits)

Convolutions are ``F.conv2d`` with their biases, padding (k - 1) / 2.
``precision`` is ``"float32"`` (TF32 off) or ``"tf32"``, the control: every
convolution's operands rounded to TF32's 10-bit mantissa
(``reference/triplanar.py::to_tf32``), products accumulated in float32.

Departures from FastSurfer, each the benchmark's assumption:

- conform: no resampling or reorientation; a 1 mm isotropic scan of at
  most 256 a side is padded centrally with zeros into 256^3, its
  intensities mapped linearly from [min, q] to [0, 255] (rounded half to
  even, clipped), q the 0.999 quantile interpolated linearly between the
  order statistics around rank 0.999 (n - 1) (FastSurfer's ``getscale`` /
  ``scalecrop`` rule as assumed);
- tables: ``sagittal_to_full`` and ``structure_of`` come from the
  configuration (FastSurfer's ``map_prediction_sagittal2full`` and LUT are
  not in the repository);
- orientation: axial slices fix axis 2, coronal axis 1, sagittal axis 0,
  in-plane the other two axes in increasing order; thick slices take 3
  neighbours a side, edges replicated;
- aggregation: P = 0.4 softmax(axial) + 0.4 softmax(coronal) + 0.2
  softmax(sagittal)[..., sagittal_to_full], labels structure_of[argmax P];
- the post-process keeps each class's largest 6-connected component
  (``reference/postprocess.py`` with a whole-volume mask).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.triplanar import full_float32, to_tf32

VIEWS = (("axial", 2, 0.4), ("coronal", 1, 0.4), ("sagittal", 0, 0.2))
LEVELS = 4
EPS = 1e-5
CONTEXT = 3


def _conv(x, p, key, precision):
    w, b = p[key + ".weight"], p[key + ".bias"]
    if precision == "tf32":
        x, w = to_tf32(x), to_tf32(w)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def _bn(x, p, key, calibrate=False):
    shape = (1, -1, 1, 1)
    if calibrate:
        var, mean = torch.var_mean(x, (0, 2, 3), correction=0)
        p[key + ".running_mean"], p[key + ".running_var"] = mean, var
    mean = p[key + ".running_mean"].view(shape)
    var = p[key + ".running_var"].view(shape)
    return ((x - mean) / torch.sqrt(var + EPS) * p[key + ".weight"].view(shape)
            + p[key + ".bias"].view(shape))


def _prelu(x, p, block):
    return torch.where(x >= 0, x, x * p[block + ".prelu.weight"])


def block(p: dict, name: str, x, precision: str = "float32",
          input_block: bool = False, calibrate: bool = False):
    """One competitive dense block ``name`` of the leaves ``p``; with
    ``calibrate`` each BN first takes its input's mean and biased variance
    over (N, H, W) as its running statistics (into ``p``)."""
    def bn(t, i):
        return _bn(t, p, f"{name}.bn{i}", calibrate)

    def conv(t, i):
        return _conv(t, p, f"{name}.conv{i}", precision)

    if input_block:
        x1 = bn(conv(bn(x, 0), 0), 1)
    else:
        x1 = torch.maximum(bn(conv(_prelu(x, p, name), 0), 1), x)
    x2 = bn(conv(_prelu(x1, p, name), 1), 2)
    return bn(conv(_prelu(torch.maximum(x2, x1), p, name), 2), 3)


def forward(p: dict, x, precision: str = "float32", calibrate: bool = False):
    """Logits (N, classes, H, W) of one view's network on (N, 7, H, W)
    (``calibrate``: :func:`block`'s)."""
    skips = []
    for k in range(1, LEVELS + 1):
        b = block(p, f"encode{k}", x, precision, k == 1, calibrate)
        x, idx = F.max_pool2d(b, 2, 2, return_indices=True)
        skips.append((b, idx))
    x = block(p, "bottleneck", x, precision, calibrate=calibrate)
    for k in range(LEVELS, 0, -1):
        skip, idx = skips[k - 1]
        up = F.max_unpool2d(x, idx, 2, 2, output_size=skip.shape[-2:])
        x = block(p, f"decode{k}", torch.maximum(up, skip), precision,
                  calibrate=calibrate)
    return _conv(x, p, "classifier.conv", precision)


# ------------------------------------------------------------------ the scan
def conform(image: np.ndarray, size: int = 256):
    """(size^3 uint8 volume, offsets of the input in it), in NumPy."""
    image = np.asarray(image)
    flat = np.sort(image.reshape(-1))
    n = flat.size
    pos = 0.999 * (n - 1)
    k = int(np.floor(pos))
    t = pos - k
    lo = float(flat[0])
    a, b = float(flat[k]), float(flat[min(k + 1, n - 1)])
    hi = a + (b - a) * t
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    u = np.clip(np.rint((image.astype(np.float64) - lo) * scale), 0, 255)
    out = np.zeros((size,) * 3, np.uint8)
    offsets = tuple((size - s) // 2 for s in image.shape)
    out[tuple(slice(o, o + s) for o, s in zip(offsets, image.shape))] = u
    return out, offsets


def thick_slices(volume: torch.Tensor, axis: int, start: int, stop: int):
    """(stop - start, 7, H, W): slices start..stop-1 along ``axis``, each
    with its 3 neighbours a side as channels, edges replicated."""
    n = volume.shape[axis]
    chans = []
    for d in range(-CONTEXT, CONTEXT + 1):
        idx = torch.clamp(torch.arange(start, stop) + d, 0, n - 1)
        s = volume.index_select(axis, idx.to(volume.device))
        rest = [a for a in range(3) if a != axis]
        chans.append(s.permute(axis, *rest))
    return torch.stack(chans, 1)


@torch.no_grad()
def aggregate(params: dict, image: np.ndarray, sagittal_to_full, device,
              precision: str = "float32", size: int = 256, block_n: int = 8,
              views=VIEWS):
    """(P cropped to the input's shape, X x Y x Z x classes float32 on
    ``device``) of one raw scan: every view's softmax over blocks of
    ``block_n`` slices, weighted and summed. ``params`` maps a view's name
    to its leaves."""
    vol, offsets = conform(image, size)
    volume = torch.from_numpy(vol).to(device).float() / 255.0
    table = torch.as_tensor(list(sagittal_to_full), device=device)
    crop = tuple(slice(o, o + s) for o, s in zip(offsets, image.shape))
    prob = torch.zeros(tuple(image.shape) + (len(table),), device=device)
    with full_float32():
        for name, axis, weight in views:
            lo, hi = crop[axis].start, crop[axis].stop
            inplane = [crop[a] for a in range(3) if a != axis]
            for start in range(lo, hi, block_n):
                stop = min(start + block_n, hi)
                x = thick_slices(volume, axis, start, stop)
                soft = torch.softmax(forward(params[name], x, precision), 1)
                if name == "sagittal":
                    soft = soft[:, table]
                # (B, classes, H, W) -> the crop's layout
                soft = soft[:, :, inplane[0], inplane[1]]
                dest = [slice(None)] * 3
                dest[axis] = slice(start - lo, stop - lo)
                order = {2: (2, 3, 0, 1), 1: (2, 0, 3, 1), 0: (0, 2, 3, 1)}
                prob[tuple(dest)] += weight * soft.permute(*order[axis])
    return prob


def labels_of(prob: torch.Tensor, structure_of) -> np.ndarray:
    """The 15-class labels of an aggregated P."""
    table = torch.as_tensor(list(structure_of), dtype=torch.uint8,
                            device=prob.device)
    return table[prob.argmax(-1)].cpu().numpy()


def label_gaps(prob: torch.Tensor, labels: np.ndarray,
               structure_of) -> torch.Tensor:
    """Per voxel ``max_k P_k - max_{k: structure_of[k] = L} P_k``, ``L`` the
    label judged: 0 where the label is P's choice, small at a near-tie."""
    table = torch.as_tensor(list(structure_of), device=prob.device)
    lab = torch.from_numpy(np.asarray(labels)).to(prob.device).long()
    gap = torch.zeros(lab.shape, device=prob.device)
    best = prob.max(-1).values
    for cls in range(int(table.max()) + 1):
        members = (table == cls).nonzero().reshape(-1)
        if members.numel():
            chosen = prob.index_select(-1, members).max(-1).values
            gap = torch.where(lab == cls, best - chosen, gap)
    return gap
