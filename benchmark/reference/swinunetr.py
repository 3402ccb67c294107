"""Plain reference of SwinUNETR and its sliding-window inference.

Hatamizadeh, Nath, Tang, Yang, Roth and Xu, "Swin UNETR: Swin Transformers
for Semantic Segmentation of Brain Tumors in MRI Images", BrainLes 2021,
arXiv:2201.01266; MONAI's ``monai/networks/nets/swin_unetr.py`` (v1,
``downsample="merging"``) and ``sliding_window_inference`` as the
``SwinUNETR/BRATS21`` scripts of ``Project-MONAI/research-contributions``
call it. Plain ``torch`` operations on a dict of state-dict leaves (MONAI's
names), NumPy and scipy; nothing of the program and nothing of JAX. One
window at a time, so that it fits beside the program:

    encoder   h_0 = conv3d(x, k=2, s=2) + bias; per stage: its blocks (odd
              ones shifted), then merging; hidden_s = layer_norm(h_s) over
              the channels without affine
    block     x += crop(unroll(reverse(attention(windows(roll(pad(
              LN_1(x))))))));  x += linear_2(gelu(linear_1(LN_2(x))))
    attention per window of n tokens and per head of d channels:
              softmax((q d^-1/2) k^T + table[index[:n, :n]] + mask) v,
              then the output linear; ``index`` the relative coordinate's
              row for the configured window, ``mask`` -100 between tokens
              of different shift regions (each axis of the padded grid cut
              at P - w and P - s), 0 within one
    merging   cat of x[a::2, b::2, c::2] over :data:`MERGE_ORDER`, then
              layer_norm(8 C) and linear(8 C, 2 C) without bias
    decoder   res blocks: conv3 (no bias), instance_norm (eps 1e-5, no
              affine), leaky_relu 0.01, conv3, instance_norm, + the input
              (through a 1x1 conv and instance_norm where the widths
              differ), leaky_relu; up blocks: conv_transpose3d (k 2, s 2,
              no bias), cat with the skip, a res block; a 1x1 conv with its
              bias to the logits

Windows (``windows`` here, not the program's loop) are cut one by one by
slicing, and put back by assignment. The scan: the nonzero voxels z-scored
in float64 (population std, 1 where 0); sides under the roi padded
centrally (the odd voxel at the end); windows along an axis at ``i * step``
for ``i = 0, 1, ...`` until one reaches the end, the last moved back to end
there (MONAI's ``dense_patch_slices``), ``step = int(roi (1 - overlap))``,
or one window where the side is the roi; the product of the axes' starts;
each window's logits weighted by a Gaussian (computed in float64, cast to
float32) and summed, over the summed weights; the argmax, cropped; the
post-process each class's largest 6-connected component (scipy,
``reference/postprocess.py`` with a whole-volume ROI).

``precision`` is ``"float32"`` (TF32 off for matmuls and cuDNN) or
``"tf32"``, the control: the operands of every convolution, transposed
convolution, linear layer and attention product rounded to TF32's 10-bit
mantissa (``reference/triplanar.py::to_tf32``), accumulated in float32.

Departures from MONAI, each the benchmark's assumption: the Gaussian is
the product of exact 1D Gaussians (sigma 0.125 roi) over its maximum,
clamped below at 1e-3, where MONAI builds its map with an erf-based
kernel; the intensity normalisation is applied by the path, as MONAI's
transforms would before it; one input channel and 15 classes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.postprocess import keep_components
from benchmark.reference.triplanar import full_float32, to_tf32

# MONAI v1 PatchMerging's slices, in its order
MERGE_ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1),
               (0, 1, 0), (0, 0, 1), (1, 1, 1))
MASK = -100.0
EPS = 1e-5
SLOPE = 0.01
SIGMA_SCALE = 0.125
MIN_WEIGHT = 1e-3


def _op(t, precision):
    if precision == "float32":
        return t
    if precision == "tf32":
        return to_tf32(t)
    raise ValueError(f"unknown precision {precision!r}")


def _linear(x, p, key, precision, bias=True):
    return F.linear(_op(x, precision), _op(p[key + ".weight"], precision),
                    p[key + ".bias"] if bias else None)


def _ln(x, p, key):
    return F.layer_norm(x, x.shape[-1:], p[key + ".weight"], p[key + ".bias"],
                        EPS)


def _conv(x, w, precision, bias=None, stride=1):
    k = w.shape[-1]
    return F.conv3d(_op(x, precision), _op(w, precision), bias, stride=stride,
                    padding=k // 2 if stride == 1 else 0)


# ------------------------------------------------------------ the spec
def spec_of(p: dict) -> dict:
    """Widths from the leaves: feature, depths, heads, window."""
    table = p["swinViT.layers1.0.blocks.0.attn.relative_position_bias_table"]
    depths, heads = [], []
    for s in range(1, 5):
        n = 0
        while f"swinViT.layers{s}.0.blocks.{n}.norm1.weight" in p:
            n += 1
        depths.append(n)
        heads.append(p[f"swinViT.layers{s}.0.blocks.0.attn."
                       "relative_position_bias_table"].shape[1])
    return dict(feature=p["swinViT.patch_embed.proj.weight"].shape[0],
                depths=depths, heads=heads,
                window=(round(table.shape[0] ** (1 / 3)) + 1) // 2)


# ------------------------------------------------------------ windows
@functools.lru_cache(maxsize=None)
def rel_index(window: int) -> np.ndarray:
    """(w^3, w^3): the bias table's row of each token pair of a window."""
    m = 2 * window - 1
    coords = [(a, b, c) for a in range(window) for b in range(window)
              for c in range(window)]
    out = np.empty((len(coords), len(coords)), np.int64)
    for i, (a, b, c) in enumerate(coords):
        for j, (d, e, f) in enumerate(coords):
            out[i, j] = ((a - d + window - 1) * m * m
                         + (b - e + window - 1) * m + (c - f + window - 1))
    return out


def windows(x, w):
    """(1, D, H, W, C) -> list of (n, C), windows in raster order."""
    _, d, h, wd, c = x.shape
    out = []
    for a in range(0, d, w[0]):
        for b in range(0, h, w[1]):
            for e in range(0, wd, w[2]):
                out.append(x[0, a:a + w[0], b:b + w[1], e:e + w[2]]
                           .reshape(-1, c))
    return out


def unwindow(parts, w, shape):
    """:func:`windows`' inverse into a (1, D, H, W, C) tensor."""
    d, h, wd, c = shape
    out = parts[0].new_zeros((1, d, h, wd, c))
    i = 0
    for a in range(0, d, w[0]):
        for b in range(0, h, w[1]):
            for e in range(0, wd, w[2]):
                out[0, a:a + w[0], b:b + w[1], e:e + w[2]] = parts[i].view(
                    w[0], w[1], w[2], c)
                i += 1
    return out


def region_mask(padded, w, shift, device):
    """(windows, n, n): :data:`MASK` between tokens of different shift
    regions of the padded grid."""
    ids = [np.where(np.arange(p) < p - wa, 0,
                    np.where(np.arange(p) < p - sa, 1, 2))
           for p, wa, sa in zip(padded, w, shift)]
    grid = (ids[0][:, None, None] * 9 + ids[1][None, :, None] * 3
            + ids[2][None, None, :]).astype(np.float32)
    grid = torch.from_numpy(grid).to(device)[None, ..., None]
    parts = torch.stack(windows(grid, w))[..., 0]
    same = parts[:, :, None] == parts[:, None, :]
    return torch.where(same, 0.0, MASK)


def attention(p, key, parts, heads, window, mask, precision):
    """``attn`` of MONAI's block on the stacked windows (nW, n, C)."""
    nw, n, c = parts.shape
    d = c // heads
    qkv = _linear(parts, p, key + ".qkv", precision).view(nw, n, 3, heads, d)
    q = qkv[:, :, 0].transpose(1, 2) * d ** -0.5
    k = qkv[:, :, 1].transpose(1, 2)
    v = qkv[:, :, 2].transpose(1, 2)
    logits = torch.matmul(_op(q, precision),
                          _op(k, precision).transpose(-1, -2))
    index = torch.from_numpy(rel_index(window)[:n, :n].reshape(-1)).to(
        parts.device)
    table = p[key + ".relative_position_bias_table"]
    logits = logits + table[index].view(n, n, heads).permute(2, 0, 1)[None]
    if mask is not None:
        logits = logits + mask[:, None]
    probs = torch.softmax(logits, -1)
    out = torch.matmul(_op(probs, precision), _op(v, precision))
    return _linear(out.transpose(1, 2).reshape(nw, n, c), p, key + ".proj",
                   precision)


def block(p, key, x, heads, window, shifted, precision):
    """One Swin block on (1, D, H, W, C)."""
    side = x.shape[1:4]
    w = [min(s, window) for s in side]
    shift = [0 if s <= window else (window // 2 if shifted else 0)
             for s in side]
    y = _ln(x, p, key + ".norm1")
    pads = [(wa - s % wa) % wa for s, wa in zip(side, w)]
    y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    padded = y.shape[1:4]
    on = any(shift)
    if on:
        y = torch.roll(y, [-s for s in shift], (1, 2, 3))
    mask = region_mask(padded, w, shift, x.device) if on else None
    parts = attention(p, key + ".attn", torch.stack(windows(y, w)), heads,
                      window, mask, precision)
    y = unwindow(list(parts), w, tuple(padded) + (x.shape[-1],))
    if on:
        y = torch.roll(y, shift, (1, 2, 3))
    x = x + y[:, :side[0], :side[1], :side[2]]
    h = F.gelu(_linear(_ln(x, p, key + ".norm2"), p, key + ".mlp.linear1",
                       precision))
    return x + _linear(h, p, key + ".mlp.linear2", precision)


def merge(p, key, x, precision):
    """MONAI v1 PatchMerging on (1, D, H, W, C)."""
    d, h, w = x.shape[1:4]
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x = torch.cat([x[:, a::2, b::2, c::2] for a, b, c in MERGE_ORDER], -1)
    return _linear(_ln(x, p, key + ".norm"), p, key + ".reduction",
                   precision, bias=False)


def encoder(p, x, precision="float32"):
    """The five hidden states of (1, in, X, Y, Z), channels first."""
    s = spec_of(p)
    h = _conv(x, p["swinViT.patch_embed.proj.weight"], precision,
              p["swinViT.patch_embed.proj.bias"], stride=2)

    def norm(t):
        return F.layer_norm(t.permute(0, 2, 3, 4, 1),
                            t.shape[1:2]).permute(0, 4, 1, 2, 3)

    hidden = [norm(h)]
    for st in range(4):
        t = h.permute(0, 2, 3, 4, 1)
        for i in range(s["depths"][st]):
            t = block(p, f"swinViT.layers{st + 1}.0.blocks.{i}", t,
                      s["heads"][st], s["window"], i % 2 == 1, precision)
        t = merge(p, f"swinViT.layers{st + 1}.0.downsample", t, precision)
        h = t.permute(0, 4, 1, 2, 3)
        hidden.append(norm(h))
    return hidden


def res_block(p, key, x, precision):
    """MONAI's UnetResBlock (``<key>.conv1.conv.weight``, ...)."""
    out = F.leaky_relu(F.instance_norm(_conv(
        x, p[key + ".conv1.conv.weight"], precision), eps=EPS), SLOPE)
    out = F.instance_norm(_conv(out, p[key + ".conv2.conv.weight"],
                                precision), eps=EPS)
    if key + ".conv3.conv.weight" in p:
        x = F.instance_norm(_conv(x, p[key + ".conv3.conv.weight"],
                                  precision), eps=EPS)
    return F.leaky_relu(out + x, SLOPE)


def up_block(p, key, x, skip, precision):
    w = p[key + ".transp_conv.conv.weight"]
    up = F.conv_transpose3d(_op(x, precision), _op(w, precision), stride=2)
    return res_block(p, key + ".conv_block", torch.cat([up, skip], 1),
                     precision)


def forward(p, x, precision="float32"):
    """Logits (1, classes, X, Y, Z) of (1, in, X, Y, Z)."""
    hid = encoder(p, x, precision)
    enc0 = res_block(p, "encoder1.layer", x, precision)
    enc1 = res_block(p, "encoder2.layer", hid[0], precision)
    enc2 = res_block(p, "encoder3.layer", hid[1], precision)
    enc3 = res_block(p, "encoder4.layer", hid[2], precision)
    dec4 = res_block(p, "encoder10.layer", hid[4], precision)
    dec3 = up_block(p, "decoder5", dec4, hid[3], precision)
    dec2 = up_block(p, "decoder4", dec3, enc3, precision)
    dec1 = up_block(p, "decoder3", dec2, enc2, precision)
    dec0 = up_block(p, "decoder2", dec1, enc1, precision)
    out = up_block(p, "decoder1", dec0, enc0, precision)
    return _conv(out, p["out.conv.conv.weight"], precision,
                 p["out.conv.conv.bias"])


# ------------------------------------------------------------ the scan
def normalize(image: np.ndarray) -> np.ndarray:
    """The nonzero voxels z-scored in float64, as float32."""
    v = np.asarray(image, np.float64).copy()
    nz = v != 0
    if nz.any():
        vals = v[nz]
        std = vals.std()
        v[nz] = (vals - vals.mean()) / (std if std != 0 else 1.0)
    return v.astype(np.float32)


def starts(side: int, roi: int, overlap: float) -> list:
    """MONAI's ``dense_patch_slices`` along one axis (``side >= roi``)."""
    step = roi if side == roi else max(int(roi * (1 - overlap)), 1)
    count = next(d for d in range(side) if d * step + roi >= side) + 1
    return [i * step - max(i * step + roi - side, 0) for i in range(count)]


def weights(roi: int) -> np.ndarray:
    """The Gaussian importance map (roi^3), float32."""
    c = np.arange(roi, dtype=np.float64) - (roi - 1) / 2
    g = np.exp(-c * c / (2 * (SIGMA_SCALE * roi) ** 2))
    m = np.einsum("i,j,k->ijk", g, g, g)
    return np.maximum(m / m.max(), MIN_WEIGHT).astype(np.float32)


@torch.no_grad()
def blended_logits(params: dict, image: np.ndarray, device, roi: int = 128,
                   overlap: float = 0.5, precision: str = "float32"):
    """(classes, X, Y, Z) float32 on ``device``: the Gaussian-blended
    window logits of one raw scan, cropped to it."""
    vol = normalize(image)
    shape = [max(s, roi) for s in vol.shape]
    off = [(a - s) // 2 for a, s in zip(shape, vol.shape)]
    padded = np.zeros(shape, np.float32)
    padded[tuple(slice(o, o + s) for o, s in zip(off, vol.shape))] = vol
    x = torch.from_numpy(padded).to(device)
    w = torch.from_numpy(weights(roi)).to(device)
    classes = params["out.conv.conv.weight"].shape[0]
    acc = torch.zeros([classes] + shape, device=device)
    total = torch.zeros(shape, device=device)
    grid = [starts(s, roi, overlap) for s in shape]
    with full_float32():
        for a in grid[0]:
            for b in grid[1]:
                for c in grid[2]:
                    cut = (slice(a, a + roi), slice(b, b + roi),
                           slice(c, c + roi))
                    logits = forward(params, x[cut][None, None],
                                     precision)[0]
                    acc[(slice(None),) + cut] += logits * w
                    total[cut] += w
    out = acc / total
    return out[(slice(None),) + tuple(slice(o, o + s)
                                      for o, s in zip(off, vol.shape))]


def labels(logits: torch.Tensor, post_process: bool = True) -> np.ndarray:
    """uint8 labels of blended logits: their argmax, each class's largest
    component with ``post_process``."""
    raw = logits.argmax(0).to(torch.uint8).cpu().numpy()
    return keep_components(raw, np.ones(raw.shape, bool)) if post_process \
        else raw


def logit_gap(logits: torch.Tensor, index) -> float:
    """The largest ``max_k L_k - L_label`` over the voxels."""
    if not torch.is_tensor(index):
        index = torch.from_numpy(np.asarray(index))
    index = index.to(logits.device).long()
    chosen = logits.gather(0, index[None])[0]
    return float((logits.max(0).values - chosen).max())


def logit_error(logits: torch.Tensor, other: torch.Tensor) -> float:
    """The largest ``|L - L'|`` over the classes and the voxels."""
    return float((logits - other.to(logits.device)).abs().max())


def window_count(shape, roi: int = 128, overlap: float = 0.5) -> int:
    return math.prod(len(starts(max(s, roi), roi, overlap)) for s in shape)
