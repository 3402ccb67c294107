"""Seeded weights of SynthSeg's 3D U-Net, made by the benchmark.

Both sides get the same weights: the program loads the leaves as its state
dict (loaded strictly), the reference reads them by key. Drawn from one
``torch.Generator`` on the device: convolutions He-normal with biases
N(0, 0.05), BN scales U(0.9, 1.1) and shifts N(0, 0.05). Random BN
statistics would let the activations grow or vanish over 18
convolutions, so :func:`calibrate` sets every BN's running mean and
variance from one pass of the reference over the first scan, and centres
the likelihood layer's bias per class over the scan's head (its nonzero
voxels), as ``weights.center_logits`` does for the tri-planar network:
without it one class wins every voxel by a wide margin and no lower
precision moves a label.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import synthseg as ref


def filters(cfg: dict, level: int) -> int:
    return int(cfg["unet_feat_count"]) * int(cfg["feat_multiplier"]) ** level


def leaf_shapes(cfg: dict) -> dict:
    """Key -> shape of every leaf, the program's state-dict keys
    (``down<l>.conv<i>.weight``, ``down<l>.bn.running_var``,
    ``up<l>.conv<i>.bias``, ``likelihood.weight``, ...)."""
    k, levels = int(cfg["conv_size"]), int(cfg["n_levels"])
    convs = int(cfg["nb_conv_per_level"])
    shapes = {}

    def add(name, c_in, c_out):
        for i in range(convs):
            shapes[f"{name}.conv{i}.weight"] = (c_out, c_in if i == 0
                                                else c_out, k, k, k)
            shapes[f"{name}.conv{i}.bias"] = (c_out,)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.bn.{leaf}"] = (c_out,)
        shapes[f"{name}.bn.num_batches_tracked"] = ()

    c_in = int(cfg["in_channels"])
    for lv in range(levels):
        add(f"down{lv}", c_in, filters(cfg, lv))
        c_in = filters(cfg, lv)
    for lv in range(levels - 2, -1, -1):
        add(f"up{lv}", filters(cfg, lv + 1) + filters(cfg, lv),
            filters(cfg, lv))
    n = len(cfg["labels"])
    shapes["likelihood.weight"] = (n, filters(cfg, 0), 1, 1, 1)
    shapes["likelihood.bias"] = (n,)
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The leaves for ``seed`` on ``device``, float32 (BN statistics 0 and
    1 until :func:`calibrate`)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for key, shape in leaf_shapes(cfg).items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        u = torch.rand(shape, generator=gen, device=device)
        g = torch.randn(shape, generator=gen, device=device)
        if leaf == "weight" and len(shape) == 5:
            t = g * math.sqrt(2.0 / math.prod(shape[1:]))
        elif leaf == "weight":
            t = 0.9 + 0.2 * u
        elif leaf == "bias":
            t = 0.05 * g
        elif leaf == "running_mean":
            t = torch.zeros(shape, device=device)
        else:
            t = torch.ones(shape, device=device)
        out[key] = t.contiguous()
    return out


@torch.no_grad()
def calibrate(params: dict, image: np.ndarray, device) -> None:
    """In place: every BN's statistics from one pass of the reference over
    ``image`` (normalised and padded as the scan path does), then the
    likelihood bias less the per-class mean of that pass's logits over the
    volume's nonzero voxels."""
    vol, _ = ref.pad(ref.normalize(image), 2 ** ref.levels_of(params))
    x = torch.from_numpy(vol).to(device)[None, None]
    with ref.full_float32():
        logits = ref.forward(params, x, calibrate=True)[0]
    head = x[0, 0] > 0
    params["likelihood.bias"] = (params["likelihood.bias"]
                                 - logits[:, head].mean(1))
