"""Seeded weights of the tri-planar network, made by the benchmark.

Both sides get the same weights: the program loads them as its state dict,
the reference reads them by key. Every leaf is drawn, not only the weights,
so that a run exercises BN's stored statistics, its scale and shift, the
PReLU slopes and the biases too (Lasagne's initial values would make BN the
identity and every bias zero). Conv and dense weights are Glorot-uniform,
as Lasagne initializes them; the draws come from one ``torch.Generator`` on
the device in two calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

VIEWS = ("axial", "coronal", "sagittal")


def leaf_shapes(cfg: dict) -> dict:
    """Key -> shape of every leaf of the network of configuration ``cfg``,
    in the program's state-dict layout (conv OIHW, dense (out, in); BN
    ``beta``, ``gamma``, ``mean``, ``inv_std``; PReLU slopes per channel)."""
    shapes = {}
    c_in = int(cfg["num_channels"])
    side = int(cfg["patch_size"])
    for view in VIEWS:
        c = c_in
        s = side
        for i, c_out in enumerate(cfg["conv_filters"], start=1):
            shapes[f"{view}.conv{i}.weight"] = (c_out, c, 3, 3)
            for leaf in ("beta", "gamma", "mean", "inv_std"):
                shapes[f"{view}.bn{i}.{leaf}"] = (c_out,)
            shapes[f"{view}.prelu{i}"] = (c_out,)
            c = c_out
            s -= 2
            if i in (2, 4):
                s //= 2
        shapes[f"{view}.d1.weight"] = (cfg["fc_conv"], c * s * s)
        shapes[f"{view}.d1.bias"] = (cfg["fc_conv"],)
        shapes[f"{view}.prelu_d1"] = (cfg["fc_conv"],)
    f3 = 3 * cfg["fc_conv"]
    shapes["fc1.weight"] = (cfg["fc_fc"], f3)
    shapes["fc1.bias"] = (cfg["fc_fc"],)
    shapes["prelu_f1"] = (cfg["fc_fc"],)
    shapes["fc2.weight"] = (cfg["fc2"], cfg["fc_fc"] + cfg["atlas_dim"])
    shapes["fc2.bias"] = (cfg["fc2"],)
    shapes["prelu_f2"] = (cfg["fc2"],)
    shapes["out.weight"] = (cfg["num_classes"], cfg["fc2"])
    shapes["out.bias"] = (cfg["num_classes"],)
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The network's leaves for ``seed`` on ``device``, float32.

    Weights Glorot-uniform (fan in and out times the receptive field);
    biases and BN shifts N(0, 0.05); BN scales U(0.75, 1.25); BN stored
    means N(0, 0.1) and inverse deviations U(0.8, 1.25); PReLU slopes
    U(0.1, 0.4)."""
    shapes = leaf_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    uni = torch.rand(sum(sizes), generator=gen, device=device)
    nrm = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (key, shape), n in zip(shapes.items(), sizes):
        u, g = uni[at:at + n].view(shape), nrm[at:at + n].view(shape)
        at += n
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight":
            receptive = math.prod(shape[2:])
            limit = math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))
            t = (2 * u - 1) * limit
        elif leaf in ("bias", "beta"):
            t = 0.05 * g
        elif leaf == "gamma":
            t = 0.75 + 0.5 * u
        elif leaf == "mean":
            t = 0.1 * g
        elif leaf == "inv_std":
            t = 0.8 + 0.45 * u
        else:  # PReLU slopes
            t = 0.1 + 0.3 * u
        out[key] = t.contiguous()
    return out


def n_leaves(cfg: dict) -> int:
    """Numbers in all leaves, BN's stored statistics included: 883,455 at
    the published widths."""
    return sum(math.prod(s) for s in leaf_shapes(cfg).values())


def center_logits(p: dict, cfg: dict, image, atlas, centers, device,
                  seed: int, n: int = 4096) -> None:
    """Shift the output layer's bias, in place, so that the network's logits
    average zero in each class over ``n`` of a scan's candidates drawn from
    ``seed``. Seeded weights otherwise may give every voxel one class by a
    wide margin (the head's mean activations through the output layer), and
    then no label is near a tie for a lower precision to flip."""
    from benchmark.reference import triplanar as ref_net
    rng = np.random.default_rng([seed, 4])
    pick = centers[rng.choice(len(centers), min(n, len(centers)),
                              replace=False)]
    logits = ref_net.scan_logits(p, cfg, image, atlas, pick, device)
    p["out.bias"] = p["out.bias"] - torch.from_numpy(logits.mean(0)).to(
        p["out.bias"])
