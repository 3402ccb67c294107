"""Seeded weights of FastSurferCNN's three view networks, made by the
benchmark.

Both sides get the same weights: the program loads each view's leaves as
its state dict (FastSurfer's keys, loaded strictly), the reference reads
them by key. Drawn from one ``torch.Generator`` on the device: convolutions
He-normal (FastSurfer's initialisation) with biases N(0, 0.05), BN scales
U(0.9, 1.1) and shifts N(0, 0.05), PReLU slopes U(0.1, 0.4). Random BN
statistics would let the activations grow or vanish over 9 blocks, so
:func:`calibrate` sets every BN's running mean and variance from one pass
of the reference over slices of the first scan, and centres the
classifier's bias per class over the same slices, as ``weights.
center_logits`` does for the tri-planar network: without it one class
wins every voxel by a wide margin and no lower precision flips a label.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import fastsurfer as ref

VIEWS = ("axial", "coronal", "sagittal")
LEVELS = 4


def leaf_shapes(cfg: dict, num_classes: int) -> dict:
    """Key -> shape of every leaf of one view's network, FastSurfer's
    state-dict keys (``encode1.conv0.weight``, ...)."""
    f, k, c0 = (int(cfg["num_filters"]), int(cfg["kernel_h"]),
                int(cfg["num_channels"]))
    shapes = {}
    blocks = ([f"encode{i}" for i in range(1, LEVELS + 1)] + ["bottleneck"]
              + [f"decode{i}" for i in range(LEVELS, 0, -1)])
    for name in blocks:
        c_in = c0 if name == "encode1" else f
        for i, (ci, kk) in enumerate(((c_in, k), (f, k), (f, 1))):
            shapes[f"{name}.conv{i}.weight"] = (f, ci, kk, kk)
            shapes[f"{name}.conv{i}.bias"] = (f,)
        for i in range(0 if name == "encode1" else 1, 4):
            c = c_in if i == 0 else f
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{name}.bn{i}.{leaf}"] = (c,)
            shapes[f"{name}.bn{i}.num_batches_tracked"] = ()
        shapes[f"{name}.prelu.weight"] = (1,)
    shapes["classifier.conv.weight"] = (num_classes, f, 1, 1)
    shapes["classifier.conv.bias"] = (num_classes,)
    return shapes


def classes_of(cfg: dict, view: str) -> int:
    return int(cfg["num_classes_sagittal"] if view == "sagittal"
               else cfg["num_classes"])


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{view: leaves} for ``seed`` on ``device``, float32 (BN statistics
    0 and 1 until :func:`calibrate`)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for view in VIEWS:
        leaves = {}
        for key, shape in leaf_shapes(cfg, classes_of(cfg, view)).items():
            leaf = key.rsplit(".", 1)[-1]
            if leaf == "num_batches_tracked":
                leaves[key] = torch.zeros((), dtype=torch.int64,
                                          device=device)
                continue
            u = torch.rand(shape, generator=gen, device=device)
            g = torch.randn(shape, generator=gen, device=device)
            if key.endswith("prelu.weight"):
                t = 0.1 + 0.3 * u
            elif leaf == "weight" and len(shape) == 4:
                t = g * math.sqrt(2.0 / math.prod(shape[1:]))
            elif leaf == "weight":
                t = 0.9 + 0.2 * u
            elif leaf == "bias":
                t = 0.05 * g
            elif leaf == "running_mean":
                t = torch.zeros(shape, device=device)
            else:
                t = torch.ones(shape, device=device)
            leaves[key] = t.contiguous()
        out[view] = leaves
    return out


def calibration_slices(image: np.ndarray, axis: int, n: int, size: int,
                       seed: int) -> list:
    """``n`` slice indices along ``axis`` of the conformed volume, drawn
    from ``seed`` among the slices that hold the scan."""
    offset = (size - image.shape[axis]) // 2
    rng = np.random.default_rng([seed, 7, axis])
    pick = rng.choice(image.shape[axis], min(n, image.shape[axis]),
                      replace=False)
    return sorted(int(i) + offset for i in pick)


@torch.no_grad()
def calibrate(params: dict, cfg: dict, image: np.ndarray, device, seed: int,
              n: int = 16, size: int = 256) -> None:
    """In place: each view's BN statistics from one pass of the reference
    over ``n`` of its slices of ``image``, then the classifier's bias less
    the per-class mean of its logits over the same slices."""
    vol, _ = ref.conform(image, size)
    volume = torch.from_numpy(vol).to(device).float() / 255.0
    with ref.full_float32():
        for name, axis, _ in ref.VIEWS:
            p = params[name]
            x = torch.cat([ref.thick_slices(volume, axis, i, i + 1) for i in
                           calibration_slices(image, axis, n, size, seed)])
            ref.forward(p, x, calibrate=True)
            logits = ref.forward(p, x)
            p["classifier.conv.bias"] = (p["classifier.conv.bias"]
                                         - logits.mean((0, 2, 3)))
