"""Seeded weights of SwinUNETR, made by the benchmark.

Both sides get the same weights: the program loads the leaves as its state
dict (loaded strictly, MONAI's names), the reference reads them by key.
Drawn from one ``torch.Generator`` on the device, MONAI's initialisation
but for one leaf: linear weights N(0, 0.02) (MONAI's ``trunc_normal_``
cuts at +-2, which std 0.02 does not reach), linear biases 0, LayerNorms 1
and 0, convolutions and transposed convolutions uniform within
+-1/sqrt(fan_in) (torch's default), as is the output convolution's bias;
the relative position bias tables N(0, 1), where MONAI starts them at
N(0, 0.02). A trained table is far from zero, and at 0.02 the bias moves
the logits less than float32's own noise does: leaving it out read
7.4e-5 against the program's 2.7e-6 in the cut CPU cell, so no check
could tell the two apart on the card. :func:`center` then subtracts from the output bias the
per-class mean of the reference's blended logits over the first scan's
head (its nonzero voxels), as ``weights.center_logits`` does for the
tri-planar network: without it one class wins nearly every voxel and no
lower precision moves a label.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import swinunetr as ref


def leaf_shapes(cfg: dict) -> dict:
    """Key -> shape of every leaf, under MONAI's names."""
    f, w = int(cfg["feature_size"]), int(cfg["window_size"])
    c_in, classes = int(cfg["in_channels"]), int(cfg["out_channels"])
    p, ratio = int(cfg["patch_size"]), float(cfg["mlp_ratio"])
    shapes = {"swinViT.patch_embed.proj.weight": (f, c_in, p, p, p),
              "swinViT.patch_embed.proj.bias": (f,)}
    for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        c = f * 2 ** s
        stage = f"swinViT.layers{s + 1}.0"
        for i in range(depth):
            b = f"{stage}.blocks.{i}"
            hidden = int(ratio * c)
            shapes.update({
                f"{b}.norm1.weight": (c,), f"{b}.norm1.bias": (c,),
                f"{b}.attn.relative_position_bias_table":
                    ((2 * w - 1) ** 3, heads),
                f"{b}.attn.qkv.weight": (3 * c, c),
                f"{b}.attn.qkv.bias": (3 * c,),
                f"{b}.attn.proj.weight": (c, c), f"{b}.attn.proj.bias": (c,),
                f"{b}.norm2.weight": (c,), f"{b}.norm2.bias": (c,),
                f"{b}.mlp.linear1.weight": (hidden, c),
                f"{b}.mlp.linear1.bias": (hidden,),
                f"{b}.mlp.linear2.weight": (c, hidden),
                f"{b}.mlp.linear2.bias": (c,)})
        shapes.update({f"{stage}.downsample.norm.weight": (8 * c,),
                       f"{stage}.downsample.norm.bias": (8 * c,),
                       f"{stage}.downsample.reduction.weight": (2 * c, 8 * c)})

    def res(name, a, b):
        shapes[f"{name}.conv1.conv.weight"] = (b, a, 3, 3, 3)
        shapes[f"{name}.conv2.conv.weight"] = (b, b, 3, 3, 3)
        if a != b:
            shapes[f"{name}.conv3.conv.weight"] = (b, a, 1, 1, 1)

    for name, a, b in (("encoder1", c_in, f), ("encoder2", f, f),
                       ("encoder3", 2 * f, 2 * f), ("encoder4", 4 * f, 4 * f),
                       ("encoder10", 16 * f, 16 * f)):
        res(f"{name}.layer", a, b)
    for name, a, b in (("decoder5", 16 * f, 8 * f), ("decoder4", 8 * f, 4 * f),
                       ("decoder3", 4 * f, 2 * f), ("decoder2", 2 * f, f),
                       ("decoder1", f, f)):
        shapes[f"{name}.transp_conv.conv.weight"] = (a, b, 2, 2, 2)
        res(f"{name}.conv_block", 2 * b, b)
    shapes["out.conv.conv.weight"] = (classes, f, 1, 1, 1)
    shapes["out.conv.conv.bias"] = (classes,)
    return shapes


def n_leaves(cfg: dict) -> int:
    return sum(math.prod(s) for s in leaf_shapes(cfg).values())


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The leaves for ``seed`` on ``device``, float32 (the output bias not
    yet centred)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for key, shape in leaf_shapes(cfg).items():
        leaf = key.rsplit(".", 1)[-1]
        if key.endswith("relative_position_bias_table"):
            t = torch.randn(shape, generator=gen, device=device)
        elif leaf == "weight" and len(shape) == 2:
            t = torch.randn(shape, generator=gen, device=device).mul_(
                0.02).clamp_(-2, 2)
        elif leaf == "weight" and len(shape) == 1:
            t = torch.ones(shape, device=device)
        elif leaf == "bias" and len(shape) == 1 and ".conv." not in key \
                and "patch_embed" not in key:
            t = torch.zeros(shape, device=device)
        else:
            weight = out.get(key.rsplit(".", 1)[0] + ".weight")
            fan_in = math.prod((weight.shape if leaf == "bias"
                                else shape)[1:])
            t = (torch.rand(shape, generator=gen, device=device) * 2 - 1) \
                / math.sqrt(fan_in)
        out[key] = t.contiguous()
    return out


@torch.no_grad()
def center(params: dict, image: np.ndarray, device, roi: int = 128,
           overlap: float = 0.5) -> None:
    """In place: the output bias less the per-class mean of the
    reference's blended logits over ``image``'s nonzero voxels."""
    logits = ref.blended_logits(params, image, device, roi, overlap)
    head = torch.from_numpy(np.asarray(image) != 0).to(logits.device)
    params["out.conv.conv.bias"] = (params["out.conv.conv.bias"]
                                    - logits[:, head].mean(1))
