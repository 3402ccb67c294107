"""SynthSeg's 3D U-Net: one whole-volume network.

Billot, Greve, Puonti, Thielscher, Van Leemput, Fischl, Dalca and
Iglesias, "SynthSeg: Segmentation of brain MRI scans of any contrast and
resolution without retraining", Medical Image Analysis 86 (2023) 102789,
arXiv:2107.09559; github.com/BBillot/SynthSeg (``SynthSeg/predict.py``,
whose U-Net is ``ext/neuron`` ``unet`` built through ``ext/lab2im``).

On (N, 1, X, Y, Z) volumes, X, Y and Z multiples of ``2 ** (levels - 1)``;
``conv`` a 3 x 3 x 3 convolution zero-padded to "same", with a bias;
``elu`` ``x if x > 0 else alpha (exp(x) - 1)``; ``bn`` Keras's inference
form ``(x - mean) / sqrt(var + 1e-3) * gamma + beta``; ``f_l = 24 * 2^l``:

    encoder level l (0 .. 4):  s_l = bn(elu(conv(elu(conv(x)))))  -> f_l
                               x = max_pool3d(s_l, 2) below the last level
    decoder level l (3 .. 0):  x = bn(elu(conv(elu(conv(
                                   cat[up2(x), s_l])))))            -> f_l
    output:                    conv1x1(x) -> 33 logits (softmax outside)

``up2`` repeats each voxel twice along each axis (nearest upsampling), and
the concatenation puts the upsampled tensor's channels first. Neither the
paper's text nor its figure fixes four points, which the benchmark's
configuration lists under ``assumed``: BN after a level's second ELU, the
skip taken after that BN, nearest upsampling, and the order ``[upsampled,
skip]``. At the published widths (5 levels, 2 convolutions a level, 24
base filters doubled a level, 33 classes) the net holds 13,242,849 numbers
(BN's four a channel, as Keras counts them); a 192 x 224 x 192 volume costs
2,568,126,726,144 FLOP counting convolutions alone as 2 V C_in C_out k^3
(``benchmark/configs/synthseg_unet.py``).

State-dict keys follow the Keras layers' structure (``unet_conv_downarm_
<l>_<i>``, ``unet_bn_down_<l>``, ``unet_conv_uparm_<l>_<i>``,
``unet_bn_up_<l>``, ``unet_likelihood``): ``down<l>.conv<i>.weight``,
``down<l>.bn.running_var``, ``up<l>.conv<i>.bias``, ``likelihood.weight``,
so that a converted state dict loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SynthSegSpec:
    """``predict``'s U-Net arguments: the published widths by default."""
    levels: int = 5
    convs_per_level: int = 2
    kernel: int = 3
    base_filters: int = 24
    multiplier: int = 2
    num_classes: int = 33
    in_channels: int = 1
    bn_eps: float = 1e-3
    elu_alpha: float = 1.0

    def filters(self, level: int) -> int:
        return self.base_filters * self.multiplier ** level

    @property
    def divisor(self) -> int:
        """What every side of the input must be a multiple of."""
        return 2 ** (self.levels - 1)


DEFAULT_SPEC = SynthSegSpec()


def _merge(up: torch.Tensor, skip: torch.Tensor, level: int) -> torch.Tensor:
    """A decoder level's input: the upsampled tensor's channels, then the
    skip of encoder level ``level``."""
    return torch.cat([up, skip], 1)


class _Level(nn.Module):
    """``convs_per_level`` convolutions, each followed by ELU, then BN."""

    def __init__(self, spec: SynthSegSpec, c_in: int, c_out: int,
                 device=None):
        super().__init__()
        k = spec.kernel
        self.alpha = spec.elu_alpha
        for i in range(spec.convs_per_level):
            setattr(self, f"conv{i}", nn.Conv3d(c_in if i == 0 else c_out,
                                                c_out, k, padding=k // 2,
                                                device=device))
        self.bn = nn.BatchNorm3d(c_out, eps=spec.bn_eps, device=device)
        self.n = spec.convs_per_level

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = F.elu(getattr(self, f"conv{i}")(x), self.alpha, inplace=True)
        return self.bn(x)


class SynthSegUNet(nn.Module):
    """(N, in_channels, X, Y, Z) in, (N, num_classes, X, Y, Z) logits
    out; each side a multiple of ``spec.divisor``."""

    def __init__(self, spec: SynthSegSpec = DEFAULT_SPEC, device=None):
        super().__init__()
        self.spec = spec
        c_in = spec.in_channels
        for level in range(spec.levels):
            setattr(self, f"down{level}", _Level(
                spec, c_in, spec.filters(level), device))
            c_in = spec.filters(level)
        for level in range(spec.levels - 2, -1, -1):
            setattr(self, f"up{level}", _Level(
                spec, spec.filters(level + 1) + spec.filters(level),
                spec.filters(level), device))
        self.likelihood = nn.Conv3d(spec.base_filters, spec.num_classes, 1,
                                    device=device)

    @classmethod
    def from_params(cls, params: Params, device=None) -> "SynthSegUNet":
        """A net in inference mode on ``device`` holding ``params`` (loaded
        strictly; its widths come from their shapes). ``device=None`` is
        the default card, which raises without one."""
        if device is None:
            from subcort_tpu_torch.config import Options, select_device
            device = select_device(Options())
        net = cls(spec_of(params), device="meta").to_empty(
            device=device)
        net.load_state_dict(params, strict=True)
        return net.eval().requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        last = self.spec.levels - 1
        for level in range(self.spec.levels):
            x = getattr(self, f"down{level}")(x)
            if level < last:
                skips.append(x)
                x = F.max_pool3d(x, 2)
        for level in range(last - 1, -1, -1):
            up = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"up{level}")(_merge(up, skips[level], level))
            del up
        return self.likelihood(x)


def is_synthseg_params(params) -> bool:
    """Whether ``params`` is a SynthSeg state dict (a flat dict whose
    first convolution is 3D), not a tri-planar or FastSurfer one."""
    return (isinstance(params, dict) and "down0.conv0.weight" in params
            and getattr(params["down0.conv0.weight"], "dim",
                        lambda: 0)() == 5)


def spec_of(params: Params) -> SynthSegSpec:
    """The spec a SynthSeg state dict was made for, from its shapes."""
    w = params["down0.conv0.weight"]
    levels = 0
    while f"down{levels}.conv0.weight" in params:
        levels += 1
    convs = 0
    while f"down0.conv{convs}.weight" in params:
        convs += 1
    mult = (int(params["down1.conv0.weight"].shape[0]) // int(w.shape[0])
            if levels > 1 else 2)
    return SynthSegSpec(levels=levels, convs_per_level=convs,
                        kernel=int(w.shape[-1]), base_filters=int(w.shape[0]),
                        multiplier=mult,
                        num_classes=int(params["likelihood.weight"].shape[0]),
                        in_channels=int(w.shape[1]))


def num_params(spec: SynthSegSpec = DEFAULT_SPEC) -> int:
    """Numbers in the net, BN's four a channel (Keras's count)."""
    return sum(t.numel() for k, t in
               SynthSegUNet(spec, device="meta").state_dict().items()
               if not k.endswith("num_batches_tracked"))


def init_params(spec: SynthSegSpec = DEFAULT_SPEC,
                generator: torch.Generator | None = None) -> Params:
    """A seeded state dict on the CPU, every leaf drawn so that no BN is
    the identity: convolutions He-normal, biases and BN shifts N(0, 0.05),
    BN scales U(0.75, 1.25), running means N(0, 0.1), running variances
    U(0.5, 1.5)."""
    g = generator if generator is not None else torch.Generator()
    out = {}
    for key, t in SynthSegUNet(spec, device="meta").state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros((), dtype=torch.int64)
            continue
        u = torch.rand(shape, generator=g)
        if leaf == "weight" and len(shape) == 5:
            fan_in = shape[1] * shape[2] * shape[3] * shape[4]
            out[key] = torch.randn(shape, generator=g) * (2.0 / fan_in) ** 0.5
        elif leaf == "weight":
            out[key] = 0.75 + 0.5 * u
        elif leaf == "bias":
            out[key] = 0.05 * torch.randn(shape, generator=g)
        elif leaf == "running_mean":
            out[key] = 0.1 * torch.randn(shape, generator=g)
        else:  # running_var
            out[key] = 0.5 + u
    return out
