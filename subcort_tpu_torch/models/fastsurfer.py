"""FastSurferCNN v1: one 2.5D competitive-dense network per view.

Henschel et al., "FastSurfer - a fast and accurate deep learning based
neuroimaging pipeline", NeuroImage 219 (2020); github.com/Deep-MI/FastSurfer,
``FastSurferCNN/models/networks.py`` and ``sub_module.py`` (v1). The module
and attribute names are FastSurfer's, so a published state dict loads with
``load_state_dict(strict=True)``: ``encode1.conv0.weight``,
``encode1.bn0.running_mean``, ``encode1.prelu.weight``, ...,
``classifier.conv.weight``.

On (N, C, H, W) slices; ``conv`` k x k with padding (k - 1) / 2, stride 1
and a bias; ``bn`` torch's eval form ``(x - running_mean) /
sqrt(running_var + 1e-5) * weight + bias``; ``prelu`` ONE ``nn.PReLU()``
per block, a single slope shared by every use in that block; ``max`` the
elementwise maximum (maxout):

    CDB-input (encode1):  x1_bn = bn1(conv0(bn0(x)))          7 -> F, 5x5
                          x2_bn = bn2(conv1(prelu(x1_bn)))    F -> F, 5x5
                          out   = bn3(conv2(prelu(max(x2_bn, x1_bn))))  1x1
    CDB:                  x1_bn = bn1(conv0(prelu(x)))
                          x1_max = max(x1_bn, x)
                          x2_bn = bn2(conv1(prelu(x1_max)))
                          out   = bn3(conv2(prelu(max(x2_bn, x1_max))))
    encoder k:            b = block(x); pooled, idx = max_pool2d(b, 2, 2,
                          return_indices); returns (pooled, b, idx)
    bottleneck:           a CDB
    decoder k:            CDB(max(max_unpool2d(x, idx, 2, 2), skip_k))
    classifier:           1x1 conv F -> num_classes (logits)

    encode1..4 -> bottleneck -> decode4..1 (skips and indices of the
    encoder of the same level) -> classifier

At the published widths (7 input slices, 64 filters, 5x5 kernels, 79
classes, or 51 for the sagittal view) a 256 x 256 slice costs
61,545,119,744 FLOP (61,310,238,720 at 51 classes) counting convolutions
alone as 2 H W C_in C_out k^2 (``benchmark/configs/fastsurfer_cnn.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, torch.Tensor]

VIEWS = ("axial", "coronal", "sagittal")
LEVELS = 4


@dataclasses.dataclass(frozen=True)
class FastSurferSpec:
    """FastSurferCNN's ``params`` (networks.py): the published widths by
    default; ``num_classes`` 79, or 51 for the sagittal network."""
    num_channels: int = 7
    num_filters: int = 64
    kernel: int = 5
    num_classes: int = 79
    bn_eps: float = 1e-5

    def sagittal(self, num_classes: int = 51) -> "FastSurferSpec":
        return dataclasses.replace(self, num_classes=num_classes)


DEFAULT_SPEC = FastSurferSpec()


def _maxout(conv_branch: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """A block's maxout: the elementwise maximum of its convolution
    branch and the other input."""
    return torch.maximum(conv_branch, other)


class _DenseBlock(nn.Module):
    """CompetitiveDenseBlock and, with ``input_block``,
    CompetitiveDenseBlockInput (sub_module.py)."""

    def __init__(self, spec: FastSurferSpec, input_block: bool = False,
                 device=None):
        super().__init__()
        f, k = spec.num_filters, spec.kernel
        c_in = spec.num_channels if input_block else f
        self.input_block = input_block
        self.conv0 = nn.Conv2d(c_in, f, k, padding=k // 2, device=device)
        self.conv1 = nn.Conv2d(f, f, k, padding=k // 2, device=device)
        self.conv2 = nn.Conv2d(f, f, 1, device=device)
        if input_block:
            self.bn0 = nn.BatchNorm2d(c_in, eps=spec.bn_eps, device=device)
        self.bn1 = nn.BatchNorm2d(f, eps=spec.bn_eps, device=device)
        self.bn2 = nn.BatchNorm2d(f, eps=spec.bn_eps, device=device)
        self.bn3 = nn.BatchNorm2d(f, eps=spec.bn_eps, device=device)
        self.prelu = nn.PReLU(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.input_block:
            x1_max = self.bn1(self.conv0(self.bn0(x)))
        else:
            x1_max = _maxout(self.bn1(self.conv0(self.prelu(x))), x)
        x2_bn = self.bn2(self.conv1(self.prelu(x1_max)))
        return self.bn3(self.conv2(self.prelu(_maxout(x2_bn, x1_max))))


class _Encoder(_DenseBlock):
    def forward(self, x: torch.Tensor):
        block = super().forward(x)
        pooled, indices = F.max_pool2d(block, 2, 2, return_indices=True)
        return pooled, block, indices


class _Decoder(_DenseBlock):
    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                indices: torch.Tensor) -> torch.Tensor:
        unpooled = F.max_unpool2d(x, indices, 2, 2, output_size=skip.shape)
        return super().forward(torch.maximum(unpooled, skip))


class _Classifier(nn.Module):
    def __init__(self, spec: FastSurferSpec, device=None):
        super().__init__()
        self.conv = nn.Conv2d(spec.num_filters, spec.num_classes, 1,
                              device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class FastSurferCNN(nn.Module):
    """One view's network: (N, num_channels, H, W) slices in, (N,
    num_classes, H, W) logits out; H and W divisible by 16."""

    def __init__(self, spec: FastSurferSpec = DEFAULT_SPEC, device=None):
        super().__init__()
        self.spec = spec
        self.encode1 = _Encoder(spec, input_block=True, device=device)
        for k in range(2, LEVELS + 1):
            setattr(self, f"encode{k}", _Encoder(spec, device=device))
        self.bottleneck = _DenseBlock(spec, device=device)
        for k in range(LEVELS, 0, -1):
            setattr(self, f"decode{k}", _Decoder(spec, device=device))
        self.classifier = _Classifier(spec, device=device)

    @classmethod
    def from_params(cls, params: Params, spec: FastSurferSpec = DEFAULT_SPEC,
                    device=None) -> "FastSurferCNN":
        """A net in inference mode on ``device`` holding ``params`` (a
        FastSurfer state dict, loaded strictly). ``device=None`` is the
        default card, which raises without one."""
        if device is None:
            from subcort_tpu_torch.config import Options, select_device
            device = select_device(Options())
        net = cls(spec, device="meta").to_empty(device=device)
        net.load_state_dict(params, strict=True)
        return net.eval().requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for k in range(1, LEVELS + 1):
            x, skip, indices = getattr(self, f"encode{k}")(x)
            skips.append((skip, indices))
        x = self.bottleneck(x)
        for k in range(LEVELS, 0, -1):
            skip, indices = skips[k - 1]
            x = getattr(self, f"decode{k}")(x, skip, indices)
        return self.classifier(x)


class FastSurferViews(nn.Module):
    """The three view networks, ``axial``, ``coronal`` and ``sagittal``,
    the last with its own class count (51 at the published widths)."""

    def __init__(self, spec: FastSurferSpec = DEFAULT_SPEC,
                 sagittal_classes: int = 51, device=None):
        super().__init__()
        self.axial = FastSurferCNN(spec, device=device)
        self.coronal = FastSurferCNN(spec, device=device)
        self.sagittal = FastSurferCNN(spec.sagittal(sagittal_classes),
                                      device=device)

    @classmethod
    def from_params(cls, params: Dict[str, Params], device=None,
                    bn_eps: float = 1e-5) -> "FastSurferViews":
        """The three nets in inference mode on ``device`` from FastSurfer
        state dicts ``{"axial": ..., "coronal": ..., "sagittal": ...}``,
        each loaded strictly; their widths come from their shapes."""
        if set(params) != set(VIEWS):
            raise ValueError(f"FastSurfer weights need the views {VIEWS}, "
                             f"got {sorted(params)}")
        spec = spec_of(params["axial"], bn_eps)
        sag = spec_of(params["sagittal"], bn_eps)
        if spec != spec_of(params["coronal"], bn_eps) or \
                spec.sagittal(sag.num_classes) != sag:
            raise ValueError("the views' networks differ in width")
        views = cls(spec, sag.num_classes, device="meta")
        for view in VIEWS:
            setattr(views, view, FastSurferCNN.from_params(
                params[view], getattr(views, view).spec, device))
        return views


def is_view_params(params) -> bool:
    """Whether ``params`` holds FastSurfer weights, one state dict a view
    (what :class:`FastSurferViews` loads), not a tri-planar state dict."""
    return (isinstance(params, dict) and set(params) == set(VIEWS)
            and all(isinstance(v, dict) for v in params.values()))


def spec_of(params: Params, bn_eps: float = 1e-5) -> FastSurferSpec:
    """The spec a FastSurfer state dict was made for, from its shapes."""
    w = params["encode1.conv0.weight"]
    return FastSurferSpec(num_channels=int(w.shape[1]),
                          num_filters=int(w.shape[0]),
                          kernel=int(w.shape[-1]),
                          num_classes=int(params["classifier.conv.weight"]
                                          .shape[0]), bn_eps=bn_eps)


def init_params(spec: FastSurferSpec = DEFAULT_SPEC,
                generator: torch.Generator | None = None) -> Params:
    """A seeded state dict on the CPU, every leaf drawn so that no BN is
    the identity: convolutions He-normal (FastSurfer's initialisation),
    biases and BN shifts N(0, 0.05), BN scales U(0.75, 1.25), running
    means N(0, 0.1), running variances U(0.5, 1.5), slopes U(0.1, 0.4)."""
    g = generator if generator is not None else torch.Generator()
    out = {}
    for key, t in FastSurferCNN(spec, device="meta").state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros((), dtype=torch.int64)
            continue
        u = torch.rand(shape, generator=g)
        if key.endswith("prelu.weight"):
            out[key] = 0.1 + 0.3 * u
        elif leaf == "weight" and len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
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
