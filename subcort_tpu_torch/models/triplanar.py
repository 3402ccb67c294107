"""Tri-planar voxelwise CNN in PyTorch, in inference and training mode.

Port of subcort_tpu/models/triplanar.py (``apply``, ``update_bn_ema``);
architecture per the reference, cnn_cort/nets.py:159-231. Three identical
2D branches, each on one (N, 1, 32, 32) view:

    conv 3x3 x20 -> BN -> PReLU    (32->30)
    conv 3x3 x20 -> BN -> PReLU    (30->28)
    maxpool 2                      (28->14)
    conv 3x3 x40 -> BN -> PReLU    (14->12)
    conv 3x3 x40 -> BN -> PReLU    (12->10)
    maxpool 2                      (10->5)
    conv 3x3 x60 -> BN -> PReLU    (5->3)
    dropout 0.5
    dense 540->180 -> PReLU

Head: concat(3x180) -> dropout -> FC 540->540 -> PReLU -> dropout ->
concat(+15 atlas) -> FC 555->270 -> PReLU -> FC 270->15 -> softmax.
883,455 parameters.

Lasagne semantics kept: convs carry no bias (BN follows); BN at inference
uses the *stored* inv_std, ``(x - mean) * (inv_std * gamma) + beta``, which
with the PReLU after it is one CUDA kernel on a card, in float32 or
bfloat16 (:meth:`_Branch.bn_prelu`, ``ops/bn_prelu.py``), and bit for bit
the four PyTorch ops it replaces; in
training it uses the batch's mean and biased variance over (N, H, W),
``inv_std = rsqrt(var + 1e-4)``, and records (mean, inv_std) for
:func:`update_bn_ema`, which keeps Lasagne's running averages of mean and
inv_std (not ``nn.BatchNorm2d``'s unbiased variance); below float32 both
round as the JAX package's ops round them. PReLU alpha per
channel / unit. Dropout is inverted dropout drawn from an explicit
``torch.Generator`` (never torch's global one), the identity at inference,
and never on the atlas. Layout is NCHW inside, so the flatten before
``d1`` is already Lasagne's (c, h, w) order. Conv weights are OIHW
cross-correlation kernels (the importer flips the reference's
true-convolution kernels).

Parameters are plain state dicts whose keys follow the JAX params tree
(``axial.conv1.weight``, ``axial.bn1.inv_std``, ``head`` layers at the top
level); BN mean and inv_std are buffers, the rest parameters.
:func:`init_params` makes one; :meth:`TriPlanarNet.from_params` loads one
onto a device, for inference or, with ``trainable=True``, for training.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import struct
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from subcort_tpu_torch.config import exact_float32
from subcort_tpu_torch.ops import bn_prelu
from subcort_tpu_torch.parallel import sync_bn

Params = Dict[str, torch.Tensor]
# the device type on which _Branch.bn_prelu takes the kernel
KERNEL_DEVICE = "cuda"

VIEWS = ("axial", "coronal", "sagittal")


@dataclasses.dataclass(frozen=True)
class TriPlanarSpec:
    """Static hyper-parameters (reference defaults: nets.py:159-164); a copy
    of subcort_tpu.models.triplanar.TriPlanarSpec without the TPU-only
    ``conv_impl`` switch."""
    patch_size: int = 32
    num_channels: int = 1
    conv_filters: tuple = (20, 20, 40, 40, 60)
    fc_conv: int = 180          # per-branch dense width
    fc_fc: int = 540            # head FC1 width
    fc2: int = 270              # head FC2 width
    num_classes: int = 15
    atlas_dim: int = 15
    dropout_conv: float = 0.5
    dropout_fc: float = 0.5
    bn_epsilon: float = 1e-4    # Lasagne BatchNormLayer default
    bn_alpha: float = 1e-2      # Lasagne running-average coefficient

    @property
    def branch_side(self) -> int:
        # after two 2x pools and five valid 3x3 convs: 32->30->28->14->12->10->5->3
        s = self.patch_size
        s = (s - 2 - 2) // 2
        s = (s - 2 - 2) // 2
        s = s - 2
        if s <= 0:
            raise ValueError(
                f"patch_size={self.patch_size} too small for the conv stack "
                f"(two 2x pools + five valid 3x3 convs need >= 24)")
        return s

    @property
    def branch_flat(self) -> int:
        return self.branch_side ** 2 * self.conv_filters[4]


DEFAULT_SPEC = TriPlanarSpec()


class _BatchNorm(nn.Module):
    """Lasagne BatchNormLayer: the stored (mean, inv_std) at inference; in
    training the batch's statistics, kept in ``batch_stats`` for
    :func:`update_bn_ema`. Inside a data-parallel step of more than one
    rank the statistics are the global batch's
    (:class:`~subcort_tpu_torch.parallel.sync_bn.SyncBatchNorm`)."""

    def __init__(self, channels: int, epsilon: float, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.beta = nn.Parameter(torch.zeros(channels, device=device))
        self.gamma = nn.Parameter(torch.ones(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("inv_std", torch.ones(channels, device=device))
        self.batch_stats = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            # the batch's mean and inv_std = rsqrt(biased variance + eps)
            # over (N, H, W) (triplanar.py:246-252); torch keeps no running
            # statistics here: update_bn_ema does
            dp = sync_bn.active()
            if dp is not None and dp.world > 1:
                y, mean, inv_std = sync_bn.sync_batch_norm(
                    x, self.gamma, self.beta, self.epsilon)
            elif x.dtype == torch.float32:
                # one fused pass
                y, mean, inv_std = torch.native_batch_norm(
                    x, self.gamma, self.beta, None, None, True, 0.0,
                    self.epsilon)
            else:
                # below float32, the JAX package's rounding: mean and
                # variance rounded to x's dtype, then each op rounded to it
                # (rsqrt taken in float32: torch's bfloat16 rsqrt on the
                # CPU is 1 / sqrt, rounded twice); float64 stays float64
                var, mean = torch.var_mean(x, (0, 2, 3), correction=0)
                wide = torch.promote_types(x.dtype, torch.float32)
                inv_std = torch.rsqrt((var + self.epsilon).to(wide)).to(
                    x.dtype)
                y = ((x - mean[:, None, None])
                     * (inv_std * self.gamma)[:, None, None]
                     + self.beta[:, None, None])
            self.batch_stats = (mean.detach(), inv_std.detach())
            return y
        scale = (self.inv_std * self.gamma)[:, None, None]
        return (x - self.mean[:, None, None]) * scale + self.beta[:, None, None]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``generator``: a kept value
    is scaled by 1 / (1 - rate), a dropped one is 0 (triplanar.py:255-258).
    ``F.dropout`` would draw from torch's global generator. Inside a
    data-parallel step the mask is drawn for the global batch and this
    rank keeps its rows, so the ranks draw what one process would."""
    if rate == 0:
        return x
    keep = 1.0 - rate
    shape = (sync_bn.global_rows(x.shape[0]),) + tuple(x.shape[1:])
    mask = sync_bn.local_rows(torch.bernoulli(
        torch.empty(shape, device=x.device), keep, generator=generator))
    return torch.where(mask.bool(), x / keep, 0.0).to(x.dtype)


class _Branch(nn.Module):
    """One 2D branch: (N, C, ps, ps) -> (N, fc_conv)."""

    def __init__(self, spec: TriPlanarSpec, device=None):
        super().__init__()
        self.dropout = spec.dropout_conv
        c_in = spec.num_channels
        for i, c_out in enumerate(spec.conv_filters, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(c_in, c_out, 3, bias=False,
                                                device=device))
            setattr(self, f"bn{i}",
                    _BatchNorm(c_out, spec.bn_epsilon, device=device))
            setattr(self, f"prelu{i}",
                    nn.Parameter(torch.full((c_out,), 0.25, device=device)))
            c_in = c_out
        self.d1 = nn.Linear(spec.branch_flat, spec.fc_conv, device=device)
        self.prelu_d1 = nn.Parameter(torch.full((spec.fc_conv,), 0.25,
                                                device=device))

    def bn_prelu(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Conv ``i``'s output through BN ``i`` and PReLU ``i``, in both
        engines (the dense one: ``models/fcn.py::dense_branch_features``).
        On a card, the kernel of ``ops/bn_prelu.py``, bit for bit the
        module's BN and ``F.prelu``, which run instead off the card, in
        training (the batch's statistics) and where autograd records the
        call: the kernel computes neither statistics nor gradients."""
        bn, alpha = getattr(self, f"bn{i}"), getattr(self, f"prelu{i}")
        if (x.device.type != KERNEL_DEVICE or bn.training
                or torch.is_grad_enabled() and (
                    x.requires_grad or alpha.requires_grad
                    or bn.gamma.requires_grad or bn.beta.requires_grad)):
            return F.prelu(bn(x), alpha)
        return bn_prelu.bn_prelu(x, bn.mean, bn.inv_std, bn.gamma, bn.beta,
                                 alpha)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in (1, 2, 3, 4, 5):
            x = self.bn_prelu(i, getattr(self, f"conv{i}")(x))
            if i in (2, 4):
                x = F.max_pool2d(x, 2)
        if self.training:
            x = dropout(x, self.dropout, generator)
        return F.prelu(self.d1(x.flatten(1)), self.prelu_d1)


class TriPlanarNet(nn.Module):
    """The tri-planar CNN. ``forward`` takes the JAX package's layout: three
    (N, ps, ps) patch stacks and the (N, 15) atlas prior vectors; it returns
    softmax probabilities, or logits with ``return_logits``. In training
    mode (``net.train()``) BN uses batch statistics and dropout draws from
    ``generator``, in the order axial, coronal, sagittal, concat, fc1."""

    def __init__(self, spec: TriPlanarSpec = DEFAULT_SPEC, device=None):
        super().__init__()
        self.spec = spec
        for view in VIEWS:
            setattr(self, view, _Branch(spec, device=device))
        concat = 3 * spec.fc_conv
        self.fc1 = nn.Linear(concat, spec.fc_fc, device=device)
        self.prelu_f1 = nn.Parameter(torch.full((spec.fc_fc,), 0.25,
                                                device=device))
        self.fc2 = nn.Linear(spec.fc_fc + spec.atlas_dim, spec.fc2,
                             device=device)
        self.prelu_f2 = nn.Parameter(torch.full((spec.fc2,), 0.25,
                                                device=device))
        self.out = nn.Linear(spec.fc2, spec.num_classes, device=device)

    @classmethod
    def from_params(cls, params: Params, spec: TriPlanarSpec = DEFAULT_SPEC,
                    device: torch.device | str | None = None,
                    trainable: bool = False) -> "TriPlanarNet":
        """A net on ``device`` holding ``params``: in inference mode with
        no gradients, or with ``trainable`` in training mode with gradients
        on every parameter. ``device=None`` is ``select_device(Options())``,
        the first CUDA device; without one it raises. The modules are made
        on the meta device first, so building a net draws nothing from
        torch's global random generator."""
        if device is None:
            # imported here: config imports nothing of the models
            from subcort_tpu_torch.config import Options, select_device
            device = select_device(Options())
        net = cls(spec, device="meta").to_empty(device=device)
        net.load_state_dict(params)
        if trainable:
            return net.train()
        return net.eval().requires_grad_(False)

    def forward(self, axial: torch.Tensor, coronal: torch.Tensor,
                sagittal: torch.Tensor, atlas: torch.Tensor,
                return_logits: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        fa = self.axial(axial.unsqueeze(1), generator)
        fc = self.coronal(coronal.unsqueeze(1), generator)
        fs = self.sagittal(sagittal.unsqueeze(1), generator)
        logits = self.head(torch.cat([fa, fc, fs], dim=1), atlas, generator)
        if return_logits:
            return logits
        return torch.softmax(logits, dim=-1)

    def head(self, features: torch.Tensor, atlas: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits from the (N, 3 * fc_conv) branch features, concatenated
        axial, coronal, sagittal, and the (N, 15) atlas prior vectors; the
        dense evaluator shares it (models/fcn.py)."""
        if self.training:
            features = dropout(features, self.spec.dropout_fc, generator)
        x = F.prelu(self.fc1(features), self.prelu_f1)
        if self.training:
            x = dropout(x, self.spec.dropout_fc, generator)
        # the atlas prior joins without dropout (nets.py:222-223)
        x = torch.cat([x, atlas.to(x.dtype)], dim=1)
        x = F.prelu(self.fc2(x), self.prelu_f2)
        return self.out(x)


@functools.cache
def rounded_to(value: float, dtype: torch.dtype) -> float:
    """``value`` as ``torch.tensor(value, dtype=dtype).item()`` gives it
    (to float32 first, then to a narrower dtype, each to nearest with ties
    to even), computed on the host without a tensor, so that a train step
    that uses it reads nothing back from a device."""
    if dtype == torch.float64:
        return value
    value = struct.unpack("f", struct.pack("f", value))[0]
    if dtype == torch.float32 or value == 0.0:
        return value
    # significand bits: eps is 2 ** -(bits - 1)
    bits = 1 - round(math.log2(torch.finfo(dtype).eps))
    mantissa, exponent = math.frexp(value)
    return math.ldexp(round(mantissa * 2 ** bits), exponent - bits)


@torch.no_grad()
def update_bn_ema(net: TriPlanarNet) -> None:
    """Fold each BN layer's last batch statistics into its stored (mean,
    inv_std): stored = (1 - alpha) * stored + alpha * batch, Lasagne's
    running average (triplanar.py:351-366), in place. The stored values
    stay float32; ``alpha * batch`` is taken in the batch's dtype, alpha
    rounded to it (:func:`rounded_to`), as the JAX package takes it.
    Layers without new statistics keep theirs; the statistics are
    consumed."""
    stored, batch = [], []
    for m in net.modules():
        if isinstance(m, _BatchNorm) and m.batch_stats is not None:
            stored += [m.mean, m.inv_std]
            batch += m.batch_stats
            m.batch_stats = None
    if stored:
        a = net.spec.bn_alpha
        a_batch = rounded_to(a, batch[0].dtype)
        torch._foreach_mul_(stored, 1 - a)
        torch._foreach_add_(stored, [t.to(s.dtype) for s, t in zip(
            stored, torch._foreach_mul(batch, a_batch))])


def init_params(spec: TriPlanarSpec = DEFAULT_SPEC,
                generator: Optional[torch.Generator] = None) -> Params:
    """Fresh parameters with Lasagne's default initializers (what
    ``build_model``, nets.py:127-255, starts from): GlorotUniform for conv
    and dense weights, zero biases, PReLU alpha 0.25, BN (beta 0, gamma 1,
    mean 0, inv_std 1). Same shapes as the JAX package's ``init_params``;
    the numbers differ, because the random streams do."""
    shapes = TriPlanarNet(spec, device="meta").state_dict()
    params: Params = {}
    for key, meta in shapes.items():
        name = key.rsplit(".", 1)[-1]
        if name == "weight":
            # conv OIHW / dense (out, in): Lasagne's fan_in = in * receptive
            # field, fan_out = out * receptive field
            receptive = math.prod(meta.shape[2:])
            fan_in, fan_out = meta.shape[1] * receptive, meta.shape[0] * receptive
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            t = torch.empty(meta.shape).uniform_(-limit, limit,
                                                 generator=generator)
        elif name.startswith("prelu"):
            t = torch.full(meta.shape, 0.25)
        elif name in ("gamma", "inv_std"):
            t = torch.ones(meta.shape)
        else:  # bias, beta, mean
            t = torch.zeros(meta.shape)
        params[key] = t
    return params


def num_params(params: Params) -> int:
    return sum(int(t.numel()) for t in params.values())


# Migration shims for the reference's net.predict_proba / net.predict -------
def _batch_inputs(net: TriPlanarNet, batch: Dict[str, object]):
    """The four inputs of a predict ``batch`` (triplanar.py:305-322) on the
    net's device and in its dtype: the framework's keys
    (axial/coronal/sagittal/atlas) or the reference's nolearn input names
    (in1..in4, base.py:425-428). Patches may be (N, ps, ps), (N, ps, ps, 1)
    or the reference's NCHW (N, 1, ps, ps); numpy arrays or tensors."""
    param = next(net.parameters())

    def get(new, ref):
        x = batch.get(new, batch.get(ref))
        if x is None:
            raise KeyError(f"batch missing input '{new}'/'{ref}'")
        return torch.as_tensor(x).to(param.device, param.dtype)

    def patches(x):
        c = net.spec.num_channels
        if x.dim() == 4 and x.shape[-1] == c:
            return x[..., 0]
        if x.dim() == 4 and x.shape[1] == c:
            return x[:, 0]
        return x

    return (patches(get("axial", "in1")), patches(get("coronal", "in2")),
            patches(get("sagittal", "in3")), get("atlas", "in4"))


@torch.no_grad()
def predict_proba(net: TriPlanarNet, batch: Dict[str, object],
                  return_logits: bool = False) -> torch.Tensor:
    """Inference-mode softmax probabilities (or logits) of a patch batch
    (reference: ``net.predict_proba``), in one forward."""
    with exact_float32():
        return net.eval()(*_batch_inputs(net, batch),
                          return_logits=return_logits)


def predict(net: TriPlanarNet, batch: Dict[str, object]) -> torch.Tensor:
    """Argmax class ids of a patch batch (reference: ``net.predict``)."""
    return predict_proba(net, batch, return_logits=True).argmax(dim=-1)


@torch.no_grad()
def predict_proba_chunked(net: TriPlanarNet, batch: Dict[str, object],
                          chunk: int = 8192) -> torch.Tensor:
    """:func:`predict_proba` over ``chunk``-row slices of an arbitrarily
    large batch, so activations stay bounded (the reference fed 100k-patch
    batches that nolearn re-chunked at 128, base.py:379,425). Torch has no
    static shapes, so the last slice is short instead of padded."""
    inputs = _batch_inputs(net, batch)
    net.eval()
    with exact_float32():
        return torch.cat([net(*(x[i:i + chunk] for x in inputs))
                          for i in range(0, max(len(inputs[0]), 1), chunk)])
