"""SwinUNETR: a 3D shifted-window transformer encoder with a residual CNN
decoder.

Hatamizadeh, Nath, Tang, Yang, Roth and Xu, "Swin UNETR: Swin Transformers
for Semantic Segmentation of Brain Tumors in MRI Images", BrainLes 2021
(LNCS 12962), arXiv:2201.01266; its encoder is the Swin transformer of
Tang et al., CVPR 2022, arXiv:2111.14791. The code it follows is MONAI's
``monai/networks/nets/swin_unetr.py`` (``SwinUNETR``, ``spatial_dims=3``,
``use_v2=False``, ``downsample="merging"``), whose defaults are the
published widths (:class:`SwinUNETRSpec`).

On (N, in, X, Y, Z) volumes, every side a multiple of ``2 ** 5``; tokens
are laid out channels last, ``LN`` is a LayerNorm over the channels
(eps 1e-5), ``C_s = feature * 2 ** s``:

    encoder (``swinViT``)
      h_0 = conv_{k=2,s=2}(x)                  (``patch_embed.proj``, bias)
      stage s (0 .. 3), at C_s and side S_s:
        x = block(x) for ``depths[s]`` blocks, block i shifted if i is odd
        h_{s+1} = merge(x)                      -> C_{s+1}, side S_s / 2
      hidden_s = LN(h_s) without affine         (``proj_out``), s = 0 .. 4
    block (``SwinTransformerBlock``)
      x = x + crop(unroll(reverse(attn(partition(roll(pad(LN_1(x))))))))
      x = x + linear_2(gelu(linear_1(LN_2(x))))     (exact erf GELU, 4 C)
    decoder
      e_0 = res(x), e_1..3 = res(hidden_0..2), d_4 = res(hidden_4)
      d_3 = up(d_4, hidden_3), d_2 = up(d_3, e_3), d_1 = up(d_2, e_2),
      d_0 = up(d_1, e_1), y = up(d_0, e_0); logits = conv_1x1(y) (bias)
    res(x)  (``UnetResBlock``)
      r = IN(conv_1x1(x)) where C_in != C_out, else x
      lrelu(IN(conv_3(lrelu(IN(conv_3(x))))) + r)
    up(x, skip)  (``UnetrUpBlock``)
      res(cat[convT_{k=2,s=2}(x), skip])

where ``conv_3`` is a 3 x 3 x 3 convolution padded by 1 and every
decoder convolution and transposed convolution is without a bias; ``IN``
an instance norm without affine (eps 1e-5); ``lrelu`` a LeakyReLU of
slope 0.01.

**Windows.** Each stage's window is ``window`` (7) a side and its shift
``window // 2`` (3); along an axis whose side is at most the window, the
window is that side and the shift 0 (MONAI's ``get_window_size``). A
block pads the normed tokens with zeros at the end of each axis up to a
multiple of the window (after the norm), rolls them by ``-shift`` in a
shifted block, cuts them into windows of ``n`` tokens (raster order of
windows, then of tokens in a window), attends within each window, and
undoes each step in reverse. A window's attention on its ``n`` tokens:

    q, k, v = split(linear(x, 3 C)) into heads of C / heads channels
    softmax(q / sqrt(C / heads) . k^T + B + M) . v, then linear(C, C)

``B`` is a (2 w - 1)^3 x heads table indexed by the relative coordinate,
``(dx + w - 1) (2 w - 1)^2 + (dy + w - 1) (2 w - 1) + (dz + w - 1)``,
built for the configured window and sliced ``[:n, :n]``, so a clipped
window (n < w^3) reads the first rows and columns of the full index, not
its own geometry (MONAI's behaviour, which 128^3 windows never reach: the
last stage's side is 8 > 7). ``M`` is 0 in unshifted blocks; in shifted
blocks the shift mask of MONAI's ``compute_mask`` on the padded, rolled
grid: the grid split into 3 regions an axis (``[:-w]``, ``[-w:-shift]``,
``[-shift:]``), 27 in all, and -100 between tokens of different regions,
0 within one. Padding tokens are not masked.

**Merging** (MONAI's v1 ``PatchMerging``): the eight strided slices
``x[a::2, b::2, c::2]`` in MONAI's order (0,0,0) (1,0,0) (0,1,0) (0,0,1)
(1,0,1) (0,1,0) (0,0,1) (1,1,1) -- two offsets repeat and two never occur,
as MONAI keeps for its checkpoints -- concatenated to 8 C, then
``LayerNorm(8 C)`` and ``linear(8 C, 2 C)`` without a bias.

Points taken from a transcription of the MONAI source, not checked
against it in this repository (MONAI is not a dependency): the merging
order above, the mask value -100 and its region rule, the relative index
and its ``[:n, :n]`` slice, the norm before the padding, the five hidden
states and their affine-free norm, and the decoder's wiring.

State-dict keys mirror MONAI's module tree
(``swinViT.patch_embed.proj.weight``,
``swinViT.layers1.0.blocks.0.attn.qkv.weight``,
``swinViT.layers1.0.downsample.reduction.weight``,
``encoder1.layer.conv1.conv.weight``,
``decoder5.transp_conv.conv.weight``, ``out.conv.conv.weight``, ...), so
that a MONAI state dict loads with ``load_state_dict(strict=True)``;
MONAI's persistent ``relative_position_index`` buffers, which are derived
from the window, are dropped on load (and checked) and not saved.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, torch.Tensor]

# MONAI's v1 PatchMerging slice offsets, in its order
MERGE_OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1),
                 (0, 1, 0), (0, 0, 1), (1, 1, 1))
MASK_VALUE = -100.0
LN_EPS = 1e-5
IN_EPS = 1e-5
SLOPE = 0.01


@dataclasses.dataclass(frozen=True)
class SwinUNETRSpec:
    """MONAI ``SwinUNETR``'s arguments: the published widths by default,
    with one input channel and the port's 15 classes."""
    feature_size: int = 48
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 2
    mlp_ratio: float = 4.0
    in_channels: int = 1
    out_channels: int = 15

    def dim(self, stage: int) -> int:
        return self.feature_size * 2 ** stage


DEFAULT_SPEC = SwinUNETRSpec()


# ------------------------------------------------------------ the windows
def window_and_shift(side: Tuple[int, ...], window: int, shift: int):
    """(window, shift) a side of a stage of ``side``: the configured ones,
    or the side and 0 along an axis whose side is at most the window."""
    w = tuple(s if s <= window else window for s in side)
    sh = tuple(0 if s <= window else shift for s in side)
    return w, sh


def window_partition(x: torch.Tensor, w) -> torch.Tensor:
    """(B, D, H, W, C) with each side a multiple of ``w`` -> (B * windows,
    w0 w1 w2, C): windows in raster order, tokens in raster order in
    each."""
    b, d, h, wd, c = x.shape
    x = x.view(b, d // w[0], w[0], h // w[1], w[1], wd // w[2], w[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, w[0] * w[1] * w[2],
                                                     c)


def window_reverse(windows: torch.Tensor, w, dims) -> torch.Tensor:
    """:func:`window_partition`'s inverse: -> (B, D, H, W, C)."""
    b, d, h, wd = dims
    x = windows.view(b, d // w[0], h // w[1], wd // w[2], w[0], w[1], w[2],
                     -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, wd, -1)


def relative_position_index(window: int) -> torch.Tensor:
    """(w^3, w^3) int64: the bias table's row of each pair of tokens of a
    configured window."""
    coords = torch.stack(torch.meshgrid(
        *(torch.arange(window),) * 3, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (window - 1)
    m = 2 * window - 1
    return rel[..., 0] * m * m + rel[..., 1] * m + rel[..., 2]


def shift_mask(padded, w, shift, device) -> torch.Tensor:
    """(windows, n, n) float32: MONAI's ``compute_mask`` on the padded
    grid ``padded`` (0 within a region, :data:`MASK_VALUE` across)."""
    img = torch.zeros((1,) + tuple(padded) + (1,), device=device)
    cnt = 0
    spans = [(slice(-wa), slice(-wa, -sa), slice(-sa, None))
             for wa, sa in zip(w, shift)]
    for a in spans[0]:
        for b in spans[1]:
            for c in spans[2]:
                img[:, a, b, c, :] = cnt
                cnt += 1
    regions = window_partition(img, w).squeeze(-1)
    diff = regions.unsqueeze(1) - regions.unsqueeze(2)
    return torch.where(diff != 0, MASK_VALUE, 0.0).to(torch.float32)


# ------------------------------------------------------------ the encoder
class WindowAttention(nn.Module):
    """Multi-head self-attention within windows, with the relative
    position bias (``attn``)."""

    def __init__(self, dim: int, heads: int, window: int, device=None):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * window - 1) ** 3, heads, device=device))
        self.register_buffer("relative_position_index",
                             relative_position_index(window).to(
                                 "cpu" if device == "meta" else device),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=True, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def _load_from_state_dict(self, state_dict, prefix, *args):
        # MONAI saves the index as a buffer; it is derived from the window
        key = prefix + "relative_position_index"
        if key in state_dict:
            given = state_dict.pop(key)
            if not torch.equal(given.cpu().long(),
                               self.relative_position_index.cpu()):
                raise ValueError(f"{key} is not the index of the window")
        super()._load_from_state_dict(state_dict, prefix, *args)

    def bias(self, n: int) -> torch.Tensor:
        """(heads, n, n): the table's rows for the index sliced to n."""
        idx = self.relative_position_index[:n, :n].reshape(-1)
        return self.relative_position_bias_table[idx].view(
            n, n, -1).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        del q, k, qkv
        attn += self.bias(n)
        if mask is not None:
            nw = mask.shape[0]
            attn.view(b // nw, nw, self.heads, n, n).add_(
                mask[None, :, None])
        attn = torch.softmax(attn, -1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        del attn
        return self.proj(out)


class MLPBlock(nn.Module):
    """``linear2(gelu(linear1(x)))`` (``mlp``)."""

    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden, device=device)
        self.linear2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x)))


def _roll(x: torch.Tensor, shift, sign: int) -> torch.Tensor:
    """``x`` (B, D, H, W, C) rolled by ``sign * shift`` on the spatial
    axes."""
    return torch.roll(x, tuple(sign * s for s in shift), dims=(1, 2, 3))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shifted: bool,
                 mlp_ratio: float, device=None):
        super().__init__()
        self.window = window
        self.shift = window // 2 if shifted else 0
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = WindowAttention(dim, heads, window, device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), device)

    def attn_part(self, x: torch.Tensor, mask) -> torch.Tensor:
        b, d, h, wd, c = x.shape
        w, shift = window_and_shift((d, h, wd), self.window, self.shift)
        x = self.norm1(x)
        pad = [(-s) % wa for s, wa in zip((d, h, wd), w)]
        if any(pad):
            x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        dims = (b,) + tuple(x.shape[1:4])
        shifted = any(shift)
        if shifted:
            x = _roll(x, shift, -1)
        out = self.attn(window_partition(x, w), mask if shifted else None)
        del x
        x = window_reverse(out, w, dims)
        if shifted:
            x = _roll(x, shift, 1)
        if any(pad):
            x = x[:, :d, :h, :wd]
        return x

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        x = x + self.attn_part(x, mask)
        return x + self.mlp(self.norm2(x))


def _merge_slices(x: torch.Tensor) -> list:
    """The eight strided slices of (B, D, H, W, C), in MONAI's order."""
    return [x[:, a::2, b::2, c::2] for a, b, c in MERGE_OFFSETS]


class PatchMerging(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=LN_EPS, device=device)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False,
                                   device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, d, h, w, _ = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        return self.reduction(self.norm(torch.cat(_merge_slices(x), -1)))


class BasicLayer(nn.Module):
    """A stage: its blocks, then merging (``layers<s+1>.0``)."""

    def __init__(self, spec: SwinUNETRSpec, stage: int, device=None):
        super().__init__()
        dim = spec.dim(stage)
        self.window = spec.window_size
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, spec.num_heads[stage], spec.window_size,
                                 i % 2 == 1, spec.mlp_ratio, device)
            for i in range(spec.depths[stage]))
        self.downsample = PatchMerging(dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, D, H, W) -> (B, 2 C, D / 2, H / 2, W / 2)."""
        side = tuple(x.shape[2:])
        w, shift = window_and_shift(side, self.window, self.window // 2)
        padded = [-(-s // wa) * wa for s, wa in zip(side, w)]
        mask = shift_mask(padded, w, shift, x.device) if any(shift) else None
        x = x.permute(0, 2, 3, 4, 1)
        for blk in self.blocks:
            x = blk(x, mask)
        return self.downsample(x).permute(0, 4, 1, 2, 3)


class PatchEmbed(nn.Module):
    def __init__(self, spec: SwinUNETRSpec, device=None):
        super().__init__()
        p = spec.patch_size
        self.proj = nn.Conv3d(spec.in_channels, spec.feature_size, p,
                              stride=p, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


def proj_out(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) normed over C, without affine."""
    return F.layer_norm(x.permute(0, 2, 3, 4, 1), x.shape[1:2]).permute(
        0, 4, 1, 2, 3)


class SwinTransformer(nn.Module):
    """The encoder (``swinViT``): the five hidden states."""

    def __init__(self, spec: SwinUNETRSpec, device=None):
        super().__init__()
        self.patch_embed = PatchEmbed(spec, device)
        for s in range(len(spec.depths)):
            setattr(self, f"layers{s + 1}",
                    nn.ModuleList([BasicLayer(spec, s, device)]))
        self.stages = len(spec.depths)

    def forward(self, x: torch.Tensor) -> list:
        x = self.patch_embed(x)
        hidden = [proj_out(x)]
        for s in range(self.stages):
            x = getattr(self, f"layers{s + 1}")[0](x)
            hidden.append(proj_out(x))
        return hidden


# ------------------------------------------------------------ the decoder
class _Conv(nn.Module):
    """MONAI's ``Convolution`` holding one ``conv`` (its ``.conv`` key)."""

    def __init__(self, c_in: int, c_out: int, k: int, bias: bool = False,
                 transposed: bool = False, device=None):
        super().__init__()
        if transposed:
            self.conv = nn.ConvTranspose3d(c_in, c_out, k, stride=k,
                                           bias=bias, device=device)
        else:
            self.conv = nn.Conv3d(c_in, c_out, k, padding=k // 2, bias=bias,
                                  device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    return F.instance_norm(x, eps=IN_EPS)


class UnetResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.conv1 = _Conv(c_in, c_out, 3, device=device)
        self.conv2 = _Conv(c_out, c_out, 3, device=device)
        self.residual = c_in != c_out
        if self.residual:
            self.conv3 = _Conv(c_in, c_out, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu_(_instance_norm(self.conv1(x)), SLOPE)
        out = _instance_norm(self.conv2(out))
        out += _instance_norm(self.conv3(x)) if self.residual else x
        return F.leaky_relu_(out, SLOPE)


class UnetrBasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.layer = UnetResBlock(c_in, c_out, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.transp_conv = _Conv(c_in, c_out, 2, transposed=True,
                                 device=device)
        self.conv_block = UnetResBlock(2 * c_out, c_out, device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], 1))


class UnetOutBlock(nn.Module):
    """The 1 x 1 x 1 convolution to the logits, with a bias."""

    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.conv = _Conv(c_in, c_out, 1, bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class SwinUNETR(nn.Module):
    """(N, in_channels, X, Y, Z) in, (N, out_channels, X, Y, Z) logits
    out; each side a multiple of ``patch_size * 2 ** stages`` (32)."""

    def __init__(self, spec: SwinUNETRSpec = DEFAULT_SPEC, device=None):
        super().__init__()
        if len(spec.depths) != 4 or len(spec.num_heads) != 4:
            raise ValueError("SwinUNETR's decoder takes four stages")
        self.spec = spec
        f = spec.feature_size
        self.swinViT = SwinTransformer(spec, device)
        self.encoder1 = UnetrBasicBlock(spec.in_channels, f, device)
        self.encoder2 = UnetrBasicBlock(f, f, device)
        self.encoder3 = UnetrBasicBlock(2 * f, 2 * f, device)
        self.encoder4 = UnetrBasicBlock(4 * f, 4 * f, device)
        self.encoder10 = UnetrBasicBlock(16 * f, 16 * f, device)
        self.decoder5 = UnetrUpBlock(16 * f, 8 * f, device)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f, device)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f, device)
        self.decoder2 = UnetrUpBlock(2 * f, f, device)
        self.decoder1 = UnetrUpBlock(f, f, device)
        self.out = UnetOutBlock(f, spec.out_channels, device)

    def encode(self, x: torch.Tensor) -> list:
        """The encoder's five hidden states."""
        return self.swinViT(x)

    def decode(self, x: torch.Tensor, hidden: list) -> torch.Tensor:
        """The logits of ``x`` from its hidden states."""
        d = self.encoder10(hidden[4])
        d = self.decoder5(d, hidden[3])
        d = self.decoder4(d, self.encoder4(hidden[2]))
        d = self.decoder3(d, self.encoder3(hidden[1]))
        d = self.decoder2(d, self.encoder2(hidden[0]))
        d = self.decoder1(d, self.encoder1(x))
        return self.out(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(x, self.encode(x))

    @classmethod
    def from_params(cls, params: Params, device=None) -> "SwinUNETR":
        """A net in inference mode on ``device`` holding ``params`` (loaded
        strictly; its widths come from their shapes). ``device=None`` is
        the default card, which raises without one."""
        if device is None:
            from subcort_tpu_torch.config import Options, select_device
            device = select_device(Options())
        net = cls(spec_of(params), device=device)
        net.load_state_dict(params, strict=True)
        return net.eval().requires_grad_(False)


def is_swinunetr_params(params) -> bool:
    """Whether ``params`` is a SwinUNETR state dict (MONAI's names)."""
    return (isinstance(params, dict)
            and "swinViT.patch_embed.proj.weight" in params)


def spec_of(params: Params) -> SwinUNETRSpec:
    """The spec a SwinUNETR state dict was made for, from its shapes."""
    w = params["swinViT.patch_embed.proj.weight"]
    depths, heads = [], []
    for s in range(1, 5):
        n = 0
        while f"swinViT.layers{s}.0.blocks.{n}.norm1.weight" in params:
            n += 1
        depths.append(n)
        heads.append(int(params[f"swinViT.layers{s}.0.blocks.0.attn."
                                "relative_position_bias_table"].shape[1]))
    table = params["swinViT.layers1.0.blocks.0.attn."
                   "relative_position_bias_table"]
    window = (round(table.shape[0] ** (1 / 3)) + 1) // 2
    hidden = params["swinViT.layers1.0.blocks.0.mlp.linear1.weight"]
    return SwinUNETRSpec(
        feature_size=int(w.shape[0]), depths=tuple(depths),
        num_heads=tuple(heads), window_size=window,
        patch_size=int(w.shape[-1]),
        mlp_ratio=hidden.shape[0] / w.shape[0], in_channels=int(w.shape[1]),
        out_channels=int(params["out.conv.conv.weight"].shape[0]))


def num_params(spec: SwinUNETRSpec = DEFAULT_SPEC) -> int:
    """Numbers in the net (its parameters; it holds no statistics)."""
    return sum(t.numel() for t in
               SwinUNETR(spec, device="meta").state_dict().values())


def init_params(spec: SwinUNETRSpec = DEFAULT_SPEC,
                generator: torch.Generator | None = None) -> Params:
    """A seeded state dict on the CPU, MONAI's initialisation: linear
    weights and the bias tables N(0, 0.02) (MONAI's ``trunc_normal_``
    cuts at +-2, which std 0.02 does not reach), linear biases 0,
    LayerNorms 1 and 0, convolutions and their biases PyTorch's default
    (uniform within +-1/sqrt(fan_in))."""
    g = generator if generator is not None else torch.Generator()
    state = SwinUNETR(spec, device="meta").state_dict()
    out = {}
    for key, t in state.items():
        shape = tuple(t.shape)
        weight = state[key.rsplit(".", 1)[0] + ".weight"].shape \
            if key.endswith(".bias") else shape
        if key.endswith("relative_position_bias_table") or len(shape) == 2:
            out[key] = torch.randn(shape, generator=g) * 0.02
        elif len(weight) >= 3:  # a convolution (torch's fan-in for both)
            bound = math.prod(weight[1:]) ** -0.5
            out[key] = (torch.rand(shape, generator=g) * 2 - 1) * bound
        elif key.endswith(".weight"):
            out[key] = torch.ones(shape)
        else:
            out[key] = torch.zeros(shape)
    return out
