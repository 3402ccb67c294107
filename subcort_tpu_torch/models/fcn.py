"""À-trous fully-convolutional evaluator: the dense inference path.

Port of subcort_tpu/models/fcn.py. Each 2D branch of the tri-planar CNN is
evaluated densely over whole slices by the à-trous transformation of its
stride-2-pooled patch network (all VALID):

    patch net                      dense equivalent
    ---------                      ----------------
    conv1, conv2 3x3               conv 3x3, dilation 1
    maxpool k2 s2                  maxpool k2, stride 1, dilation 1
    conv3, conv4 3x3               conv 3x3, dilation 2
    maxpool k2 s2                  maxpool k2, stride 1, dilation 2
    conv5 3x3                      conv 3x3, dilation 4
    dense 540->180                 conv 3x3, dilation 4, 60->180 channels

For a slab plane of extent (H+31, W+31) the dense output has extent
(H, W), and output (i, j) equals the patch branch at the patch whose
window starts at slab (i, j): a receptive field of ``RF = 31``, the patch
centered at index ``HALF = 16``. The branches read the parameters of the
patch engine's :class:`~subcort_tpu_torch.models.triplanar.TriPlanarNet`,
so both engines share one set of weights.

The compute dtype is the net's parameter dtype: float32, or bfloat16 when
the caller cast the net (convs and matmuls accumulate in float32 there,
as cuDNN and cuBLAS do for bfloat16). ``SLABS`` counts calls of
:func:`fcn_forward_slab`.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from subcort_tpu_torch.models.triplanar import (DEFAULT_SPEC, TriPlanarNet,
                                                TriPlanarSpec, _Branch)
from subcort_tpu_torch.utils.runtime import check_nans

RF = 31  # receptive field of the dense branch (patch 32, even-centered)
HALF = 16
DILATIONS = (1, 1, 2, 2, 4)
HEAD_CHUNK = 65536

SLABS = 0
_SLABS_LOCK = threading.Lock()  # the multi-device paths call from threads


def dense_branch_features(branch: _Branch, slab: torch.Tensor) -> torch.Tensor:
    """One branch evaluated densely: (B, 1, H+RF, W+RF) image planes ->
    (B, fc_conv, H, W) per-pixel branch features (JAX: (B, H, W, F)). BN
    and PReLU go through the branch's own :meth:`_Branch.bn_prelu`, as in
    the patch engine."""
    x = slab
    for i, d in enumerate(DILATIONS, start=1):
        x = F.conv2d(x, getattr(branch, f"conv{i}").weight, dilation=d)
        x = branch.bn_prelu(i, x)
        if i == 2:
            x = F.max_pool2d(x, 2, stride=1)
        elif i == 4:
            x = F.max_pool2d(x, 2, stride=1, dilation=2)
    # dense 540->180 as a 3x3 dilation-4 conv: d1's columns are Lasagne's
    # (c, h, w) flatten, so the view is already the OIHW kernel
    w = branch.d1.weight.view(branch.d1.out_features, x.shape[1], 3, 3)
    return F.prelu(F.conv2d(x, w, branch.d1.bias, dilation=4),
                   branch.prelu_d1)


def dequantize_priors(vecs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Prior rows in ``dtype`` (fcn.py:221-229): uint16 fixed point in
    float32 (65535 is not a bfloat16 value), then cast; uint8 in ``dtype``;
    anything else a plain cast. The scale is a constant of the working
    dtype, as JAX's weakly typed literal is."""
    if vecs.dtype == torch.uint8:
        one = torch.tensor(1.0 / 255.0, dtype=dtype, device=vecs.device)
        return vecs.to(dtype) * one
    if vecs.dtype == torch.uint16:
        one = torch.tensor(1.0 / 65535.0, dtype=torch.float32,
                           device=vecs.device)
        return (vecs.to(torch.float32) * one).to(dtype)
    return vecs.to(dtype)


def _normalize_slab(slab: torch.Tensor, scale: torch.Tensor,
                    lo: Sequence[int], hi: Sequence[int],
                    dtype: torch.dtype) -> torch.Tensor:
    """``(x - mean) * inv_std`` in float32 on a raw slab, zero outside
    ``[lo, hi)`` on each axis (outside the source volume), then ``dtype``
    (fcn.py:179-192)."""
    x = (slab.to(torch.float32) - scale[0]) * scale[1]
    mx, my, mz = ((ii >= int(a)) & (ii < int(b)) for ii, a, b in zip(
        (torch.arange(s, device=slab.device) for s in slab.shape), lo, hi))
    mask = mx[:, None, None] & my[None, :, None] & mz[None, None, :]
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device)).to(dtype)


@torch.inference_mode()
def fcn_forward_slab(net: TriPlanarNet, slab: torch.Tensor,
                     atlas_vecs: torch.Tensor, want_probs: bool = False,
                     head_chunk: int = HEAD_CHUNK,
                     probs_dtype: torch.dtype = torch.float32,
                     gather_idx: Optional[torch.Tensor] = None,
                     norm: Optional[Tuple] = None):
    """Dense tri-planar forward over a pre-cut slab (fcn.py:120-292).

    ``slab``: (bx+RF, by+RF, bz+RF) normalized intensities covering the
    bbox plus its 16/15-voxel patch context, zero outside the volume. With
    ``norm = (scale, lo, hi)`` (a float32 (2,) tensor [mean, 1/std] and
    two 3-int sequences) the slab is the raw scan and is normalized here.
    ``atlas_vecs``: (M, C) prior rows, float or uint8/uint16 fixed point;
    M = bx*by*bz in C order without ``gather_idx``, else one row per
    int64 linear bbox index in ``gather_idx`` (the head then runs only at
    those voxels).

    Returns (labels uint8, probs in ``probs_dtype`` or None): labels
    (bx, by, bz) and probs (bx*by*bz, C) in dense mode, (M,) and (M, C)
    with ``gather_idx``. Labels are the argmax of the logits; uint8 probs
    are ``round(p * 255)``, taken once after the head loop.
    """
    global SLABS
    with _SLABS_LOCK:
        SLABS += 1
    dtype = next(net.parameters()).dtype
    if norm is not None:
        scale, lo, hi = norm
        slab = _normalize_slab(slab, scale, lo, hi, dtype)
    else:
        slab = slab.to(dtype)
    atlas_vecs = dequantize_priors(atlas_vecs, dtype)
    bx, by, bz = (int(s) - RF for s in slab.shape)
    n = bx * by * bz

    def flat(features: torch.Tensor, order) -> torch.Tensor:
        # (batch, F, p, q) -> (n or M, F) rows in bbox C order
        f = features.permute(order).reshape(n, -1)
        return f if gather_idx is None else f.index_select(0, gather_idx)

    # axial: batch over z, planes (x, y); the z batch needs no halo
    fa = dense_branch_features(
        net.axial, slab[:, :, HALF:HALF + bz].permute(2, 0, 1).unsqueeze(1))
    fa = flat(fa, (2, 3, 0, 1))                      # (bz, F, bx, by)
    # coronal: batch over y, planes (x, z)
    fc = dense_branch_features(
        net.coronal, slab[:, HALF:HALF + by, :].permute(1, 0, 2).unsqueeze(1))
    fc = flat(fc, (2, 0, 3, 1))                      # (by, F, bx, bz)
    # sagittal: batch over x, planes (y, z)
    fs = dense_branch_features(net.sagittal,
                               slab[HALF:HALF + bx].unsqueeze(1))
    fs = flat(fs, (0, 2, 3, 1))                      # (bx, F, by, bz)
    feats = torch.cat([fa, fc, fs], dim=1)           # (n or M, 3F)
    del fa, fc, fs

    m = feats.shape[0]
    labels = torch.empty(m, dtype=torch.uint8, device=slab.device)
    probs = None
    if want_probs:
        store = torch.float32 if probs_dtype == torch.uint8 else probs_dtype
        probs = torch.empty((m, net.spec.num_classes), dtype=store,
                            device=slab.device)
    for start in range(0, m, head_chunk):
        stop = min(start + head_chunk, m)
        logits = net.head(feats[start:stop], atlas_vecs[start:stop])
        check_nans("the dense evaluator's logits", logits)
        labels[start:stop] = logits.argmax(dim=1)
        if want_probs:
            probs[start:stop] = torch.softmax(logits, dim=-1)
    if want_probs and probs_dtype == torch.uint8:
        probs = torch.round(probs * 255.0).to(torch.uint8)
    if gather_idx is None:
        labels = labels.view(bx, by, bz)
    return labels, probs


def slab_flops(bbox_dims: Tuple[int, int, int], m_rows: int = None,
               spec: TriPlanarSpec = DEFAULT_SPEC, n_classes: int = 15) -> int:
    """Analytic FLOP count (2 x MACs) of one :func:`fcn_forward_slab`
    call (copy of fcn.py:295-330): the three dense branches over their
    (batch, plane+halo) extents plus the head MLP over ``m_rows`` voxels
    (``None``: every bbox voxel). BN, PReLU and pools are left out."""
    bx, by, bz = (int(d) for d in bbox_dims)
    fc = spec.fc_conv
    views = ((bz, bx, by), (by, bx, bz), (bx, by, bz))
    convs = [(1, 20, 1), (20, 20, 1), (20, 40, 2), (40, 40, 2), (40, 60, 4)]
    total = 0
    for b, h, w in views:
        p, q = h + RF, w + RF
        for i, (cin, cout, d) in enumerate(convs, start=1):
            p -= 2 * d
            q -= 2 * d
            total += 2 * b * p * q * cin * cout * 9
            if i == 2:      # maxpool k2 s1 dil1
                p -= 1
                q -= 1
            elif i == 4:    # maxpool k2 s1 dil2
                p -= 2
                q -= 2
        p -= 8              # dense 540->fc as 3x3 dil-4 conv
        q -= 8
        total += 2 * b * p * q * 60 * fc * 9
        assert (p, q) == (h, w), "receptive-field accounting drifted"
    m = bx * by * bz if m_rows is None else int(m_rows)
    f3 = 3 * fc
    total += 2 * m * (f3 * f3 + (f3 + n_classes) * 270 + 270 * n_classes)
    return total


def fcn_forward_bbox(net: TriPlanarNet, padded_vol: torch.Tensor,
                     bbox_origin, bbox_shape: Tuple[int, int, int],
                     atlas_vecs: torch.Tensor, want_probs: bool = False,
                     head_chunk: int = HEAD_CHUNK):
    """:func:`fcn_forward_slab` on the slab cut from a ``pad_volume``-padded
    volume (padded index = original + HALF, so the slab for origin
    (x0, y0, z0) starts at padded (x0, y0, z0))."""
    x0, y0, z0 = (int(o) for o in bbox_origin)
    bx, by, bz = bbox_shape
    slab = padded_vol[x0:x0 + bx + RF, y0:y0 + by + RF, z0:z0 + bz + RF]
    return fcn_forward_slab(net, slab, atlas_vecs, want_probs, head_chunk)
