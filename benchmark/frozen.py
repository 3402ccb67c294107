"""Frozen copies of the program's generators and arithmetic.

The benchmark's yardstick must not move when the program does, so what it
needs of the program's own sound generators and counts is copied here, each
with the file and lines it was copied from. The CPU tests in
``benchmark/tests/test_frozen.py`` hold the copies to the originals on fixed
inputs; a later change to an original that makes them differ is a change to
the program, not to the yardstick.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

MNI_SHAPE = (181, 217, 181)
HALF = 16           # patch half-width: padded index = original + HALF
PATCH = 32
RF = 31             # receptive field of the dense branch
DILATE_CROP = 10    # candidates: the atlas ROI dilated 10 times


def make_scan(rng: np.random.Generator, shape=MNI_SHAPE):
    """MNI-sized synthetic int16 T1, 15-channel prior atlas and sub-cortical
    ROI. Copy of subcort_tpu_torch/bench/scan.py:65-84 (``make_scan``),
    with the shape as an argument: a brain ellipsoid of uniform intensities
    in [100, 900), channel 14 = 1 outside an ellipsoidal ROI whose rows are
    random normalized priors."""
    image = np.zeros(shape, np.int16)
    sx, sy, sz = shape
    x, y, z = np.ogrid[:sx, :sy, :sz]
    # the original's radii, scaled with the shape (identity at MNI size)
    f = np.asarray(shape, np.float64) / np.asarray(MNI_SHAPE, np.float64)
    brain = (((x - 90 * f[0]) / (80.0 * f[0])) ** 2
             + ((y - 108 * f[1]) / (95.0 * f[1])) ** 2
             + ((z - 90 * f[2]) / (78.0 * f[2])) ** 2) < 1.0
    image[brain] = (rng.random(int(brain.sum())) * 800 + 100).astype(np.int16)

    atlas = np.zeros(tuple(shape) + (15,), np.float32)
    atlas[..., 14] = 1.0
    roi = (((x - 90 * f[0]) / (28.0 * f[0])) ** 2
           + ((y - 108 * f[1]) / (32.0 * f[1])) ** 2
           + ((z - 90 * f[2]) / (26.0 * f[2])) ** 2) < 1.0
    pri = rng.random((int(roi.sum()), 15)).astype(np.float32)
    pri /= pri.sum(1, keepdims=True)
    atlas[roi] = pri
    return image, atlas, roi


def candidates(roi: np.ndarray, iterations: int = DILATE_CROP) -> np.ndarray:
    """(N, 3) int32 candidate voxels in C order: the ROI dilated
    ``iterations`` times (subcort_tpu_torch/bench/scan.py:132-133, the
    reference's crop, base.py:369)."""
    mask = ndimage.binary_dilation(roi, iterations=iterations)
    return np.stack(np.nonzero(mask), axis=1).astype(np.int32)


def make_index(generator: torch.Generator, n_samples: int,
               n_subjects: int = 4, shape=MNI_SHAPE):
    """The training set of subcort_tpu_torch/bench/train.py:38-59
    (``make_index``): ``n_subjects`` standard-normal volumes padded by
    HALF, and ``n_samples`` rows of a uniform subject and voxel, a uniform
    label in [0, 15) and a uniform 15-vector of priors. The geometry and
    the distributions are the original's; the draws come from a
    ``torch.Generator`` on the device (a few large calls) and are returned
    as host arrays, which is what the trainer takes."""
    dev = generator.device
    sx, sy, sz = shape
    volumes = torch.randn((n_subjects, sx + 2 * HALF, sy + 2 * HALF,
                           sz + 2 * HALF), generator=generator, device=dev)
    cols = [torch.randint(0, hi, (n_samples,), generator=generator,
                          device=dev) for hi in (n_subjects, sx, sy, sz)]
    centers = torch.stack(cols, 1).to(torch.int32)
    labels = torch.randint(0, 15, (n_samples,), generator=generator,
                           device=dev).to(torch.int32)
    atlas = torch.rand((n_samples, 15), generator=generator, device=dev)
    return (volumes.cpu().numpy(), centers.cpu().numpy(),
            labels.cpu().numpy(), atlas.cpu().numpy())


def train_split_stratified(labels: np.ndarray, eval_size: float):
    """nolearn's TrainSplit: per class, the first ceil(n / k) occurrences
    go to validation, k = round(1 / eval_size). Copy of
    subcort_tpu_torch/engine/train.py:414-427."""
    if eval_size <= 0:
        return np.arange(len(labels)), np.arange(0)
    k = max(2, int(round(1.0 / eval_size)))
    valid = np.zeros(len(labels), bool)
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        valid[idx[:int(np.ceil(idx.size / k))]] = True
    return np.flatnonzero(~valid), np.flatnonzero(valid)


def bbox_of(centers: np.ndarray, shape, align: int = 16):
    """Tight bbox of the candidates, dims rounded up to ``align`` and
    clamped inside the volume. Copy of
    subcort_tpu_torch/engine/infer.py:131-140 (``_bbox_of``)."""
    lo = centers.min(axis=0)
    dims = centers.max(axis=0) + 1 - lo
    dims = np.minimum(-(-dims // align) * align, np.asarray(shape))
    lo = np.maximum(np.minimum(lo, np.asarray(shape) - dims), 0)
    return lo.astype(np.int32), tuple(int(d) for d in dims)


def slab_flops(bbox_dims, m_rows: int, conv_filters=(20, 20, 40, 40, 60),
               fc_conv: int = 180, fc_fc: int = 540, fc2: int = 270,
               n_classes: int = 15, atlas_dim: int = 15) -> int:
    """FLOPs (2 x MACs) of one dense à-trous slab: the three branches over
    their (batch, plane + halo) extents plus the head MLP over ``m_rows``
    candidate rows; BN, PReLU and pools left out. Copy of
    subcort_tpu_torch/models/fcn.py:174-204 (``slab_flops``), with the
    widths as arguments."""
    bx, by, bz = (int(d) for d in bbox_dims)
    dil = (1, 1, 2, 2, 4)
    convs, cin = [], 1
    for cout, d in zip(conv_filters, dil):
        convs.append((cin, cout, d))
        cin = cout
    total = 0
    for b, h, w in ((bz, bx, by), (by, bx, bz), (bx, by, bz)):
        p, q = h + RF, w + RF
        for i, (ci, co, d) in enumerate(convs, start=1):
            p -= 2 * d
            q -= 2 * d
            total += 2 * b * p * q * ci * co * 9
            if i == 2:
                p -= 1
                q -= 1
            elif i == 4:
                p -= 2
                q -= 2
        p -= 8
        q -= 8
        total += 2 * b * p * q * cin * fc_conv * 9
        if (p, q) != (h, w):
            raise ValueError("receptive-field accounting drifted")
    f3 = 3 * fc_conv
    total += 2 * int(m_rows) * (f3 * fc_fc + (fc_fc + atlas_dim) * fc2
                                + fc2 * n_classes)
    return total


def patch_forward_flops(conv_filters=(20, 20, 40, 40, 60), fc_conv=180,
                        fc_fc=540, fc2=270, n_classes=15, atlas_dim=15,
                        patch=PATCH):
    """(total, first-conv) FLOPs (2 x MACs) of one tri-planar patch forward:
    per branch five valid 3x3 convs with 2x2 pools after the second and
    fourth and the dense layer from the last conv's map, three branches,
    then the head (FC fc_fc, FC fc2 after the atlas joins, FC classes).
    At the published widths: 11,505,600 a branch, 891,000 the head,
    35,407,800 in all; the first conv of each branch is 324,000."""
    side, cin, branch, first = patch, 1, 0, 0
    for i, cout in enumerate(conv_filters, start=1):
        side -= 2
        f = 2 * side * side * cin * cout * 9
        branch += f
        if i == 1:
            first = f
        if i in (2, 4):
            side //= 2
        cin = cout
    branch += 2 * side * side * cin * fc_conv
    head = 2 * (3 * fc_conv * fc_fc + (fc_fc + atlas_dim) * fc2
                + fc2 * n_classes)
    return 3 * branch + head, 3 * first


def window_index(centers: torch.Tensor, padded_shape) -> torch.Tensor:
    """(N, 3, 32, 32) int64 linear indices of the axial, coronal and sagittal
    windows of ``centers`` ((N, 3), or (N, 4) with a subject column) in a
    contiguous padded volume or stack. Copy of
    subcort_tpu_torch/ops/gather_kernel.py:116-135."""
    shape = tuple(int(d) for d in padded_shape)
    xp, yp, zp = shape[-3:]
    c = centers.long()
    s = c[:, 0] if c.shape[1] == 4 else torch.zeros_like(c[:, 0])
    x, y, z = (c[:, k, None, None] for k in (-3, -2, -1))
    i = torch.arange(PATCH, device=c.device)[:, None]
    j = torch.arange(PATCH, device=c.device)[None, :]
    base = s[:, None, None] * xp

    def lin(a, b, d):
        return ((base + a) * yp + b) * zp + d

    return torch.stack([lin(x + i, y + j, z + HALF),
                        lin(x + i, y + HALF, z + j),
                        lin(x + HALF, y + i, z + j)], 1)


OUT_BYTES_PER_CENTER = 3 * PATCH * PATCH * 4


def gather_roofline_bytes(centers: torch.Tensor, padded_shape) -> int:
    """Bytes the tri-planar gather must move at least: every distinct
    padded-volume voxel a window touches, read once, plus three float32
    32x32 windows written per center. Copy of
    subcort_tpu_torch/ops/gather_kernel.py:138-148."""
    shape = tuple(int(d) for d in padded_shape)
    n = int(centers.shape[0])
    touched = torch.zeros(int(np.prod(shape)), dtype=torch.bool,
                          device=centers.device)
    if n:
        touched[window_index(centers, shape).reshape(-1)] = True
    return int(touched.sum()) * 4 + n * OUT_BYTES_PER_CENTER
