"""The synthetic phantom cohort: a numpy copy of
subcort_tpu/registration/atlas.py::make_synthetic_cohort and
make_synthetic_atlas (atlas.py:115-173, 316-362).

The phantom family of ``bench_trainqual.py`` and ``tests/test_trainqual.py``:
a template brain with 14 ellipsoidal structures and its probabilistic
atlas, and subjects made from it by a random shift, an intensity scale and
noise, with their 15-class GT and ``tmp/`` priors. A copy, so that the port
and ``chip_smoke.py`` train on it without the JAX package; the same seed
writes the same cohort as the original (tests/test_torch_data.py).
"""

from __future__ import annotations

import os

import numpy as np

from subcort_tpu_torch.io import NiftiImage, save_nii


def make_synthetic_cohort(root: str, n_subjects: int = 4,
                          shape=(64, 72, 60), seed: int = 0,
                          atlas_dir: str | None = None,
                          noise: float = 8.0, intensity_jitter: float = 0.15,
                          max_shift: int = 3, prior_error: int = 1,
                          write_priors: bool = True):
    """Write a phantom training/inference cohort under ``root``.

    Each subject is the synthetic template under a random integer shift,
    global intensity scale and additive Gaussian noise; its 15-class GT
    (classes 1..14 = structures, 15 = 2-voxel boundary-background ring —
    the reference's restricted-sampling convention, base.py:124,162) is
    derived from the identically shifted atlas. When ``write_priors``, the
    per-subject ``tmp/`` prior volume + subcortical mask are also written —
    shifted by an *additional* ±``prior_error`` voxel registration-error
    jitter, so a model cannot solve the task by copying the prior channel —
    letting training/inference run without the registration subsystem
    (which has its own quality gate, bench_reg.py).

    Returns the list of subject directories.
    """
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    # default atlas assets live BESIDE the cohort, not inside it: every
    # subdirectory of a train/inference folder is treated as a subject
    # (list_training_subjects / load_test_names contract)
    atlas_dir = atlas_dir or (os.path.normpath(root) + "_atlases")
    template, atlas = make_synthetic_atlas(atlas_dir, shape=shape, seed=seed)
    subs = []
    for i in range(n_subjects):
        sub = os.path.join(root, f"s{i:02d}")
        os.makedirs(os.path.join(sub, "tmp"), exist_ok=True)
        off = tuple(int(v) for v in rng.integers(-max_shift, max_shift + 1, 3))
        t1 = np.roll(template, off, axis=(0, 1, 2))
        at = np.roll(atlas, off, axis=(0, 1, 2))
        gt = np.zeros(shape, np.uint8)
        for s in range(14):
            gt[at[..., s] > 0.5] = s + 1
        ring = ndimage.binary_dilation(gt > 0, iterations=2) & (gt == 0)
        gt[ring] = 15
        scale = 1.0 + float(rng.uniform(-intensity_jitter, intensity_jitter))
        t1 = t1 * scale + rng.normal(0, noise, shape) * (t1 > 0)
        t1 = np.clip(t1, 0, None).astype(np.float32)
        save_nii(NiftiImage(t1), os.path.join(sub, "T1.nii.gz"))
        save_nii(NiftiImage(gt), os.path.join(sub, "gt_15_classes.nii.gz"))
        if write_priors:
            perr = tuple(int(v) for v in
                         rng.integers(-prior_error, prior_error + 1, 3))
            pri = np.roll(at, perr, axis=(0, 1, 2)).astype(np.float32)
            save_nii(NiftiImage(pri),
                     os.path.join(sub, "tmp", "MNI_sub_probabilities.nii.gz"))
            # reference mask convention (base.py:544-549): dilate(sum 0:13)
            mask = ndimage.binary_dilation(
                pri[..., :13].sum(-1) > 0, iterations=5).astype(np.uint8)
            save_nii(NiftiImage(mask),
                     os.path.join(sub, "tmp", "MNI_subcortical_mask.nii.gz"))
        subs.append(sub)
    return subs


def make_synthetic_atlas(out_dir: str, shape=(64, 72, 60), seed: int = 0,
                         n_structures: int = 14):
    """Write T1_template.nii.gz + atlas_subcortical_MNI.nii.gz to out_dir.

    Returns (template ndarray, atlas ndarray). The template has a bright
    ellipsoidal "brain" with distinct intensity blobs at each structure
    site; the atlas has a smooth probability bump per structure and a
    background channel filling the remainder.
    """
    rng = np.random.default_rng(seed)
    X, Y, Z = shape
    x, y, z = np.ogrid[:X, :Y, :Z]
    cx, cy, cz = (X - 1) / 2, (Y - 1) / 2, (Z - 1) / 2

    brain = (((x - cx) / (0.45 * X)) ** 2 + ((y - cy) / (0.45 * Y)) ** 2 +
             ((z - cz) / (0.45 * Z)) ** 2) < 1.0
    template = np.zeros(shape, np.float32)
    template[brain] = 400.0

    atlas = np.zeros(shape + (15,), np.float32)
    centers = []
    for s in range(n_structures):
        # structure sites on a ring inside the brain
        ang = 2 * np.pi * s / n_structures
        sx = cx + 0.22 * X * np.cos(ang)
        sy = cy + 0.22 * Y * np.sin(ang)
        sz = cz + 0.10 * Z * np.sin(2 * ang)
        centers.append((sx, sy, sz))
        r2 = (((x - sx) / (0.06 * X)) ** 2 + ((y - sy) / (0.06 * Y)) ** 2 +
              ((z - sz) / (0.08 * Z)) ** 2)
        bump = np.exp(-r2).astype(np.float32)
        atlas[..., s] = np.where(bump > 0.05, bump, 0.0)
        template += (150.0 + 30.0 * s) * np.where(r2 < 1.0, 1.0, 0.0).astype(np.float32)

    template += rng.normal(0, 5.0, shape).astype(np.float32) * brain
    template = np.clip(template, 0, None)

    struct_sum = atlas[..., :14].sum(-1)
    atlas[..., 14] = np.where(brain & (struct_sum < 0.5), 1.0 - struct_sum, 0.0)
    # normalize where any mass exists
    tot = atlas.sum(-1, keepdims=True)
    atlas = np.where(tot > 0, atlas / np.maximum(tot, 1e-6), 0.0).astype(np.float32)

    os.makedirs(out_dir, exist_ok=True)
    save_nii(NiftiImage(template), os.path.join(out_dir, "T1_template.nii.gz"))
    save_nii(NiftiImage(atlas), os.path.join(out_dir, "atlas_subcortical_MNI.nii.gz"))
    return template, atlas
