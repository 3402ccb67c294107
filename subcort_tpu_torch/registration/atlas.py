"""Atlas asset schema, synthetic generators and the degradation kit: a
numpy copy of subcort_tpu/registration/atlas.py.

The real assets (MNI T1 template + 15-channel probabilistic subcortical
atlas) are external data: the reference ships them via git-LFS. Schema:

  T1_template.nii.gz            (X, Y, Z) float, MNI-space T1 intensities
  atlas_subcortical_MNI.nii.gz  (X, Y, Z, 15) float32 probabilities,
                                channels 0..13 = structures, 14 = background

:func:`validate_atlas_assets` and :func:`install_atlas` take user-supplied
assets. The generators write geometrically consistent *synthetic* ones, the
phantom family of ``bench_reg.py``, ``bench_trainqual.py`` and
``tests/test_trainqual.py``: a template brain with 14 ellipsoidal structures
and its probabilistic atlas, and subjects made from it by a random shift, an
intensity scale and noise, with their 15-class GT and ``tmp/`` priors; so
the whole pipeline (affine -> FFD -> prior warping -> ROI mask -> training)
can be validated end to end with known ground truth. A copy, so that the
port and ``chip_smoke.py`` run on it without the JAX package; the same seed
writes the same arrays as the original (tests/test_torch_data.py,
tests/test_torch_registration.py).
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii


class AtlasValidationError(ValueError):
    """A user-supplied atlas asset does not match the required schema."""


def validate_atlas_assets(template_path: str, atlas_path: str):
    """Validate user-supplied MNI assets against the schema the pipeline
    assumes (consumed at base.py:511,528 in the reference):

      template  (X, Y, Z) scalar T1 intensities
      atlas     (X, Y, Z, 15) probabilities, channels 0..13 = structures,
                channel 14 = background, values in [0, 1], same grid as
                the template

    Returns (template NiftiImage, atlas NiftiImage) on success; raises
    AtlasValidationError with an actionable message otherwise.
    """
    for p in (template_path, atlas_path):
        if not os.path.exists(p):
            raise AtlasValidationError(f"{p}: file not found")
    tmpl = load_nii(template_path)
    atlas = load_nii(atlas_path)

    tdata = np.asarray(tmpl.data)
    adata = np.asarray(atlas.data)
    if tdata.ndim == 4 and tdata.shape[3] == 1:
        # (X, Y, Z, 1) writers: squeeze, and propagate the squeezed volume
        # so install_atlas persists a true-3D template (downstream consumers,
        # e.g. the FFD's pyramid reshape, assume exactly 3 dims)
        tdata = tdata[..., 0]
        tmpl = NiftiImage(tdata, tmpl.affine, tmpl.header)
    if tdata.ndim != 3:
        raise AtlasValidationError(
            f"{template_path}: template must be a 3D volume, got shape {tdata.shape}")
    if adata.ndim != 4 or adata.shape[3] != 15:
        raise AtlasValidationError(
            f"{atlas_path}: atlas must be (X, Y, Z, 15) — 14 structure "
            f"channels + background at channel 14 — got shape {adata.shape}")
    if adata.shape[:3] != tdata.shape:
        raise AtlasValidationError(
            f"atlas grid {adata.shape[:3]} does not match template grid "
            f"{tdata.shape}; both must live on the same MNI voxel grid")
    if not np.isfinite(adata).all() or not np.isfinite(tdata).all():
        raise AtlasValidationError("atlas/template contain non-finite values")
    amin, amax = float(adata.min()), float(adata.max())
    if amin < -1e-4 or amax > 1.0 + 1e-4:
        raise AtlasValidationError(
            f"atlas values must be probabilities in [0, 1], got "
            f"[{amin:.4g}, {amax:.4g}]")
    # channel-14 convention: background should dominate OUTSIDE the
    # structures, i.e. carry more total mass than any single structure
    ch_mass = adata.reshape(-1, 15).sum(0)
    if ch_mass[14] < ch_mass[:14].max():
        raise AtlasValidationError(
            "channel 14 carries less mass than a structure channel — it must "
            "be the background channel (reference convention, base.py:392-394); "
            "is the atlas channel order different?")
    if (ch_mass[:14] <= 0).any():
        empty = [int(i) for i in np.where(ch_mass[:14] <= 0)[0]]
        raise AtlasValidationError(
            f"structure channels {empty} are entirely empty")
    return tmpl, atlas


def install_atlas(template_path: str, atlas_path: str,
                  dest_dir: str | None = None) -> str:
    """Validate and install user-supplied atlas assets so the registration
    pipeline finds them (the reference ships them via git-LFS; here they
    are external data). Returns the install directory.

    Assets are written under ``dest_dir`` (default: the package's
    ``atlases/`` directory, the last stop of the resolution order in
    driver._resolve_atlas_dir) with the canonical filenames and float32
    dtype, re-encoded through our own NIfTI writer so downstream readers
    see a uniform encoding.
    """
    from subcort_tpu_torch.registration.driver import (ATLAS_NAME, DEFAULT_ATLAS_DIR,
                                                 TEMPLATE_NAME)
    tmpl, atlas = validate_atlas_assets(template_path, atlas_path)
    dest = dest_dir or DEFAULT_ATLAS_DIR
    os.makedirs(dest, exist_ok=True)
    save_nii(NiftiImage(np.asarray(tmpl.data, np.float32), tmpl.affine),
             os.path.join(dest, TEMPLATE_NAME))
    save_nii(NiftiImage(np.asarray(atlas.data, np.float32), atlas.affine),
             os.path.join(dest, ATLAS_NAME))
    return dest



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


# --------------------------------------------------------------- degradations
# Realistic-acquisition degradation kit: the reference processed real
# MICCAI-2012/IBSR scans, not clean phantoms. Each entry distorts the phantom
# the way a real scanner/protocol does, stressing specific reference
# semantics:
#   bias_field       B1 inhomogeneity: smooth multiplicative ±30% field —
#                    stresses nonzero-μ/σ normalization (base.py:146) and SSD
#                    vs NMI registration (base.py:516-521)
#   rician           magnitude-reconstruction Rician noise (σ ~ 4% of the
#                    intensity range) — sampling + normalization robustness
#   intensity_remap  monotone nonlinear transfer (gamma 1.6): cross-protocol
#                    template-vs-subject relation NMI exists for
#   oblique          rotated sform (direction cosines off-axis) + anisotropic
#                    1x1x1.2 mm voxels — world-space registration correctness
#   int16_scl        int16 storage with scl_slope/inter (the common clinical
#                    encoding) — IO scaling + raw-wire paths
#   combined         all of the above at once (the realistic worst case)

DEGRADATIONS = ("bias_field", "rician", "intensity_remap", "oblique",
                "int16_scl", "combined")


def _smooth_field(shape, rng, scale_vox: float = 12.0) -> np.ndarray:
    """Zero-mean, unit-max-abs smooth random field (low-order modulation)."""
    from scipy import ndimage

    f = ndimage.gaussian_filter(rng.standard_normal(shape), scale_vox)
    f -= f.mean()
    m = np.abs(f).max()
    return f / (m if m > 0 else 1.0)


def apply_degradation(data: np.ndarray, affine: np.ndarray, kind: str,
                      rng: np.random.Generator, strength: float = 1.0):
    """Apply one named degradation to a (X, Y, Z) scan.

    Returns (data, affine, storage) where ``storage`` is None or a dict
    {"dtype": ..., "scl_slope": ..., "scl_inter": ...} describing how the
    volume should be *encoded on disk* (int16_scl). Voxel geometry (the
    voxel->index mapping of structures) is never changed — GT masks defined
    on the input grid stay valid — only intensities, noise, header
    orientation, and storage encoding.
    """
    if kind != "clean" and kind not in DEGRADATIONS:
        raise ValueError(f"unknown degradation {kind!r}; have "
                         f"('clean',) + {DEGRADATIONS}")
    data = np.asarray(data, np.float32).copy()
    affine = np.asarray(affine, np.float64).copy()
    storage = None  # kind == "clean" falls through every branch untouched
    fg = data > 0  # degradations act on the scanned object, not air

    if kind in ("bias_field", "combined"):
        # multiplicative B1 bias: ±30% * strength, smooth across the volume
        field = 1.0 + 0.3 * strength * _smooth_field(data.shape, rng)
        data[fg] = data[fg] * field[fg]

    if kind in ("intensity_remap", "combined"):
        # monotone nonlinear transfer (gamma-like), normalized back to the
        # original max so the remap is a pure shape change
        mx = float(data.max()) or 1.0
        gamma = 1.0 + 0.6 * strength
        data = (mx * (data / mx) ** gamma).astype(np.float32)

    if kind in ("rician", "combined"):
        # Rician: magnitude of a complex signal with iid Gaussian noise on
        # both channels (the MRI magnitude-reconstruction noise model)
        sigma = 0.04 * strength * float(data.max())
        n1 = rng.normal(0.0, sigma, data.shape).astype(np.float32)
        n2 = rng.normal(0.0, sigma, data.shape).astype(np.float32)
        noisy = np.sqrt((data + n1) ** 2 + n2 ** 2)
        data = np.where(fg, noisy, data).astype(np.float32)

    if kind in ("oblique", "combined"):
        # oblique acquisition: rotate the direction cosines ~8° about two
        # axes and make the voxels mildly anisotropic — the voxel grid is
        # untouched, only the world mapping changes
        ax, az = np.deg2rad(8.0 * strength), np.deg2rad(5.0 * strength)
        cx, sx = np.cos(ax), np.sin(ax)
        cz, sz = np.cos(az), np.sin(az)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        affine[:3, :3] = Rz @ Rx @ affine[:3, :3] @ np.diag([1.0, 1.0, 1.2])
        affine[:3, 3] = np.array([-3.0, 2.0, 5.0])

    if kind in ("int16_scl", "combined"):
        # clinical int16 + scl_slope encoding: raw = (v - inter) / slope;
        # readers must reconstruct v = raw * slope + inter (io/nifti.py does
        # on read). Slope chosen to use most of the int16 positive range.
        mx = float(data.max()) or 1.0
        slope = mx / 30000.0
        storage = {"dtype": np.int16, "scl_slope": np.float32(slope),
                   "scl_inter": np.float32(0.0)}

    return data, affine, storage


def save_degraded(data: np.ndarray, affine: np.ndarray, storage, path: str):
    """Write a (possibly storage-encoded) degraded scan to ``path``."""
    if storage is None:
        save_nii(NiftiImage(np.asarray(data, np.float32), affine), path)
        return
    raw = np.round(np.asarray(data, np.float64)
                   / float(storage["scl_slope"])).astype(storage["dtype"])
    save_nii(NiftiImage(raw, affine,
                        header={"scl_slope": float(storage["scl_slope"]),
                                "scl_inter": float(storage["scl_inter"])}),
             path)


def make_degraded_subject(root: str, atlas_dir: str, kind: str,
                          shape=(64, 72, 60), seed: int = 0,
                          shift=(2, -1, 1), strength: float = 1.0) -> str:
    """Write one held-out phantom subject whose T1 carries the named
    degradation (GT is clean — it's the label contract), with NO priors:
    the caller drives the full default pipeline (register -> priors ->
    segment -> post-process) against it. Returns the subject directory."""
    from scipy import ndimage

    # crc32, not hash(): str hash is randomized per process (PYTHONHASHSEED),
    # which would make the "seeded" degraded phantoms differ on every run
    rng = np.random.default_rng([seed, zlib.crc32(kind.encode())])
    template, atlas = make_synthetic_atlas(atlas_dir, shape=shape, seed=seed)
    t1 = np.roll(template, shift, axis=(0, 1, 2))
    at = np.roll(atlas, shift, axis=(0, 1, 2))
    gt = np.zeros(shape, np.uint8)
    for s in range(14):
        gt[at[..., s] > 0.5] = s + 1
    ring = ndimage.binary_dilation(gt > 0, iterations=2) & (gt == 0)
    gt[ring] = 15

    data, affine, storage = apply_degradation(t1, np.eye(4), kind, rng,
                                              strength)
    sub = os.path.join(root, f"deg_{kind}")
    os.makedirs(sub, exist_ok=True)
    save_degraded(data, affine, storage, os.path.join(sub, "T1.nii.gz"))
    # GT shares the subject's (possibly oblique) world mapping
    save_nii(NiftiImage(gt, affine), os.path.join(sub, "gt_15_classes.nii.gz"))
    return sub



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
