"""Per-scan inference engine, patch path (port of subcort_tpu/engine/infer.py).

Reference counterpart: ``test_scan`` + ``load_patch_batch``
(cnn_cort/base.py:335-458). A scan is segmented by uploading the raw
volume, normalizing and padding it on the device, and running the chunked
patch engine (:func:`subcort_tpu_torch.engine.forward.forward_centers`:
the CUDA tri-planar gather kernel, then the CNN, then argmax) over the
candidate voxels. Prior vectors are gathered on the host and results
scattered on the host.

What this slice runs, and what it refuses:

- ``engine="patch"`` runs. ``engine="auto"`` (the default,
  ``use_fcn=True``) also resolves to the patch engine here: the JAX
  package's invariant makes its dense evaluator and patch engine
  label-identical (tests/test_engine.py::
  test_segment_volume_fcn_matches_patch_engine), so only the speed
  differs. ``engine="fcn"`` raises until the dense evaluator is ported.
- ``compute_dtype=bfloat16``, ``data_parallel>1``, ``folder_pipeline=True``
  and ``cc_backend=device`` raise :class:`NotImplementedError` naming the
  ROADMAP.md item; nothing is rerouted silently.

Output contract as the reference's (base.py:445-455):
``out_subcortical_prob.nii.gz`` (with out_probabilities; values in 1/255
steps by default, ``probs_dtype = float32`` for exact ones),
``out_subcortical_seg_prec.nii.gz`` (post-processed) or
``out_subcortical_rawseg.nii.gz``, each with the input's affine.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
from scipy import ndimage

from subcort_tpu.io import NiftiImage, load_nii, save_nii
from subcort_tpu_torch.config import Options, not_ported, select_device
from subcort_tpu_torch.engine.forward import forward_centers
from subcort_tpu_torch.engine.metrics import ScanStats
from subcort_tpu_torch.engine.postprocess import post_process_segmentation
from subcort_tpu_torch.models.triplanar import (DEFAULT_SPEC, Params,
                                                TriPlanarNet, TriPlanarSpec)
from subcort_tpu_torch.ops.normalize import normalize_stats
from subcort_tpu_torch.ops.patches import pad_volume
from subcort_tpu_torch.ops.sampling import get_mask_voxels

DEFAULT_CHUNK = 8192


def check_slice_options(options: Options) -> None:
    """Raise for every option this slice of the port does not run."""
    if str(options["compute_dtype"]).lower() in ("bfloat16", "bf16"):
        raise not_ported("compute_dtype=bfloat16", "item 3, bf16")
    if int(options["data_parallel"]) > 1:
        raise not_ported("data_parallel>1", "item 9, multi-GPU")
    if options.bool("folder_pipeline"):
        raise not_ported("folder_pipeline=True",
                         "item 6, LOO/CLI and the pipelined folder sweep")
    if options["cc_backend"] == "device":
        raise not_ported("cc_backend='device' (on-device connected "
                         "components)", "item 8, device CC")


def load_test_names(options: Options) -> Tuple[list, list]:
    """T1 paths + subject names from the inference folder (base.py:41-50)."""
    dir_name = options["test_folder"]
    subjects = [f for f in sorted(os.listdir(dir_name))
                if os.path.isdir(os.path.join(dir_name, f))]
    t1_names = [os.path.join(dir_name, s, options["t1_name"]) for s in subjects]
    return t1_names, subjects


def candidate_centers(image: np.ndarray, options: Options,
                      atlas_mask: Optional[np.ndarray]) -> np.ndarray:
    """Candidate voxels to classify: the dilated (``dilate_crop_iters``,
    base.py:369) atlas mask with crop=True, else every nonzero voxel."""
    if options.bool("crop") and atlas_mask is not None:
        b_mask = ndimage.binary_dilation(atlas_mask.astype(bool),
                                         iterations=options["dilate_crop_iters"])
        return get_mask_voxels(b_mask)
    return get_mask_voxels(image.astype(bool))


def _atlas_vectors_host(atlas: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Host-side atlas gather + per-sample background fix-up (base.py:388-394)."""
    vecs = atlas[centers[:, 0], centers[:, 1], centers[:, 2]].astype(np.float32)
    empty = vecs.sum(axis=1) == 0
    vecs[empty] = 0.0
    vecs[empty, 14] = 1.0
    return vecs


def _dequantize_probs(probs_b) -> np.ndarray:
    probs_b = np.asarray(probs_b)
    if probs_b.dtype == np.uint8:
        return probs_b.astype(np.float32) * np.float32(1.0 / 255.0)
    return probs_b


def _normalized_padded(image: np.ndarray, device: torch.device) -> torch.Tensor:
    """The halo-padded, nonzero-normalized float32 volume on ``device``.

    Narrow integer scans (the usual int16 T1) upload raw and normalize on
    the device with the same float32 ``(x - mean) * inv_std`` arithmetic as
    the host path (JAX: infer.py:86-96, ``_pad_normalize_device``); other
    dtypes normalize on the host. Halo voxels are 0 in normalized space.
    """
    mean, std = normalize_stats(image)
    if image.dtype.kind in "iu" and image.dtype.itemsize <= 2:
        scal = torch.tensor([mean, 1.0 / std], dtype=torch.float32,
                            device=device)
        raw = torch.from_numpy(image).to(device)
        norm = (raw.to(torch.float32) - scal[0]) * scal[1]
    else:
        norm = torch.from_numpy(
            (image.astype(np.float32) - np.float32(mean))
            * np.float32(1.0 / std)).to(device)
    return pad_volume(norm)


def segment_volume(net: TriPlanarNet, image: np.ndarray, atlas: np.ndarray,
                   centers: np.ndarray, *, want_probs: bool = False,
                   chunk: int = DEFAULT_CHUNK, engine: str = "auto",
                   probs_dtype=np.uint8, compute_dtype: str = "float32",
                   device: Optional[torch.device] = None):
    """Segment one raw T1 volume at ``centers`` (N, 3).

    Returns (label_vol uint8, prob_vol float32 or None) as numpy arrays.
    ``device`` defaults to the net's. ``engine`` "auto" and "patch" run the
    patch engine (see the module docstring); "fcn" raises.
    """
    if engine == "fcn":
        raise not_ported("engine='fcn' (the dense a-trous evaluator)",
                         "item 2, dense evaluator")
    if engine not in ("auto", "patch"):
        raise ValueError(f"unknown engine {engine!r}")
    if str(compute_dtype).lower() in ("bfloat16", "bf16"):
        raise not_ported("compute_dtype=bfloat16", "item 3, bf16")
    if device is None:
        device = next(net.parameters()).device
    image = np.asarray(image)
    shape = tuple(int(s) for s in image.shape)
    centers = np.asarray(centers, np.int32).reshape(-1, 3)
    n = centers.shape[0]
    label_vol = np.zeros(shape, np.uint8)
    prob_vol = np.zeros(shape + (15,), np.float32) if want_probs else None
    if n == 0:
        # the reference's batch generator yields zero batches: all-zero
        # outputs (base.py:379-380,414-417)
        return label_vol, prob_vol
    # the kernel does not clamp: out-of-volume centers stop here
    if centers.min() < 0 or (centers >= np.asarray(shape)).any():
        raise ValueError(f"centers outside the volume of shape {shape}")

    padded = _normalized_padded(image, device)
    vecs = _atlas_vectors_host(np.asarray(atlas, np.float32), centers)
    labels, probs = forward_centers(
        net, padded, torch.from_numpy(centers).to(device),
        torch.from_numpy(vecs).to(device), chunk, want_probs,
        probs_dtype=getattr(torch, np.dtype(probs_dtype).name))
    label_vol[centers[:, 0], centers[:, 1], centers[:, 2]] = labels.cpu().numpy()
    if want_probs:
        prob_vol[centers[:, 0], centers[:, 1], centers[:, 2]] = \
            _dequantize_probs(probs.cpu().numpy())
    return label_vol, prob_vol


def _load_scan_inputs(scan_path: str, options: Options, register_fn=None):
    """Host-side per-scan prep: priors from the per-subject ``tmp/`` cache
    (or ``register_fn(scan_path)`` on a miss), the T1 + prior volumes, and
    the candidate voxels."""
    image_dir, _ = os.path.split(scan_path)
    tmp = os.path.join(image_dir, "tmp")
    prior_path = os.path.join(tmp, "MNI_sub_probabilities.nii.gz")
    mask_path = os.path.join(tmp, "MNI_subcortical_mask.nii.gz")

    if not os.path.exists(prior_path):
        if register_fn is None:
            raise FileNotFoundError(
                f"{prior_path} is missing and no register_fn was given; "
                "registration is not ported to subcort_tpu_torch yet "
                "(ROADMAP.md, queue A: item 7, on-device registration)")
        register_fn(scan_path)

    t1 = load_nii(scan_path)
    image = np.asarray(t1.data)
    atlas = load_nii(prior_path).data
    atlas_mask = load_nii(mask_path).data if os.path.exists(mask_path) else None
    centers = candidate_centers(image, options, atlas_mask)
    return t1, image, atlas, centers


def test_scan(net: TriPlanarNet, scan_path: str, options: Options,
              register_fn=None, device: Optional[torch.device] = None) -> float:
    """Full per-scan pipeline with the reference's file contract
    (base.py:401-458). Returns elapsed minutes, like the reference."""
    check_slice_options(options)
    s_time = time.time()
    image_dir, _ = os.path.split(scan_path)
    t1, image, atlas, centers = _load_scan_inputs(scan_path, options,
                                                  register_fn)
    if options.bool("debug"):
        print("    -->  num of samples to test:", len(centers))
    stats = ScanStats(scan_path).set(candidate_voxels=int(len(centers)),
                                     volume_shape=list(image.shape))

    want_probs = options.bool("out_probabilities")
    chunk = min(DEFAULT_CHUNK, max(256, options["test_batch_size"]))
    label_vol, prob_vol = segment_volume(
        net, image, atlas, centers, want_probs=want_probs, chunk=chunk,
        engine="auto" if options.bool("use_fcn") else "patch",
        probs_dtype=np.dtype(options["probs_dtype"]),
        compute_dtype=options["compute_dtype"], device=device)

    affine = t1.affine
    seg_dtype = image.dtype if image.dtype.kind in "iu" else np.uint8
    if want_probs:
        save_nii(NiftiImage(np.asarray(prob_vol, np.float32), affine),
                 os.path.join(image_dir, "out_subcortical_prob.nii.gz"))
    if options.bool("post_process"):
        filtered = post_process_segmentation(
            image_dir, label_vol,
            bugcompat_argmax=options["bugcompat_postprocess_argmax"],
            cc_backend=options["cc_backend"])
        save_nii(NiftiImage(filtered.astype(seg_dtype), affine),
                 os.path.join(image_dir, "out_subcortical_seg_prec.nii.gz"))
    else:
        save_nii(NiftiImage(label_vol.astype(np.uint8), affine),
                 os.path.join(image_dir, "out_subcortical_rawseg.nii.gz"))
    if options["net_verbose"]:
        stats.emit()  # one JSON line: wall_seconds, voxels_per_sec, ...
    return (time.time() - s_time) / 60.0


# keep the reference's public name without pytest collecting it as a test
test_scan.__test__ = False


class SegmentationEngine:
    """Binds (params, options) to a device: the object a user of the
    reference's ``net`` + ``test_scan`` pair migrates to.

    ``params`` is a state dict (:func:`~subcort_tpu_torch.models.init_params`,
    :func:`~subcort_tpu_torch.models.load_theano_checkpoint` or
    :func:`~subcort_tpu_torch.models.params_from_jax`); the device comes
    from ``options.mode`` (:func:`~subcort_tpu_torch.config.select_device`).
    """

    def __init__(self, params: Params, options: Options,
                 spec: TriPlanarSpec = DEFAULT_SPEC, register_fn=None):
        check_slice_options(options)
        self.options = options
        self.device = select_device(options)
        self.net = TriPlanarNet.from_params(params, spec, self.device)
        self.register_fn = register_fn

    def segment_scan(self, scan_path: str) -> float:
        return test_scan(self.net, scan_path, self.options,
                         register_fn=self.register_fn, device=self.device)

    def segment_folder(self) -> dict:
        """Serial sweep over the configured inference folder
        (train_model.py:68-78 flow). Returns {subject: minutes}."""
        t1_names, subjects = load_test_names(self.options)
        times = {}
        for path, sub in zip(t1_names, subjects):
            if self.options.bool("debug"):
                print("--> testing scan", sub)
            times[sub] = self.segment_scan(path)
        return times
