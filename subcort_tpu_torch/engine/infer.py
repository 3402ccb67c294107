"""Per-scan inference engine (port of subcort_tpu/engine/infer.py).

Reference counterpart: ``test_scan`` + ``load_patch_batch``
(cnn_cort/base.py:335-458). A scan is segmented on the device by one of
two engines over the candidate voxels, with prior vectors gathered on the
host and results scattered on the host:

- the dense path (``engine="fcn"``): the candidate bbox plus its patch
  context is cut from the raw scan on the host, normalized on the device,
  and run through the à-trous tri-planar convs, then the head MLP at the
  candidate voxels (:func:`subcort_tpu_torch.models.fcn.fcn_forward_slab`);
- the patch path (``engine="patch"``): the normalized, padded volume on the
  device, laid out once for the gather kernel on the card, and chunks of
  (the CUDA tri-planar gather kernel -> CNN -> argmax)
  (:func:`subcort_tpu_torch.engine.forward.forward_centers`).

``engine="auto"`` (the default; ``use_fcn = True``) picks the dense path
unless the candidate bbox holds more than 30 voxels per candidate, as the
JAX package does. The two engines agree on labels
(tests/test_torch_fcn.py). ``compute_dtype = bfloat16`` runs either engine
on a bfloat16 copy of the net. A scan without its ``tmp/`` priors is
registered first (``register_masks`` under ``reg_backend`` and
``reg_similarity``; ``reg_backend = torch`` runs it on the engine's device).
``folder_pipeline = True`` pipelines ``segment_folder`` (the next scan's
host prep on a loader thread, the last scan's post-process and writes on a
writer thread); ``cc_backend = device`` labels the post-process's
connected components on the engine's device. ``data_parallel > 1``
segments each scan over several devices from this process, one host
thread per device (``segment_volume(devices=...)``: the patch engine's
centers in parts of whole chunks, the dense engine's bbox in one sub-slab
per device with ``fcn_spmd`` or in sub-bboxes dealt round-robin without;
:mod:`subcort_tpu_torch.parallel`), and under a multi-host launch
``segment_folder`` takes this process's share of the subjects. An unknown
``reg_backend`` or ``reg_similarity`` raises a :class:`ValueError`;
nothing is rerouted silently.

Left out of the JAX dense host path, which shaped it for a TPU behind a
slow link: the packed-bitmask candidate wire, compacted prior rows, the
power-of-two shape ladder and the 6 MB slab-split gate. The port ships
the raw slab, int64 candidate indices and every candidate's prior row,
and on one device runs the sub-bboxes serially.

Output contract as the reference's (base.py:445-455):
``out_subcortical_prob.nii.gz`` (with out_probabilities; values in 1/255
steps by default, ``probs_dtype = float32`` for exact ones),
``out_subcortical_seg_prec.nii.gz`` (post-processed) or
``out_subcortical_rawseg.nii.gz``, each with the input's affine.
"""

from __future__ import annotations

import copy
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage

from subcort_tpu_torch.config import Options, exact_float32, select_device
from subcort_tpu_torch.engine.data import _configured_register
from subcort_tpu_torch.engine.forward import forward_centers
from subcort_tpu_torch.engine.metrics import ScanStats
from subcort_tpu_torch.engine.postprocess import post_process_segmentation
from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii
from subcort_tpu_torch.models.fcn import HALF, RF, fcn_forward_slab
from subcort_tpu_torch.models.triplanar import (DEFAULT_SPEC, Params,
                                                TriPlanarNet, TriPlanarSpec,
                                                predict_proba_chunked)
from subcort_tpu_torch.ops.gather_kernel import prepare_gather_volume
from subcort_tpu_torch.ops.normalize import normalize_stats
from subcort_tpu_torch.ops.patches import pad_volume
from subcort_tpu_torch.ops.sampling import get_mask_voxels
from subcort_tpu_torch.parallel import distributed
from subcort_tpu_torch.parallel.mesh import (DeviceWorkers, available_devices,
                                             replicate)
from subcort_tpu_torch.registration.driver import check_registration
from subcort_tpu_torch.utils.runtime import current_request, span

DEFAULT_CHUNK = 8192


def check_slice_options(options: Options) -> None:
    """Raise for an unknown registration option, before any work."""
    check_registration(options["reg_backend"], options["reg_similarity"])


def net_in_dtype(net: TriPlanarNet, compute_dtype: str) -> TriPlanarNet:
    """``net`` itself, or a copy cast to ``compute_dtype`` ("bfloat16" /
    "bf16", else float32). The cast takes every parameter and buffer, BN
    mean/inv_std and PReLU alphas included, as the JAX package's
    ``tree_map`` does (infer.py:499-505)."""
    dtype = (torch.bfloat16 if compute_dtype in ("bfloat16", "bf16")
             else torch.float32)
    if next(net.parameters()).dtype == dtype:
        return net
    return copy.deepcopy(net).to(dtype)


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


def _bbox_of(centers: np.ndarray, shape, align: int = 16):
    """Tight bbox of the candidate set, dims rounded up to ``align`` and
    clamped inside the volume (copy of infer.py:124-133)."""
    lo = centers.min(axis=0)
    hi = centers.max(axis=0) + 1
    dims = hi - lo
    dims = np.minimum(-(-dims // align) * align, np.asarray(shape))
    lo = np.minimum(lo, np.asarray(shape) - dims)
    lo = np.maximum(lo, 0)
    return lo.astype(np.int32), tuple(int(d) for d in dims)


def _split_bbox(lo, dims, max_voxels: int):
    """Split a bbox along its largest axis into sub-bboxes of at most
    ``max_voxels`` each (copy of infer.py:136-151)."""
    if int(np.prod(dims)) <= max_voxels:
        yield np.asarray(lo, np.int32), tuple(int(d) for d in dims)
        return
    axis = int(np.argmax(dims))
    n_parts = -(-int(np.prod(dims)) // max_voxels)
    step = -(-dims[axis] // n_parts)
    for start in range(0, dims[axis], step):
        sub_lo = np.asarray(lo, np.int32).copy()
        sub_lo[axis] += start
        sub_dims = list(dims)
        sub_dims[axis] = min(step, dims[axis] - start)
        yield from _split_bbox(sub_lo, tuple(sub_dims), max_voxels)


def _quantize_priors(vecs: np.ndarray, prior_dtype) -> np.ndarray:
    """Prior rows in the ``prior_dtype`` the device dequantizes
    (copy of infer.py:154-165): uint8 and uint16 are 1/255 and 1/65535
    fixed point; other dtypes a plain cast."""
    if np.dtype(prior_dtype) == np.uint8:
        return np.round(vecs * 255.0).astype(np.uint8)
    if np.dtype(prior_dtype) == np.uint16:
        return np.round(vecs * 65535.0).astype(np.uint16)
    return vecs.astype(prior_dtype)


def _raw_wire(image: np.ndarray) -> bool:
    """Whether ``image`` goes to the device raw, to be normalized there:
    narrow integer scans (the usual int16 T1)."""
    return image.dtype.kind in "iu" and image.dtype.itemsize <= 2


def _fcn_slab_inputs(image, stats, atlas, lo, dims, shape, prior_dtype,
                     centers=None):
    """Host prep for one sub-bbox (infer.py:210-334). ``image`` is the RAW
    volume and ``stats`` its nonzero (mean, std).

    Returns (slab, prior rows in ``prior_dtype``, cs, lin, norm). Sparse
    mode, when the candidates do not fill the bbox: cs = the candidates
    inside it, in the caller's order (duplicates kept), and lin their int64
    linear bbox indices (C order); the prior rows are cs's. Dense mode
    (``centers=None`` or a full bbox): a prior row for every bbox voxel in
    C order, cs and lin None. With no candidate inside, slab is None.

    Narrow-integer scans (the usual int16 T1) keep the slab raw and
    ``norm = (scale (2,) float32, lo (3,), hi (3,))`` has the device
    normalize it and zero the voxels outside ``[lo, hi)``, bit-exact with
    the host path. Other scans normalize on the host; ``norm`` is None.
    """
    bx, by, bz = dims
    mean, std = stats
    # slab axis i covers [lo-HALF, lo+dim+HALF-1]; outside-volume voxels
    # stay 0.0 in normalized space (pad_volume's convention)
    raw_wire = _raw_wire(image)
    slab = np.zeros((bx + RF, by + RF, bz + RF),
                    image.dtype if raw_wire else np.float32)
    src, dst = [], []
    for l, d, s in zip(lo, dims, shape):
        a = min(max(int(l) - HALF, 0), s)
        b = max(min(int(l) + d + HALF - 1, s), a)
        ds = a - (int(l) - HALF)
        if ds < 0:
            # a sub-bbox starting more than HALF past the volume end has no
            # overlap; a negative dst start would wrap around numpy's
            # negative indices into a non-empty slice
            a = b = s
            ds = 0
        src.append(slice(a, b))
        dst.append(slice(ds, ds + (b - a)))
    if raw_wire:
        slab[tuple(dst)] = image[tuple(src)]
        norm = (np.array([mean, 1.0 / std], np.float32),
                tuple(s.start for s in dst), tuple(s.stop for s in dst))
    else:
        slab[tuple(dst)] = ((image[tuple(src)].astype(np.float32)
                             - np.float32(mean)) * np.float32(1.0 / std))
        norm = None

    if centers is not None:
        inside = np.all((centers >= lo) & (centers < lo + np.asarray(dims)),
                        axis=1)
        cs = centers[inside]
        if len(cs) == 0:
            return None, None, cs, None, None  # nothing to classify here
        if len(cs) < bx * by * bz:
            # explicit indices keep the results aligned with cs, in any
            # order and with duplicates
            rel = cs.astype(np.int64) - np.asarray(lo)[None, :]
            lin = (rel[:, 0] * by + rel[:, 1]) * bz + rel[:, 2]
            vecs = _quantize_priors(_atlas_vectors_host(atlas, cs),
                                    prior_dtype)
            return slab, vecs, cs, lin, norm
        # the candidates fill the bbox: the dense head needs no gather

    # prior rows for every bbox voxel, C order over (x, y, z): the bbox is
    # clamped inside the volume, so this is one block slice
    vecs = atlas[lo[0]:lo[0] + bx, lo[1]:lo[1] + by,
                 lo[2]:lo[2] + bz].reshape(-1, atlas.shape[-1]).astype(
                     np.float32, copy=True)
    empty = vecs.sum(axis=1) == 0
    vecs[empty] = 0.0
    vecs[empty, 14] = 1.0
    return slab, _quantize_priors(vecs, prior_dtype), None, None, norm


def _dequantize_probs(probs_b) -> np.ndarray:
    probs_b = np.asarray(probs_b)
    if probs_b.dtype == np.uint8:
        return probs_b.astype(np.float32) * np.float32(1.0 / 255.0)
    return probs_b


def _fcn_scatter_results(labels_b, probs_b, lo, dims, centers, cs,
                         label_vol, prob_vol, want_probs):
    """One slab's results into the volumes (infer.py:344-364)."""
    if cs is not None:
        # sparse mode: results are aligned with cs
        label_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = labels_b
        if want_probs:
            prob_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = _dequantize_probs(probs_b)
        return
    bx, by, bz = dims
    inside = np.all((centers >= lo) & (centers < lo + np.asarray(dims)), axis=1)
    cs = centers[inside]
    rel = cs - np.asarray(lo)[None, :]
    label_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = \
        labels_b[rel[:, 0], rel[:, 1], rel[:, 2]]
    if want_probs:
        probs_b = _dequantize_probs(probs_b).reshape(bx, by, bz, -1)
        prob_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = \
            probs_b[rel[:, 0], rel[:, 1], rel[:, 2]]


def _fcn_slab(net, image, stats, atlas, lo, dims, prior_dtype, probs_dtype,
              centers, want_probs, device, request=None):
    """One sub-bbox through the dense evaluator on ``device``: host prep,
    upload, :func:`fcn_forward_slab`, readback, each a span of ``request``
    (None: the request of the span open on this thread). Returns the
    arguments of :func:`_fcn_scatter_results` after the volumes' (labels,
    probs, lo, dims, centers, cs), or None when no candidate lies inside."""
    with span("infer.slab_inputs", request) as rec:
        slab, vecs, cs, lin, norm = _fcn_slab_inputs(
            image, stats, atlas, lo, dims, image.shape, prior_dtype, centers)
        if slab is None:
            return None
        rec.set(rows=len(vecs))

    def to_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    with span("infer.upload", request) as rec:
        rec.set(bytes=sum(a.nbytes for a in (
            slab, vecs, lin, None if norm is None else norm[0])
            if a is not None))
        slab, vecs = to_device(slab), to_device(vecs)
        if lin is not None:
            lin = to_device(lin)
        if norm is not None:
            norm = (to_device(norm[0]),) + norm[1:]
    with span("infer.forward", request):
        labels_b, probs_b = fcn_forward_slab(
            net, slab, vecs, want_probs,
            probs_dtype=getattr(torch, np.dtype(probs_dtype).name),
            gather_idx=lin, norm=norm)
    labels_b, probs_b = _readback(labels_b, probs_b if want_probs else None,
                                  request)
    return labels_b, probs_b, lo, dims, centers, cs


def _readback(labels: torch.Tensor, probs: Optional[torch.Tensor],
              request=None):
    """``labels`` and ``probs`` (or None) on the host as numpy arrays: the
    wait for the device and the copies, as one span."""
    with span("infer.readback", request) as rec:
        labels = labels.cpu().numpy()
        probs = None if probs is None else probs.cpu().numpy()
        rec.set(bytes=labels.nbytes + (0 if probs is None else probs.nbytes))
    return labels, probs


def _fcn_scatter(res, label_vol, prob_vol, want_probs) -> None:
    """:func:`_fcn_slab`'s result into the volumes, as one span; nothing
    for a sub-bbox without candidates (``res`` None)."""
    if res is not None:
        with span("infer.scatter"):
            _fcn_scatter_results(*res, label_vol, prob_vol, want_probs)


def _fcn_run_bboxes(nets, image, stats, atlas, bboxes, centers, label_vol,
                    prob_vol, want_probs, prior_dtype, probs_dtype, workers):
    """The dense evaluator over the sub-bboxes (infer.py:367-452), with
    ``nets[device]`` on each device; ``stats`` are ``image``'s
    :func:`normalize_stats`. ``workers`` is None on one device: the
    sub-bboxes run one after another in this thread. Otherwise a
    :class:`~subcort_tpu_torch.parallel.mesh.DeviceWorkers`: they are dealt
    round-robin over its entries, with at most ``2 x`` its entries' slabs
    in flight before the host scatters the oldest."""
    args = (image, stats, atlas)
    tail = (prior_dtype, probs_dtype, centers, want_probs)
    if workers is None:
        (device, net), = nets.items()
        for lo, dims in bboxes:
            _fcn_scatter(_fcn_slab(net, *args, lo, dims, *tail, device),
                         label_vol, prob_vol, want_probs)
        return
    ndev = len(workers.devices)
    pending = deque()
    request = current_request()

    def scatter_oldest():
        _fcn_scatter(pending.popleft().result(), label_vol, prob_vol,
                     want_probs)

    for i, (lo, dims) in enumerate(bboxes):
        dev = workers.devices[i % ndev]
        pending.append(workers.submit(i % ndev, _fcn_slab, nets[dev], *args,
                                      lo, dims, *tail, dev, request))
        while len(pending) > 2 * ndev:
            scatter_oldest()
    while pending:
        scatter_oldest()


def _normalized_padded(image: np.ndarray, device: torch.device,
                       stats=None) -> torch.Tensor:
    """The halo-padded, nonzero-normalized float32 volume on ``device``
    (``stats``: ``image``'s :func:`normalize_stats`, computed if None).

    Narrow integer scans (the usual int16 T1) upload raw and normalize on
    the device with the same float32 ``(x - mean) * inv_std`` arithmetic as
    the host path (JAX: infer.py:86-96, ``_pad_normalize_device``); other
    dtypes normalize on the host. Halo voxels are 0 in normalized space.
    """
    mean, std = normalize_stats(image) if stats is None else stats
    if _raw_wire(image):
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
                   fcn_max_bbox_voxels: int = 6_000_000,
                   prior_dtype=np.uint16, probs_dtype=np.uint8,
                   compute_dtype: str = "float32",
                   device: Optional[torch.device] = None,
                   devices: Optional[Sequence[torch.device]] = None,
                   fcn_spmd: bool = True):
    """Segment one raw T1 volume at ``centers`` (N, 3).

    Returns (label_vol uint8, prob_vol float32 or None) as numpy arrays.
    ``device`` defaults to the net's. ``engine``: "fcn" (dense, with
    oversized bboxes split into sub-slabs of at most
    ``fcn_max_bbox_voxels``), "patch", or "auto", which picks "fcn" unless
    the bbox exceeds 30x the candidate count (infer.py:517-523).
    ``prior_dtype`` is the dense path's prior fixed point; the patch path
    takes float32 rows, as in JAX. The device work runs with TF32 off
    (:func:`~subcort_tpu_torch.config.exact_float32`).

    ``devices``, a list of more than one ``torch.device`` (an entry may
    repeat), fans the work out from this process, one host thread per
    entry (infer.py:529-547, 634-649): the patch engine over whole chunks
    of the centers (:func:`~subcort_tpu_torch.parallel.infer_sharded.
    predict_labels_sharded`); the dense engine over equal sub-slabs of the
    candidate bbox, one per entry (``fcn_spmd``, the default:
    :func:`~subcort_tpu_torch.parallel.fcn_sharded.fcn_run_spmd`), or over
    sub-bboxes of at most ``ceil(bbox voxels / entries)`` dealt round-robin
    (``fcn_spmd=False``). ``None`` or one entry is the single-device path.

    The call is one ``infer.segment_volume`` span, its stages spans under
    it (``infer.prepare``, then per slab or for the patch engine's centers
    ``infer.slab_inputs``, ``infer.upload``, ``infer.forward``,
    ``infer.readback`` and ``infer.scatter``; PERF.md §3).
    """
    if engine not in ("auto", "fcn", "patch"):
        raise ValueError(f"unknown engine {engine!r}")
    with span("infer.segment_volume"):
        with span("infer.prepare"):
            if devices is not None and len(devices) == 1:
                device, devices = devices[0], None
            if devices is not None:
                devices = [torch.device(d) for d in devices]
            elif device is None:
                device = next(net.parameters()).device
            image = np.asarray(image)
            shape = tuple(int(s) for s in image.shape)
            centers = np.asarray(centers, np.int32).reshape(-1, 3)
            n = centers.shape[0]
            atlas = np.asarray(atlas, np.float32)
            if not want_probs:
                # dead without probs (infer.py:492-498)
                probs_dtype = np.uint8
            net = net_in_dtype(net, compute_dtype)
            label_vol = np.zeros(shape, np.uint8)
            prob_vol = (np.zeros(shape + (15,), np.float32) if want_probs
                        else None)
            if n == 0:
                # the reference's batch generator yields zero batches:
                # all-zero outputs (base.py:379-380,414-417)
                return label_vol, prob_vol
            # the gather kernel does not clamp: out-of-volume centers stop
            # here
            if centers.min() < 0 or (centers >= np.asarray(shape)).any():
                raise ValueError(
                    f"centers outside the volume of shape {shape}")

            lo, dims = _bbox_of(centers, shape)
            if engine == "auto":
                engine = "fcn" if int(np.prod(dims)) <= 30 * n else "patch"
            stats = normalize_stats(image)
            if engine == "patch" and devices is None:
                # the patch engine's prior rows, host prep as the dense
                # engine's slab cut is
                vecs = _atlas_vectors_host(atlas, centers)
        fcn_args = (image, stats, atlas, centers, label_vol, prob_vol,
                    want_probs, prior_dtype, probs_dtype)
        with exact_float32():
            if devices is not None:
                _segment_on_devices(net, devices, engine, lo, dims, chunk,
                                    fcn_max_bbox_voxels, fcn_spmd, *fcn_args)
                return label_vol, prob_vol
            if engine == "fcn":
                _fcn_run_bboxes({torch.device(device): net}, image, stats,
                                atlas,
                                _split_bbox(lo, dims, fcn_max_bbox_voxels),
                                *fcn_args[3:], None)
                return label_vol, prob_vol

            with span("infer.upload") as rec:
                rec.set(bytes=(image.nbytes if _raw_wire(image)
                               else 4 * image.size) + centers.nbytes
                        + vecs.nbytes)
                volume = _normalized_padded(image, device, stats)
                if volume.is_cuda:
                    # the kernel's two layouts, once per scan; the plain
                    # padded volume is freed here
                    volume = prepare_gather_volume(volume)
                centers_d = torch.from_numpy(centers).to(device)
                vecs = torch.from_numpy(vecs).to(device)
            with span("infer.forward"):
                labels, probs = forward_centers(
                    net, volume, centers_d, vecs, chunk, want_probs,
                    probs_dtype=getattr(torch, np.dtype(probs_dtype).name))
        labels, probs = _readback(labels, probs if want_probs else None)
        with span("infer.scatter"):
            _scatter_centers(labels, probs, centers, label_vol, prob_vol)
        return label_vol, prob_vol


def _scatter_centers(labels, probs, centers, label_vol, prob_vol) -> None:
    """The patch engine's per-center results into the volumes."""
    label_vol[centers[:, 0], centers[:, 1], centers[:, 2]] = labels
    if probs is not None:
        prob_vol[centers[:, 0], centers[:, 1], centers[:, 2]] = \
            _dequantize_probs(probs)


def _segment_on_devices(net, devices, engine, lo, dims, chunk,
                        fcn_max_bbox_voxels, fcn_spmd, image, stats, atlas,
                        centers, label_vol, prob_vol, want_probs, prior_dtype,
                        probs_dtype) -> None:
    """:func:`segment_volume`'s multi-device branch: ``net`` replicated
    once per distinct device, one host thread per entry of ``devices``,
    whose spans carry the call's request."""
    nets = replicate(net, devices)
    with DeviceWorkers(devices) as workers:
        if engine == "patch":
            from subcort_tpu_torch.parallel.infer_sharded import \
                predict_labels_sharded
            labels, probs = predict_labels_sharded(
                nets, workers, image, centers,
                _atlas_vectors_host(atlas, centers), chunk, want_probs,
                probs_dtype, stats)
            with span("infer.scatter"):
                _scatter_centers(labels, probs, centers, label_vol, prob_vol)
        elif fcn_spmd:
            from subcort_tpu_torch.parallel.fcn_sharded import fcn_run_spmd

            # one sub-slab per entry, inside an outer split that keeps each
            # entry's slab within fcn_max_bbox_voxels
            for sub_lo, sub_dims in _split_bbox(
                    lo, dims, len(devices) * fcn_max_bbox_voxels):
                fcn_run_spmd(nets, workers, image, stats, atlas, sub_lo,
                             sub_dims, centers, label_vol, prob_vol,
                             want_probs, prior_dtype, probs_dtype)
        else:
            # split finely enough that every entry gets work
            vox = int(np.prod(dims))
            cap = min(fcn_max_bbox_voxels, max(1, -(-vox // len(devices))))
            _fcn_run_bboxes(nets, image, stats, atlas,
                            _split_bbox(lo, dims, cap), centers, label_vol,
                            prob_vol, want_probs, prior_dtype, probs_dtype,
                            workers)


def _data_parallel_devices(options: Options) -> Optional[list]:
    """The device list of ``[tpu] data_parallel`` (infer.py:673-688): None
    for 1; else the first N devices of ``mode``'s kind from its index on
    (``cudaK`` -> ``cuda:K ...``; ``cpu`` has one), clamped to what exists
    with a note under ``net_verbose``, so one configuration runs on any
    machine, as the JAX package's does. A device that ``mode`` names and
    that is absent raises (``select_device``)."""
    dp = int(options["data_parallel"])
    if dp <= 1:
        return None
    avail = available_devices(options.mode)
    if dp > len(avail):
        if options["net_verbose"]:
            print(f"--> data_parallel={dp} requested but only {len(avail)} "
                  "device(s) present; using all of them")
        dp = len(avail)
    return avail[:dp]


def _subject(scan_path: str) -> str:
    """The subject of ``scan_path``: its folder's name, the request id of
    the scan's spans."""
    return os.path.basename(os.path.dirname(os.path.abspath(scan_path)))


def _load_scan_inputs(scan_path: str, options: Options, register_fn=None,
                      device: Optional[torch.device] = None, request=None):
    """Host-side per-scan prep: priors from the per-subject ``tmp/`` cache,
    the T1 + prior volumes (``infer.load``), and the candidate voxels
    (``infer.candidates``), spans of ``request`` (None: the request of the
    span open on this thread). On a cache miss the scan is registered
    first: by ``register_fn(scan_path)``, else by ``register_masks`` with
    the configured backend and cost, the on-device backend on ``device``
    (``None``: the one ``options.mode`` names)."""
    image_dir, _ = os.path.split(scan_path)
    tmp = os.path.join(image_dir, "tmp")
    prior_path = os.path.join(tmp, "MNI_sub_probabilities.nii.gz")
    mask_path = os.path.join(tmp, "MNI_subcortical_mask.nii.gz")

    with span("infer.load", request):
        if not os.path.exists(prior_path):
            if register_fn is None:
                from subcort_tpu_torch.registration import register_masks
                register_fn = _configured_register(register_masks, options,
                                                   device)
            register_fn(scan_path)

        t1 = load_nii(scan_path)
        image = np.asarray(t1.data)
        atlas = load_nii(prior_path).data
        atlas_mask = (load_nii(mask_path).data if os.path.exists(mask_path)
                      else None)
    with span("infer.candidates", request):
        centers = candidate_centers(image, options, atlas_mask)
    return t1, image, atlas, centers


class _BoundedWriter:
    """Bounded queue of deferred writes for the pipelined folder sweep
    (copy of subcort_tpu/engine/infer.py:725-746): at most ``max_inflight`` pending
    ``write_outputs`` closures at once (each pins a scan's output volumes,
    a ~430 MB prob map with out_probabilities, so an unbounded backlog
    behind a slow gzip would grow host memory by that much per queued
    scan). ``submit`` blocks on, and raises the error of, the oldest write
    once the bound is hit."""

    def __init__(self, pool, max_inflight: int = 2):
        self.pool = pool
        self.max_inflight = max_inflight
        self.futures = []

    def submit(self, fn):
        while len(self.futures) >= self.max_inflight:
            self.futures.pop(0).result()
        self.futures.append(self.pool.submit(fn))

    def drain(self):
        while self.futures:
            self.futures.pop(0).result()


def test_scan(net: TriPlanarNet, scan_path: str, options: Options,
              register_fn=None, device: Optional[torch.device] = None,
              devices: Optional[Sequence[torch.device]] = None,
              _inputs=None, _writer=None) -> float:
    """Full per-scan pipeline with the reference's file contract
    (base.py:401-458). Returns elapsed minutes, like the reference.
    ``devices`` (default: what ``[tpu] data_parallel`` asks for,
    :func:`_data_parallel_devices`) goes to :func:`segment_volume`, with
    ``fcn_spmd``.

    ``_inputs``/``_writer`` (internal, used by ``segment_folder``'s
    pipelined sweep): a pre-loaded ``_load_scan_inputs`` result, and a
    :class:`_BoundedWriter` to run post-processing and file writes on, so
    that they overlap the next scan's device work. With ``_writer`` the
    returned minutes (and the emitted per-scan stats) cover the
    segmentation stage only: loading happened in the prefetch thread and
    the writes are deferred, so they are NOT comparable to serial-mode
    numbers, which cover load + segment + write. The output files are on
    disk once the caller drains the writer.

    The scan is one ``infer.scan`` span whose request is the subject
    (the scan's folder), with ``infer.load``, ``infer.candidates``,
    ``infer.segment_volume`` and ``infer.write`` under it; the pipelined
    sweep's load and write run on their threads under the same request.
    """
    check_slice_options(options)
    with span("infer.scan", _subject(scan_path)):
        return _test_scan(net, scan_path, options, register_fn, device,
                          devices, _inputs, _writer)


def _test_scan(net, scan_path, options, register_fn, device, devices,
               _inputs, _writer) -> float:
    """:func:`test_scan` inside its span."""
    s_time = time.time()
    image_dir, _ = os.path.split(scan_path)
    t1, image, atlas, centers = (
        _inputs if _inputs is not None
        else _load_scan_inputs(scan_path, options, register_fn, device))
    if options.bool("debug"):
        print("    -->  num of samples to test:", len(centers))
    stats = ScanStats(scan_path).set(candidate_voxels=int(len(centers)),
                                     volume_shape=list(image.shape))

    want_probs = options.bool("out_probabilities")
    chunk = min(DEFAULT_CHUNK, max(256, options["test_batch_size"]))
    label_vol, prob_vol = segment_volume(
        net, image, atlas, centers, want_probs=want_probs, chunk=chunk,
        engine="auto" if options.bool("use_fcn") else "patch",
        fcn_max_bbox_voxels=options["fcn_max_bbox_voxels"],
        prior_dtype=np.dtype(options["prior_dtype"]),
        probs_dtype=np.dtype(options["probs_dtype"]),
        compute_dtype=options["compute_dtype"], device=device,
        devices=(devices if devices is not None
                 else _data_parallel_devices(options)),
        fcn_spmd=options.bool("fcn_spmd"))

    # what the (possibly deferred) write needs, and never t1 or image,
    # which would pin the raw scan in the writer queue
    affine = t1.affine
    seg_dtype = image.dtype if image.dtype.kind in "iu" else np.uint8
    cc_device = device if device is not None else next(net.parameters()).device
    subject = _subject(scan_path)

    def write_outputs():
        with span("infer.write", subject):
            if want_probs:
                save_nii(NiftiImage(np.asarray(prob_vol, np.float32), affine),
                         os.path.join(image_dir,
                                      "out_subcortical_prob.nii.gz"))
            if options.bool("post_process"):
                filtered = post_process_segmentation(
                    image_dir, label_vol,
                    bugcompat_argmax=options["bugcompat_postprocess_argmax"],
                    cc_backend=options["cc_backend"], device=cc_device)
                save_nii(NiftiImage(filtered.astype(seg_dtype), affine),
                         os.path.join(image_dir,
                                      "out_subcortical_seg_prec.nii.gz"))
            else:
                save_nii(NiftiImage(label_vol.astype(np.uint8), affine),
                         os.path.join(image_dir,
                                      "out_subcortical_rawseg.nii.gz"))
            if options["net_verbose"]:
                # one JSON line: wall_seconds, voxels_per_sec, ...
                stats.emit()

    if _writer is None:
        write_outputs()
        return (time.time() - s_time) / 60.0
    # pin wall_seconds and the minutes now: emit() runs later on the
    # writer thread, and submit() may block on an older scan's write
    stats.stop()
    elapsed = time.time() - s_time
    _writer.submit(write_outputs)
    return elapsed / 60.0


# keep the reference's public name without pytest collecting it as a test
test_scan.__test__ = False


class SegmentationEngine:
    """Binds (params, options) to a device: the object a user of the
    reference's ``net`` + ``test_scan`` pair migrates to.

    ``params`` is a state dict (:func:`~subcort_tpu_torch.models.init_params`,
    :func:`~subcort_tpu_torch.models.load_theano_checkpoint` or
    :func:`~subcort_tpu_torch.models.params_from_jax`); the device comes
    from ``options.mode`` (:func:`~subcort_tpu_torch.config.select_device`),
    and the net is held in ``options.compute_dtype``. ``[tpu]
    data_parallel > 1`` segments every scan over ``devices``
    (:func:`_data_parallel_devices`).
    """

    def __init__(self, params: Params, options: Options,
                 spec: TriPlanarSpec = DEFAULT_SPEC, register_fn=None):
        check_slice_options(options)
        self.options = options
        self.device = select_device(options)
        self.devices = _data_parallel_devices(options)
        self.net = net_in_dtype(
            TriPlanarNet.from_params(params, spec, self.device),
            options["compute_dtype"])
        self.register_fn = register_fn
        self._load_stream = None

    def segment_scan(self, scan_path: str) -> float:
        return test_scan(self.net, scan_path, self.options,
                         register_fn=self.register_fn, device=self.device,
                         devices=self.devices)

    def predict_proba(self, batch) -> np.ndarray:
        """``net.predict_proba`` migration shim (reference nets.py /
        nolearn): softmax probabilities of a pre-extracted patch batch (the
        reference's ``in1..in4`` keys or axial/coronal/sagittal/atlas), in
        memory-bounded chunks."""
        return predict_proba_chunked(self.net, batch).float().cpu().numpy()

    def predict(self, batch) -> np.ndarray:
        """``net.predict`` migration shim: argmax class ids."""
        return np.argmax(self.predict_proba(batch), axis=1)

    def _load_inputs(self, path: str):
        """``_load_scan_inputs`` for the prefetch thread. On the card a
        priors miss registers on the engine's loader stream, a CUDA stream
        of its own, so its kernels need not queue behind the main thread's
        segmentation; the stream is synchronized before the host arrays are
        returned, and no tensor crosses threads. (One stream for every
        load: the caching allocator reuses a stream's freed blocks only on
        that stream.)"""
        args = (path, self.options, self.register_fn, self.device,
                _subject(path))
        if self.device.type != "cuda":
            return _load_scan_inputs(*args)
        if self._load_stream is None:
            self._load_stream = torch.cuda.Stream(self.device)
        stream = self._load_stream
        with torch.cuda.stream(stream):
            out = _load_scan_inputs(*args)
        stream.synchronize()
        return out

    def segment_folder(self) -> dict:
        """Sweep the configured inference folder (train_model.py:68-78
        flow). Returns {subject: minutes}.

        With ``[tpu] folder_pipeline`` on, the sweep is pipelined: while
        the device segments scan *i*, one loader thread prepares scan
        *i+1* (registration on a priors miss, NIfTI gunzip, candidate
        enumeration) and one writer thread drains scan *i-1*'s
        post-processing and gzip writes, so the per-scan host costs overlap
        the device work instead of following it. All outputs are on disk,
        and any write error raised, before this returns; the files equal
        the serial sweep's (tests/test_torch_pipeline.py). Off by default:
        it pays only where the host has spare cores. The returned minutes
        of a pipelined scan cover its segmentation stage only
        (:func:`test_scan`). Under a multi-host launch
        (:func:`~subcort_tpu_torch.parallel.distributed.initialize` with
        more than one process) each process sweeps its strided share of the
        subjects (``host_shard``).
        """
        t1_names, subjects = load_test_names(self.options)
        pairs = list(zip(t1_names, subjects))
        if distributed.process_count() > 1:
            # a multi-host launch: this process's strided slice of the
            # subjects (infer.py:897-902)
            pairs = distributed.host_shard(pairs)
        times = {}
        if not self.options.bool("folder_pipeline") or len(pairs) <= 1:
            for path, sub in pairs:
                if self.options.bool("debug"):
                    print("--> testing scan", sub)
                times[sub] = self.segment_scan(path)
            return times

        # separate single-thread pools: a slow write (a 430 MB prob-map
        # gzip) must not starve the prefetch of the next scan
        with ThreadPoolExecutor(1) as loader, ThreadPoolExecutor(1) as wpool:
            writer = _BoundedWriter(wpool)
            nxt = loader.submit(self._load_inputs, pairs[0][0])
            try:
                for i, (path, sub) in enumerate(pairs):
                    inputs = nxt.result()
                    if i + 1 < len(pairs):
                        nxt = loader.submit(self._load_inputs,
                                            pairs[i + 1][0])
                    if self.options.bool("debug"):
                        print("--> testing scan", sub)
                    times[sub] = test_scan(self.net, path, self.options,
                                           device=self.device,
                                           devices=self.devices,
                                           _inputs=inputs, _writer=writer)
                writer.drain()
            except BaseException:
                # a failed scan or prefetch must not discard the errors of
                # writes already queued: wait them out, report, re-raise
                # the first error
                try:
                    writer.drain()
                except Exception as we:  # noqa: BLE001 (reported, not lost)
                    print(f"--> additionally, a deferred output write "
                          f"failed: {we!r}")
                raise
        return times
