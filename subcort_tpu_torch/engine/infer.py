"""Per-scan inference engine (port of subcort_tpu/engine/infer.py).

Reference counterpart: ``test_scan`` + ``load_patch_batch``
(cnn_cort/base.py:335-458). A scan is segmented on the device by one of
two engines over the candidate voxels, with results scattered on the
host. Every call feeds its engine one way: the scan goes up as it is (a
narrow integer, the usual int16 T1) or as float32, with the centers; the
device derives a narrow-integer scan's statistics and the candidates'
bbox (the host those of any other scan), and the engine reads the scan
where it lies:

- the dense path (``engine="fcn"``): each sub-bbox's slab, its patch
  context included, is cut from the uploaded scan and its candidates'
  prior rows derived from the uploaded prior block
  (:mod:`subcort_tpu_torch.ops.scan_inputs`); the slab is normalized on
  the device and run through the à-trous tri-planar convs, then the head
  MLP at the candidate voxels
  (:func:`subcort_tpu_torch.models.fcn.fcn_forward_slab`);
- the patch path (``engine="patch"``): the scan normalized and padded on
  the device, laid out once for the gather kernel on the card, and chunks
  of (the CUDA tri-planar gather kernel -> CNN -> argmax) with the
  candidates' prior rows from the host
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
writer thread); ``cc_backend`` (``auto``: the CUDA kernel where the
engine's device is a card, else scipy) says where the post-process
filters connected components. ``data_parallel > 1``
segments each scan over several devices from this process, one host
thread per device (``segment_volume(devices=...)``: the patch engine's
centers in parts of whole chunks, the dense engine's bbox in one sub-slab
per device with ``fcn_spmd`` or in sub-bboxes dealt round-robin without;
the threads are :class:`~subcort_tpu_torch.parallel.mesh.DeviceWorkers`),
and under a multi-host launch
``segment_folder`` takes this process's share of the subjects. An unknown
``reg_backend`` or ``reg_similarity`` raises a :class:`ValueError`;
nothing is rerouted silently.

Left out of the JAX dense host path, which shaped it for a TPU behind a
slow link: the packed-bitmask candidate wire, compacted prior rows, the
power-of-two shape ladder and the 6 MB slab-split gate; on one device the
port runs the sub-bboxes serially.

Output contract as the reference's (base.py:445-455):
``out_subcortical_prob.nii.gz`` (with out_probabilities; values in 1/255
steps by default, ``probs_dtype = float32`` for exact ones),
``out_subcortical_seg_prec.nii.gz`` (post-processed) or
``out_subcortical_rawseg.nii.gz``, each with the input's affine.

**Whole-volume networks.** The weights decide the path, once
(:data:`KINDS`, one :class:`NetworkKind` a kind of network: its net, its
option check, its host prep and its scan). ``SegmentationEngine`` handed
FastSurfer state dicts (``{"axial": ..., "coronal": ..., "sagittal":
...}``) holds the three view networks
(:class:`~subcort_tpu_torch.models.fastsurfer.FastSurferViews`), and
``test_scan`` and ``segment_folder`` run the multi-view path
(:func:`~subcort_tpu_torch.engine.views.segment_views`), ``post_process``
keeping each class's largest component (a whole-volume mask). Handed a
SynthSeg state dict it holds SynthSeg's 3D U-Net
(:class:`~subcort_tpu_torch.models.synthseg.SynthSegUNet`) and runs
:func:`~subcort_tpu_torch.engine.synthseg.segment_synthseg`, whose own
topology post-process on the card takes the place of the label filter
with ``post_process``. Handed a SwinUNETR state dict (MONAI's names) it
holds :class:`~subcort_tpu_torch.models.swinunetr.SwinUNETR` and runs
:func:`~subcort_tpu_torch.engine.swinunetr.segment_swinunetr` (128^3
windows, Gaussian blending), ``post_process`` keeping each class's largest
component on the device. None of them takes an atlas, registration,
candidates or priors; the options they cannot run (``out_probabilities``,
``data_parallel > 1``, a ``compute_dtype`` other than float32,
``bugcompat_postprocess_argmax``) raise a :class:`ValueError`.
"""

from __future__ import annotations

import copy
import functools
import os
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage

from subcort_tpu_torch.config import Options, exact_float32, select_device
from subcort_tpu_torch.engine.data import _configured_register
from subcort_tpu_torch.engine.forward import forward_centers
from subcort_tpu_torch.engine.metrics import ScanStats
from subcort_tpu_torch.engine.postprocess import post_process_segmentation
from subcort_tpu_torch.engine.swinunetr import segment_swinunetr
from subcort_tpu_torch.engine.synthseg import segment_synthseg
from subcort_tpu_torch.engine.views import segment_views, zooms_of
from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii
from subcort_tpu_torch.models.fastsurfer import (FastSurferViews,
                                                 is_view_params)
from subcort_tpu_torch.models.fcn import HALF, RF, fcn_forward_slab
from subcort_tpu_torch.models.swinunetr import SwinUNETR, is_swinunetr_params
from subcort_tpu_torch.models.synthseg import SynthSegUNet, is_synthseg_params
from subcort_tpu_torch.models.triplanar import (DEFAULT_SPEC, Params,
                                                TriPlanarNet, TriPlanarSpec,
                                                predict_proba_chunked)
from subcort_tpu_torch.ops import bn_prelu, scan_inputs
from subcort_tpu_torch.ops.gather_kernel import prepare_gather_volume
from subcort_tpu_torch.ops.normalize import normalize_stats, stats_from_moments
from subcort_tpu_torch.ops.patches import pad_volume
from subcort_tpu_torch.ops.sampling import get_mask_voxels
from subcort_tpu_torch.parallel import distributed
from subcort_tpu_torch.parallel.mesh import (DeviceWorkers, available_devices,
                                             replicate, shard_rows)
from subcort_tpu_torch.registration.driver import check_registration
from subcort_tpu_torch.utils.runtime import current_request, span

DEFAULT_CHUNK = 8192
# the device's integer sums give normalize_stats' float64 statistics bit for
# bit while the sum of squares (which bounds every partial sum) is below this
EXACT_SQUARES = 2 ** 53


def check_slice_options(options: Options) -> None:
    """Raise for an unknown registration option, before any work."""
    check_registration(options["reg_backend"], options["reg_similarity"])


def check_volume_options(options: Options, path: str) -> None:
    """Raise ``ValueError`` for an option a whole-volume path (``path``
    names it) cannot run."""
    if options.bool("out_probabilities"):
        raise ValueError(f"out_probabilities: {path} writes labels only")
    if int(options["data_parallel"]) > 1:
        raise ValueError(f"data_parallel > 1: {path} runs on one device")
    if options["compute_dtype"] != "float32":
        raise ValueError(f"compute_dtype {options['compute_dtype']!r}: "
                         f"{path} runs in float32")
    if options.bool("bugcompat_postprocess_argmax"):
        raise ValueError(f"bugcompat_postprocess_argmax: {path} has no "
                         "atlas mask to score components against")


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
    return _bbox_from(centers.min(axis=0), centers.max(axis=0) + 1, shape,
                      align)


def _check_centers(lo, hi, shape) -> None:
    """Raise where the centers' extent ``[lo, hi)`` leaves the volume: the
    gather kernel does not clamp."""
    if (np.asarray(lo) < 0).any() or (np.asarray(hi)
                                       > np.asarray(shape)).any():
        raise ValueError(f"centers outside the volume of shape {shape}")


def _bbox_from(lo, hi, shape, align: int = 16):
    """:func:`_bbox_of` from the centers' per-axis extent ``[lo, hi)``."""
    lo, hi = np.asarray(lo), np.asarray(hi)
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


def _wire(image: np.ndarray) -> np.ndarray:
    """``image`` as it goes to the device: a narrow-integer scan (the usual
    int16 T1) as it is, any other as float32, the type every scan is
    normalized in."""
    if image.dtype.kind in "iu" and image.dtype.itemsize <= 2:
        return image
    return image.astype(np.float32)


def _slab_window(lo, dims, shape):
    """The slab of the sub-bbox at ``lo``: per axis the source slice of
    the volume and the destination slice of the (dims + RF) slab; the
    rest of the slab lies outside the volume."""
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
    return tuple(src), tuple(dst)


def _dequantize_probs(probs_b) -> np.ndarray:
    probs_b = np.asarray(probs_b)
    if probs_b.dtype == np.uint8:
        return probs_b.astype(np.float32) * np.float32(1.0 / 255.0)
    return probs_b


def _fcn_scatter_results(labels_b, probs_b, lo, dims, cs, dense, label_vol,
                         prob_vol, want_probs):
    """One slab's results into the volumes at its candidates ``cs``
    (infer.py:344-364): aligned with ``cs``, or, where ``dense``, the
    (bx, by, bz) block of the bbox at ``lo``."""
    if dense:
        rel = cs - np.asarray(lo)[None, :]
        at = rel[:, 0], rel[:, 1], rel[:, 2]
        labels_b = labels_b[at]
        if want_probs:
            probs_b = np.asarray(probs_b).reshape(*dims, -1)[at]
    label_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = labels_b
    if want_probs:
        prob_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = _dequantize_probs(probs_b)


def _readback(labels: torch.Tensor, probs: Optional[torch.Tensor],
              request=None):
    """``labels`` and ``probs`` (or None) on the host as numpy arrays: the
    wait for the device and the copies, as one span."""
    with span("infer.readback", request) as rec:
        labels = labels.cpu().numpy()
        probs = None if probs is None else probs.cpu().numpy()
        rec.set(bytes=labels.nbytes + (0 if probs is None else probs.nbytes))
    return labels, probs


class _Scan(NamedTuple):
    """One call's inputs on one device: the scan as it went up
    (:func:`_wire`; for the patch engine the volume it gathers from,
    :func:`_gather_volume`), the (N, 3) int32 centers, and the candidates'
    whole bbox."""
    volume: torch.Tensor
    centers: torch.Tensor
    lo: np.ndarray
    dims: Tuple[int, int, int]


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``. The CPU takes the host array's memory as it
    lies, strides and all. A card gets it through pinned memory, which the
    host does not wait for: torch's caching host allocator keeps it from
    call to call and hands it out again only once the copy has read it."""
    src = torch.from_numpy(a)
    if device.type == "cpu":
        return src
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    pinned.copy_(src)
    return pinned.to(device, non_blocking=True)


def _upload_scan(wire: np.ndarray, centers: np.ndarray, device,
                 request=None):
    """The scan as it goes up (:func:`_wire`) and the centers on
    ``device``, in one ``infer.upload`` span of ``request``."""
    with span("infer.upload", request,
              bytes=wire.nbytes + centers.nbytes):
        return _upload(wire, device), _upload(centers, device)


def _prepare(image: np.ndarray, wire: np.ndarray, centers: np.ndarray,
             device: torch.device):
    """``image``'s :func:`_wire` copy ``wire`` and the centers uploaded to
    ``device`` (:func:`_upload_scan`), then the scan's statistics and the
    candidates' bbox. Returns (:class:`_Scan`, stats); raises
    :func:`_check_centers`' and then :func:`normalize_stats`' errors.

    The one place where a scan's type matters: a narrow-integer scan of
    fewer than ``scan_inputs.MAX_ELEMENTS`` voxels takes
    :func:`scan_inputs.scan_moments` and the read-back of its nine
    integers, the call's one wait before the forward, and its statistics
    come from the integer sums by :func:`stats_from_moments`, bit-equal to
    the host's, unless the sum of squares reaches ``EXACT_SQUARES``. Any
    other scan takes both from the host."""
    volume, centers_d = _upload_scan(wire, centers, device)
    exact = False
    if (volume.dtype in scan_inputs.VOXEL_TYPES
            and image.size < scan_inputs.MAX_ELEMENTS):
        count, total, squares, *extent = scan_inputs.scan_moments(
            volume, centers_d).tolist()
        lo, hi = np.asarray(extent[:3]), np.asarray(extent[3:]) + 1
        exact = squares < EXACT_SQUARES
    else:
        lo, hi = centers.min(axis=0), centers.max(axis=0) + 1
    _check_centers(lo, hi, image.shape)
    stats = (stats_from_moments(count, float(total), float(squares))
             if exact else normalize_stats(image))
    return _Scan(volume, centers_d, *_bbox_from(lo, hi, image.shape)), stats


def _scan_on(scan: _Scan, device: torch.device, wire: np.ndarray,
             centers: np.ndarray, stats, patch: bool, request) -> _Scan:
    """``scan`` on a further ``device`` of a multi-device call: ``wire``
    and the centers uploaded there, and for the patch engine (``patch``)
    the volume it gathers from."""
    volume, centers_d = _upload_scan(wire, centers, device, request)
    if patch:
        volume = _gather_volume(volume, stats)
    return scan._replace(volume=volume, centers=centers_d)


def _ready(scan) -> _Scan:
    """``scan``, or the result of the future that uploads it."""
    return scan.result() if isinstance(scan, Future) else scan


def _slab_inputs(scan, stats, atlas, lo, dims, prior_dtype, centers,
                 request=None):
    """One sub-bbox's inputs on the device of ``scan`` (a :class:`_Scan`
    or its future): the sub-bbox's prior block uploaded as it lies in
    ``atlas`` (``infer.upload``), then, in ``infer.slab_inputs``, the slab
    cut from the scan and :func:`scan_inputs.prior_rows`. The whole bbox
    holds every candidate; a smaller sub-bbox selects its candidates on
    the device and reads them back for the scatter.

    Returns (slab, rows, lin, norm, cs): the raw slab, with ``norm`` the
    :func:`fcn_forward_slab` argument that normalizes it; ``cs`` the
    sub-bbox's candidates on the host, and ``lin`` their linear bbox
    indices, or None where they fill the bbox (the dense head: a row for
    every bbox voxel and no gather). None where no candidate lies
    inside."""
    scan = _ready(scan)
    bx, by, bz = dims
    device = scan.volume.device
    with span("infer.upload", request) as rec:
        block = atlas[lo[0]:lo[0] + bx, lo[1]:lo[1] + by, lo[2]:lo[2] + bz]
        if block.shape[:3] != tuple(dims):
            # fcn_spmd's last sub-slab may reach past the volume's end,
            # where no candidate lies: rows there are never read
            block = np.pad(block, [(0, d - s) for d, s in zip(
                dims, block.shape[:3])] + [(0, 0)])
        rec.set(bytes=block.nbytes)
        block = _upload(block, device)
    with span("infer.slab_inputs", request) as rec:
        if np.array_equal(lo, scan.lo) and tuple(dims) == scan.dims:
            cs, cs_d = centers, scan.centers
        else:
            c = scan.centers
            inside = torch.ones(len(c), dtype=torch.bool, device=device)
            for k in range(3):
                inside &= (c[:, k] >= int(lo[k])) & (c[:, k]
                                                     < int(lo[k]) + dims[k])
            cs_d = c[inside]
            cs = cs_d.cpu().numpy()
            if len(cs) == 0:
                return None  # nothing to classify here
        sparse = len(cs) < bx * by * bz
        vecs, lin = scan_inputs.prior_rows(block, cs_d if sparse else None,
                                           lo, prior_dtype)
        src, dst = _slab_window(lo, dims, scan.volume.shape)
        # voxels outside the volume are left unset: the forward's norm
        # zeroes everything outside [dst.start, dst.stop)
        slab = scan.volume.new_empty((bx + RF, by + RF, bz + RF))
        slab[dst] = scan.volume[src]
        rec.set(rows=len(vecs))
    mean, std = stats
    scale = torch.tensor([mean, 1.0 / std], dtype=torch.float32).to(device)
    norm = (scale, tuple(s.start for s in dst), tuple(s.stop for s in dst))
    return slab, vecs, lin, norm, cs


def _fcn_slab(net, scan, lo, dims, *, stats, atlas, centers, prior_dtype,
              probs_dtype, want_probs, request=None):
    """One sub-bbox through the dense evaluator on the device of ``scan``:
    :func:`_slab_inputs`, :func:`fcn_forward_slab` and the read-back, each
    a span of ``request`` (None: the request of the span open on this
    thread). Returns the arguments of :func:`_fcn_scatter_results` before
    the volumes, or None where no candidate lies inside."""
    inputs = _slab_inputs(scan, stats, atlas, lo, dims, prior_dtype,
                          centers, request)
    if inputs is None:
        return None
    slab, vecs, lin, norm, cs = inputs
    with span("infer.forward", request) as rec:
        launches = bn_prelu.thread_launches()
        labels_b, probs_b = fcn_forward_slab(
            net, slab, vecs, want_probs,
            probs_dtype=getattr(torch, np.dtype(probs_dtype).name),
            gather_idx=lin, norm=norm)
        rec.set(bn_prelu=bn_prelu.thread_launches() - launches)
    labels_b, probs_b = _readback(labels_b, probs_b if want_probs else None,
                                  request)
    return labels_b, probs_b, lo, dims, cs, lin is None


def _normalized_padded(volume: torch.Tensor, stats) -> torch.Tensor:
    """The halo-padded, nonzero-normalized float32 volume on the device of
    ``volume``, the scan as it went up (:func:`_wire`); ``stats`` are the
    scan's :func:`normalize_stats`. One float32 ``(x - mean) * inv_std``
    for every scan type (JAX: infer.py:86-96, ``_pad_normalize_device``);
    halo voxels are 0 in normalized space."""
    mean, std = stats
    scal = torch.tensor([mean, 1.0 / std], dtype=torch.float32,
                        device=volume.device)
    return pad_volume((volume.to(torch.float32) - scal[0]) * scal[1])


def _gather_volume(volume: torch.Tensor, stats) -> torch.Tensor:
    """The patch engine's volume: :func:`_normalized_padded`, on a card in
    the gather kernel's two layouts (the plain padded volume freed
    there)."""
    volume = _normalized_padded(volume, stats)
    return prepare_gather_volume(volume) if volume.is_cuda else volume


def _patch_part(net, scan, rows: slice, vecs: np.ndarray, *, chunk,
                want_probs, probs_dtype, request=None):
    """The patch engine over ``rows`` of the centers on the device of
    ``scan`` (a :class:`_Scan` whose volume is :func:`_gather_volume`'s,
    or its future): their prior rows ``vecs`` uploaded,
    :func:`forward_centers` chunk by chunk, the read-back. Returns
    (labels, probs or None, rows)."""
    scan = _ready(scan)
    with span("infer.upload", request, bytes=vecs.nbytes):
        vecs = _upload(vecs, scan.volume.device)
    with span("infer.forward", request) as rec:
        launches = bn_prelu.thread_launches()
        labels, probs = forward_centers(
            net, scan.volume, scan.centers[rows], vecs, chunk, want_probs,
            probs_dtype=getattr(torch, np.dtype(probs_dtype).name))
        rec.set(bn_prelu=bn_prelu.thread_launches() - launches)
    return _readback(labels, probs if want_probs else None, request) + (rows,)


def spmd_sub_bboxes(lo, dims, ndev: int) -> list:
    """The ``ndev`` (lo, dims) sub-slabs of one bbox (fcn_sharded.py:
    172-187): equal cuts of its largest axis, the last of which may
    reach past the bbox, where no candidate lies."""
    axis = int(np.argmax(dims))
    step = -(-int(dims[axis]) // ndev)
    out = []
    for d in range(ndev):
        sub_lo = np.asarray(lo, np.int32).copy()
        sub_lo[axis] += d * step
        sub_dims = [int(v) for v in dims]
        sub_dims[axis] = step
        out.append((sub_lo, tuple(sub_dims)))
    return out


def _dense_jobs(lo, dims, entries: int, max_voxels: int, spmd: bool):
    """The dense engine's (entry, (lo, dims)) sub-bboxes over ``entries``
    device entries, the JAX package's geometry (infer.py:367-452,
    529-547): on one entry, sub-bboxes of at most ``max_voxels``; with
    ``spmd``, one equal sub-slab per entry (:func:`spmd_sub_bboxes`)
    inside an outer split that keeps each within ``max_voxels``; else
    sub-bboxes of at most ``ceil(bbox voxels / entries)``, dealt
    round-robin, so that every entry gets work."""
    if entries == 1:
        return [(0, b) for b in _split_bbox(lo, dims, max_voxels)]
    if spmd:
        return [(i, b)
                for outer in _split_bbox(lo, dims, entries * max_voxels)
                for i, b in enumerate(spmd_sub_bboxes(*outer, entries))]
    cap = min(max_voxels, max(1, -(-int(np.prod(dims)) // entries)))
    return [(i % entries, b)
            for i, b in enumerate(_split_bbox(lo, dims, cap))]


def _deal(work, jobs, entries, nets, scans, workers, scatter) -> None:
    """``work(nets[d], scans[d], *args)`` for each (entry, args) of
    ``jobs``, ``d`` the entry's device, each result handed to ``scatter``
    in order: on this thread where ``workers`` is None, else on the
    entry's thread of ``workers``, with at most ``2 x`` its entries' jobs
    in flight before the host scatters the oldest."""
    pending = deque()
    for i, args in jobs:
        dev = entries[i]
        if workers is None:
            scatter(work(nets[dev], scans[dev], *args))
            continue
        pending.append(workers.submit(i, work, nets[dev], scans[dev], *args))
        while len(pending) > 2 * len(entries):
            scatter(pending.popleft().result())
    while pending:
        scatter(pending.popleft().result())


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
    ``prior_dtype`` is the dense path's prior fixed point (uint8, uint16,
    float16 or float32; another raises); the patch path takes float32
    rows, as in JAX. The device work runs with TF32 off
    (:func:`~subcort_tpu_torch.config.exact_float32`).

    Every call takes one path. The scan goes to the (first) device as it
    is where it is a narrow integer, else as float32 (:func:`_wire`), with
    the centers; :func:`_prepare` derives the statistics and the bbox
    there for a narrow-integer scan, on the host for any other. The dense
    engine then cuts each sub-bbox's slab on the device and derives its
    prior rows there (:func:`_slab_inputs`,
    :mod:`~subcort_tpu_torch.ops.scan_inputs`); the patch engine
    normalizes the uploaded scan on the device and gathers from it, with
    the candidates' prior rows from the host. The results are bit-equal
    to the host's derivation.

    ``devices``, a list of more than one ``torch.device`` (an entry may
    repeat), fans the same work out from this process, one host thread
    per entry (infer.py:529-547, 634-649), each further distinct device
    taking its own upload once: the patch engine over parts of whole
    chunks of the centers, one per entry; the dense engine over equal
    sub-slabs of the candidate bbox, one per entry (``fcn_spmd``, the
    default), or over sub-bboxes of at most ``ceil(bbox voxels /
    entries)`` dealt round-robin (``fcn_spmd=False``;
    :func:`_dense_jobs`). ``None`` or one entry runs on this thread.

    The call is one ``infer.segment_volume`` span, its stages spans under
    it (PERF.md §3): ``infer.prepare``, with the upload of the scan and
    the centers as a child ``infer.upload``; then per sub-bbox
    ``infer.upload`` (its prior block), ``infer.slab_inputs``,
    ``infer.forward``, ``infer.readback`` and ``infer.scatter``, or per
    part of the patch engine's centers the same less ``infer.slab_inputs``
    (its ``infer.upload`` carries the prior rows). ``infer.forward``'s
    attribute ``bn_prelu`` counts the BN + PReLU kernel launches it made
    (:mod:`~subcort_tpu_torch.ops.bn_prelu`): 15 a slab or a chunk on a
    card, 0 off it.
    """
    if engine not in ("auto", "fcn", "patch"):
        raise ValueError(f"unknown engine {engine!r}")
    with span("infer.segment_volume"):
        with span("infer.prepare"):
            if devices is not None and len(devices) == 1:
                device, devices = devices[0], None
            if devices is not None:
                entries = [torch.device(d) for d in devices]
            else:
                entries = [torch.device(device) if device is not None
                           else next(net.parameters()).device]
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
            wire = _wire(image)
            scan, stats = _prepare(image, wire, centers, entries[0])
            if engine == "auto":
                engine = ("fcn" if int(np.prod(scan.dims)) <= 30 * n
                          else "patch")
            if engine == "patch":
                vecs = _atlas_vectors_host(atlas, centers)
                scan = scan._replace(volume=_gather_volume(scan.volume,
                                                           stats))
        request = current_request()
        if engine == "patch":
            work = functools.partial(_patch_part, chunk=chunk,
                                     want_probs=want_probs,
                                     probs_dtype=probs_dtype,
                                     request=request)
            jobs = [(i, (rows, vecs[rows])) for i, rows in enumerate(
                shard_rows(n, len(entries), align=chunk))
                if rows.stop > rows.start]

            def scatter(res):
                labels, probs, rows = res
                with span("infer.scatter"):
                    _scatter_centers(labels, probs, centers[rows],
                                     label_vol, prob_vol)
        else:
            work = functools.partial(_fcn_slab, stats=stats, atlas=atlas,
                                     centers=centers,
                                     prior_dtype=prior_dtype,
                                     probs_dtype=probs_dtype,
                                     want_probs=want_probs, request=request)
            jobs = _dense_jobs(scan.lo, scan.dims, len(entries),
                               fcn_max_bbox_voxels, fcn_spmd)

            def scatter(res):
                if res is not None:  # None: no candidate in the sub-bbox
                    with span("infer.scatter"):
                        _fcn_scatter_results(*res, label_vol, prob_vol,
                                             want_probs)

        with exact_float32():
            if len(entries) == 1:
                _deal(work, jobs, entries, {entries[0]: net},
                      {entries[0]: scan}, None, scatter)
                return label_vol, prob_vol
            with DeviceWorkers(entries) as workers:
                scans = {entries[0]: scan}
                for i, dev in enumerate(entries):
                    if dev not in scans:
                        scans[dev] = workers.submit(
                            i, _scan_on, scan, dev, wire, centers, stats,
                            engine == "patch", request)
                _deal(work, jobs, entries, replicate(net, entries), scans,
                      workers, scatter)
        return label_vol, prob_vol


def _scatter_centers(labels, probs, centers, label_vol, prob_vol) -> None:
    """The patch engine's per-center results into the volumes."""
    label_vol[centers[:, 0], centers[:, 1], centers[:, 2]] = labels
    if probs is not None:
        prob_vol[centers[:, 0], centers[:, 1], centers[:, 2]] = \
            _dequantize_probs(probs)


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
              _inputs=None, _writer=None, on_raw_labels=None) -> float:
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

    ``on_raw_labels(subject, labels)``, where given, receives the scan's
    labels on this thread before the write's post-process: the engine's
    raw labels for the tri-planar net and FastSurfer's; SynthSeg and
    SwinUNETR post-process on the device inside their segmentation, so
    theirs are what is written. The array must not be changed.
    """
    kind = kind_of_net(net)
    kind.check(options)
    with span("infer.scan", _subject(scan_path)):
        return kind.scan(net, scan_path, options, register_fn, device,
                         devices, _inputs, _writer,
                         on_raw_labels=on_raw_labels)


def _deliver(write_outputs, s_time: float, stats: ScanStats,
             _writer) -> float:
    """Run a scan's ``write_outputs`` now, or queue it on ``_writer``;
    the scan's minutes (without the deferred writes)."""
    if _writer is None:
        write_outputs()
        return (time.time() - s_time) / 60.0
    # pin wall_seconds and the minutes now: emit() runs later on the
    # writer thread, and submit() may block on an older scan's write
    stats.stop()
    elapsed = time.time() - s_time
    _writer.submit(write_outputs)
    return elapsed / 60.0


def _load_volume_inputs(scan_path: str, options: Options = None,
                        register_fn=None, device=None, request=None):
    """A whole-volume path's host prep: the T1 (``infer.load``)."""
    with span("infer.load", request):
        t1 = load_nii(scan_path)
        return t1, np.asarray(t1.data)


def _test_scan_volume(segment, finish, net, scan_path, options, register_fn,
                      device, devices, _inputs, _writer,
                      on_raw_labels=None) -> float:
    """:func:`test_scan` by a whole-volume network, inside its span: the
    labels of ``segment(net, image, zooms, options, device)``, and, with
    ``post_process``, ``finish(labels, options, device)`` (None: the
    labels as they are) written on the writer's side."""
    s_time = time.time()
    image_dir, _ = os.path.split(scan_path)
    t1, image = (_inputs if _inputs is not None
                 else _load_volume_inputs(scan_path))
    stats = ScanStats(scan_path).set(volume_shape=list(image.shape))
    on = device if device is not None else next(net.parameters()).device
    labels = segment(net, image, zooms_of(t1.affine), options, on)
    affine = t1.affine
    subject = _subject(scan_path)
    if on_raw_labels is not None:
        on_raw_labels(subject, labels)

    def write_outputs():
        with span("infer.write", subject):
            if options.bool("post_process"):
                out = labels if finish is None else finish(labels, options,
                                                           on)
                save_nii(NiftiImage(out, affine),
                         os.path.join(image_dir,
                                      "out_subcortical_seg_prec.nii.gz"))
            else:
                save_nii(NiftiImage(labels, affine),
                         os.path.join(image_dir,
                                      "out_subcortical_rawseg.nii.gz"))
            if options["net_verbose"]:
                stats.emit()

    return _deliver(write_outputs, s_time, stats, _writer)


def _views_labels(nets, image, zooms, options, device):
    return segment_views(nets, image, zooms, device=device)


def _views_finish(labels, options, device):
    return post_process_segmentation(
        None, labels, atlas_mask=np.ones(labels.shape, bool),
        cc_backend=options["cc_backend"], device=device)


def _synthseg_labels(net, image, zooms, options, device):
    return segment_synthseg(net, image, zooms, device=device,
                            post_process=options.bool("post_process"))


def _swinunetr_labels(net, image, zooms, options, device):
    return segment_swinunetr(net, image, zooms, device=device,
                             post_process=options.bool("post_process"),
                             cc_backend=options["cc_backend"])


def _test_scan(net, scan_path, options, register_fn, device, devices,
               _inputs, _writer, on_raw_labels=None) -> float:
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
    if on_raw_labels is not None:
        on_raw_labels(subject, label_vol)

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

    return _deliver(write_outputs, s_time, stats, _writer)


# keep the reference's public name without pytest collecting it as a test
test_scan.__test__ = False


class NetworkKind(NamedTuple):
    """One kind of network the engine runs, chosen once from its weights
    or its net: ``net_type``; ``owns(params)``, whether weights are its;
    ``build(params, options, spec, device)``, its net; ``check(options)``,
    which raises for an option its path cannot run; ``load(scan_path,
    options, register_fn, device, request)``, a scan's host prep (what
    ``test_scan`` takes as ``_inputs``); ``scan(net, scan_path, options,
    register_fn, device, devices, _inputs, _writer, on_raw_labels=)``, the
    body of :func:`test_scan`; ``patches``, whether it takes patch batches and
    candidates (``predict_proba``, data parallelism, registration)."""
    name: str
    net_type: type
    owns: Callable
    build: Callable
    check: Callable
    load: Callable
    scan: Callable
    patches: bool


def _build_triplanar(params, options, spec, device):
    return net_in_dtype(TriPlanarNet.from_params(params, spec, device),
                        options["compute_dtype"])


def _load_triplanar(*args):
    # through the module's name at each call, which tests replace
    return _load_scan_inputs(*args)


TRIPLANAR = NetworkKind(
    "tri-planar", TriPlanarNet, lambda params: True, _build_triplanar,
    check_slice_options, _load_triplanar, _test_scan, True)
VIEWS = NetworkKind(
    "FastSurferCNN", FastSurferViews, is_view_params,
    lambda params, options, spec, device: FastSurferViews.from_params(
        params, device),
    functools.partial(check_volume_options, path="the multi-view path"),
    _load_volume_inputs,
    functools.partial(_test_scan_volume, _views_labels, _views_finish),
    False)
SYNTHSEG = NetworkKind(
    "SynthSeg", SynthSegUNet, is_synthseg_params,
    lambda params, options, spec, device: SynthSegUNet.from_params(
        params, device),
    functools.partial(check_volume_options, path="SynthSeg's path"),
    _load_volume_inputs,
    functools.partial(_test_scan_volume, _synthseg_labels, None), False)
SWINUNETR = NetworkKind(
    "SwinUNETR", SwinUNETR, is_swinunetr_params,
    lambda params, options, spec, device: SwinUNETR.from_params(
        params, device),
    functools.partial(check_volume_options, path="SwinUNETR's path"),
    _load_volume_inputs,
    functools.partial(_test_scan_volume, _swinunetr_labels, None), False)
# the first whose ``owns`` (or net type) fits; the tri-planar net last
KINDS = (VIEWS, SYNTHSEG, SWINUNETR, TRIPLANAR)


def kind_of_params(params) -> NetworkKind:
    """The kind whose weights ``params`` are."""
    return next(k for k in KINDS if k.owns(params))


def kind_of_net(net) -> NetworkKind:
    """The kind of ``net`` (any other net is taken as tri-planar)."""
    return next((k for k in KINDS if isinstance(net, k.net_type)),
                TRIPLANAR)


class SegmentationEngine:
    """Binds (params, options) to a device: the object a user of the
    reference's ``net`` + ``test_scan`` pair migrates to.

    ``params`` is a state dict (:func:`~subcort_tpu_torch.models.init_params`,
    :func:`~subcort_tpu_torch.models.load_theano_checkpoint` or
    :func:`~subcort_tpu_torch.models.params_from_jax`), FastSurfer
    state dicts, one a view (``{"axial": ..., "coronal": ...,
    "sagittal": ...}``), for the multi-view path, or a SynthSeg or a
    SwinUNETR state dict for their paths (:data:`KINDS`); the device comes
    from ``options.mode`` (:func:`~subcort_tpu_torch.config.select_device`),
    and the net is held in ``options.compute_dtype``. ``[tpu]
    data_parallel > 1`` segments every scan over ``devices``
    (:func:`_data_parallel_devices`).
    """

    def __init__(self, params: Params, options: Options,
                 spec: TriPlanarSpec = DEFAULT_SPEC, register_fn=None):
        self.options = options
        self.device = select_device(options)
        self.kind = kind_of_params(params)
        self.kind.check(options)
        self.devices = (_data_parallel_devices(options)
                        if self.kind.patches else None)
        self.net = self.kind.build(params, options, spec, self.device)
        self.register_fn = register_fn
        self._load_stream = None

    def segment_scan(self, scan_path: str, on_raw_labels=None) -> float:
        return test_scan(self.net, scan_path, self.options,
                         register_fn=self.register_fn, device=self.device,
                         devices=self.devices, on_raw_labels=on_raw_labels)

    def predict_proba(self, batch) -> np.ndarray:
        """``net.predict_proba`` migration shim (reference nets.py /
        nolearn): softmax probabilities of a pre-extracted patch batch (the
        reference's ``in1..in4`` keys or axial/coronal/sagittal/atlas), in
        memory-bounded chunks."""
        if not self.kind.patches:
            raise ValueError(f"predict_proba takes tri-planar patch batches; "
                             f"the {self.kind.name} net segments whole "
                             f"scans")
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
        if self.device.type != "cuda" or not self.kind.patches:
            return self.kind.load(*args)
        if self._load_stream is None:
            self._load_stream = torch.cuda.Stream(self.device)
        stream = self._load_stream
        with torch.cuda.stream(stream):
            out = self.kind.load(*args)
        stream.synchronize()
        return out

    def segment_folder(self, on_raw_labels=None) -> dict:
        """Sweep the configured inference folder (train_model.py:68-78
        flow). Returns {subject: minutes}. ``on_raw_labels(subject,
        labels)`` receives each scan's labels before the write's
        post-process, on the calling thread (:func:`test_scan`).

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
            hook = ({} if on_raw_labels is None
                    else {"on_raw_labels": on_raw_labels})
            for path, sub in pairs:
                if self.options.bool("debug"):
                    print("--> testing scan", sub)
                times[sub] = self.segment_scan(path, **hook)
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
                                           _inputs=inputs, _writer=writer,
                                           on_raw_labels=on_raw_labels)
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
