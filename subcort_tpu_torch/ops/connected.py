"""Connected-component labeling and the post-process's per-class component
filter (port of subcort_tpu/ops/connected.py, and more).

Reference counterpart: ``scipy.ndimage.label`` inside
``post_process_segmentation`` (base.py:469). Labeling:

- :func:`label_components_np`: host path via scipy.
- :func:`label_components_device`: iterative min-label propagation
  (6-connectivity, scipy's default structuring element) in plain torch ops
  on the card. Each voxel starts with its linear index (``n`` outside the
  mask); every sweep takes the minimum over itself and its 6 neighbours,
  the volume's border padded with ``n``; at the fixpoint every component
  is labeled by its minimum linear index, then densified to 1..num on the
  host. Convergence takes O(component diameter) sweeps, so sweeps are
  batched (``sweeps_per_check``) between reads of a changed flag.

Correctness guarantee, as in the JAX package: :func:`_propagate_min`
returns a converged flag (it stops at the fixpoint or at the sweep cap),
and :func:`label_components_device` falls back to scipy with a warning
when a pathological (serpentine, diameter > sweeps_per_check * max_checks)
component exceeds the cap, so no input is silently mislabeled.

The filter (:func:`filter_components`): for each class 1..num_classes-1,
keep the component with the most voxels inside the atlas mask, or the
largest when none touches it; the first in raster order wins a tie, as
scipy numbers components and ``np.argmax`` takes the first maximum.
:func:`filter_components_np` is the host's per-class loop over scipy. On a
CUDA tensor :func:`filter_components` launches the kernel
``csrc/filter_components.cu`` (its header says what bounds it and how it
works: union-find over every class at once, five launches, no host sync),
or raises; on a CPU tensor it runs :func:`filter_components_plain`, which
runs :func:`_propagate_min` once for every class, then scores the same
packed keys as the kernel with ``scatter_reduce``. ``FILTER_LAUNCHES``
counts the calls that reached the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import warnings
from pathlib import Path

import numpy as np
import torch
from scipy import ndimage

from subcort_tpu_torch.config import resolve_device
from subcort_tpu_torch.utils.build import load_library
from subcort_tpu_torch.utils.graphs import count_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "filter_components.cu"

# the kernel takes uint8 labels
MAX_CLASSES = 256
# the least bytes the kernel moves a voxel (its source's header): labels
# and atlas read, the output written, a 4-byte parent written, read and
# rewritten, and read again
FILTER_BYTES_PER_VOXEL = 19
# a root's rank in the low word of a score: the smaller root ranks higher
_RANK = 0xFFFFFFFF

FILTER_LAUNCHES = 0
# the writer thread and the main thread may filter at once
_LOCK = threading.Lock()


def label_components_np(mask: np.ndarray):
    """scipy 6-connectivity labeling: (labels int32, num)."""
    labels, num = ndimage.label(mask)
    return labels.astype(np.int32), int(num)


def _links(labels: torch.Tensor) -> list:
    """Per axis, whether each voxel and its successor along the axis share
    a class (0 is none): (axis, bool tensor one shorter along it)."""
    out = []
    for axis in range(labels.dim()):
        s = labels.shape[axis]
        if s < 2:
            continue
        lo, hi = labels.narrow(axis, 0, s - 1), labels.narrow(axis, 1, s - 1)
        out.append((axis, (lo == hi) & (lo != 0)))
    return out


def _sweep(lab: torch.Tensor, links: list, big: int) -> torch.Tensor:
    """One Jacobi sweep: every labelled voxel takes the minimum of its own
    label and those of its 6 neighbours of its class in ``lab``; the border
    and other classes read ``big``, which never wins, and the background
    keeps ``big``."""
    m = lab.clone()
    for axis, same in links:
        s = lab.shape[axis]
        hi, lo = m.narrow(axis, 1, s - 1), m.narrow(axis, 0, s - 1)
        torch.minimum(hi, torch.where(same, lab.narrow(axis, 0, s - 1), big),
                      out=hi)
        torch.minimum(lo, torch.where(same, lab.narrow(axis, 1, s - 1), big),
                      out=lo)
    return m


@torch.no_grad()
def _propagate_min(labels: torch.Tensor, sweeps_per_check: int = 32,
                   max_checks: int = 64):
    """Min-label propagation to the fixpoint (or the sweep cap) on
    ``labels``' device, over the components of each nonzero value at once
    (a bool mask has one).

    Returns (labels, converged): labels = per-voxel component root (the
    component's minimum linear index; -1 where ``labels`` is 0), int32;
    converged = False iff the last check still saw a change, i.e. the
    result may be unconverged and the caller must not trust it.
    """
    mask = labels != 0
    links = _links(labels)
    n = mask.numel()
    big = n
    lab = torch.where(
        mask, torch.arange(n, dtype=torch.int32,
                           device=mask.device).view(mask.shape), big)
    changed = True
    for _ in range(max_checks):
        new = lab
        for _ in range(sweeps_per_check):
            new = _sweep(new, links, big)
        changed = bool((new != lab).any())  # one read back per check
        lab = new
        if not changed:
            break
    return torch.where(mask, lab, -1), not changed


def _warn_sweep_cap(sweeps: int) -> None:
    warnings.warn(
        f"device connected-components hit the sweep cap ({sweeps} sweeps) "
        "before convergence; falling back to scipy.ndimage.label")


def label_components_device(mask: np.ndarray, *, sweeps_per_check: int = 32,
                            max_checks: int = 64, device=None):
    """Connected components on the device; the contract of
    :func:`label_components_np` (labels densified to 1..num in the scan
    order of each component's minimum index). ``device=None`` is the card
    (:func:`~subcort_tpu_torch.config.resolve_device`, which raises
    without one).

    Falls back to scipy (with a warning) if propagation did not reach its
    fixpoint within ``sweeps_per_check * max_checks`` sweeps: only
    adversarial serpentine shapes get there; anatomical components have
    diameters far below the default 2048-sweep budget.
    """
    mask_np = np.asarray(mask, bool)
    dev = resolve_device(device)
    roots_t, converged = _propagate_min(
        torch.from_numpy(mask_np).to(dev), sweeps_per_check=sweeps_per_check,
        max_checks=max_checks)
    if not converged:
        _warn_sweep_cap(sweeps_per_check * max_checks)
        return label_components_np(mask_np)
    roots = roots_t.cpu().numpy()
    # vectorized densify: unique roots (ascending == scan order of the
    # component minimum) -> contiguous ids; inverse maps every voxel
    uniq, inv = np.unique(roots, return_inverse=True)
    has_bg = uniq.size and uniq[0] == -1
    ids = np.arange(1 - int(has_bg), uniq.size + 1 - int(has_bg),
                    dtype=np.int32)
    if has_bg:
        ids[0] = 0
    out = ids[inv].reshape(mask_np.shape)
    return out, int(uniq.size - int(has_bg))


# ------------------------------------------------------------------ filter
def filter_components_np(input_mask: np.ndarray, atlas_mask: np.ndarray,
                         num_classes: int) -> np.ndarray:
    """The filter on the host: per class, scipy's labeling, the overlap
    counts with the bool ``atlas_mask`` and the winner's voxels."""
    filtered = np.zeros_like(input_mask)
    for l in range(1, num_classes):
        th = input_mask == l
        labels, num = label_components_np(th)
        if num == 0:
            continue
        overlap_counts = np.bincount(
            labels[np.logical_and(th, atlas_mask)], minlength=num + 1)[1:]
        if overlap_counts.max(initial=0) > 0:
            winner = int(np.argmax(overlap_counts)) + 1
        else:
            # no component touches the atlas: keep the largest by size
            sizes = np.bincount(labels[th], minlength=num + 1)[1:]
            winner = int(np.argmax(sizes)) + 1
        filtered[labels == winner] = l
    return filtered


def _check_filter_args(labels: torch.Tensor, atlas: torch.Tensor,
                       num_classes: int) -> None:
    if labels.dim() != 3 or labels.dtype != torch.uint8:
        raise ValueError(f"labels must be a 3-D uint8 tensor, got "
                         f"{labels.dtype} of shape {tuple(labels.shape)}")
    if atlas.shape != labels.shape or atlas.dtype not in (torch.bool,
                                                          torch.uint8):
        raise ValueError(f"atlas must be bool or uint8 of the labels' shape "
                         f"{tuple(labels.shape)}, got {atlas.dtype} of shape "
                         f"{tuple(atlas.shape)}")
    if atlas.device != labels.device:
        raise ValueError(f"labels on {labels.device}, atlas on "
                         f"{atlas.device}")
    if num_classes < 1:
        raise ValueError(f"num_classes must be at least 1, got {num_classes}")


@torch.no_grad()
def filter_components_plain(labels: torch.Tensor, atlas: torch.Tensor,
                            num_classes: int, *, sweeps_per_check: int = 32,
                            max_checks: int = 64) -> torch.Tensor:
    """The kernel's plain version, on ``labels``' device: one
    :func:`_propagate_min` over every class, then the sizes, the overlaps
    and the winners' packed keys, (count << 32) | (2**32 - 1 - root), by
    ``bincount`` and ``scatter_reduce``. Falls back to
    :func:`filter_components_np` with a warning where propagation hits
    its sweep cap."""
    _check_filter_args(labels, atlas, num_classes)
    cls = torch.where(labels < num_classes, labels, 0)
    roots, converged = _propagate_min(cls, sweeps_per_check=sweeps_per_check,
                                      max_checks=max_checks)
    if not converged:
        _warn_sweep_cap(sweeps_per_check * max_checks)
        return torch.from_numpy(filter_components_np(
            labels.cpu().numpy(), atlas.cpu().numpy() != 0,
            num_classes)).to(labels.device)
    roots = roots.reshape(-1).long()
    cls = cls.reshape(-1).long()
    n = roots.numel()
    voxels = torch.nonzero(roots >= 0)[:, 0]
    r = roots[voxels]
    size = torch.bincount(r, minlength=n)
    overlap = torch.bincount(r[atlas.reshape(-1)[voxels] != 0], minlength=n)
    root = voxels[r == voxels]
    rank = _RANK - root
    keys = torch.stack([(overlap[root] << 32) | rank,
                        (size[root] << 32) | rank])
    best = torch.zeros((2, num_classes), dtype=torch.int64,
                       device=labels.device).scatter_reduce_(
        1, cls[root].expand(2, -1), keys, "amax")
    won = torch.where((best[0] >> 32) > 0, best[0], best[1])
    winner = _RANK - (won & _RANK)
    keep = (roots >= 0) & (roots == winner[cls])
    return torch.where(keep, cls, 0).to(torch.uint8).view(labels.shape)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``SOURCE``."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.filter_components_u8.argtypes = [p, p, i64, i64, i64, i32, p, p, p,
                                         p, p]
    lib.filter_components_u8.restype = i32
    lib.filter_components_error_string.argtypes = [i32]
    lib.filter_components_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_once() -> ctypes.CDLL:
    return bind(load_library("filter_components", [SOURCE]))


def _library() -> ctypes.CDLL:
    # under the lock: threads that filter at once build and load it once
    with _LOCK:
        return _library_once()


def _add_filter_launches(n: int) -> None:
    global FILTER_LAUNCHES
    with _LOCK:
        FILTER_LAUNCHES += n


def filter_components(labels: torch.Tensor, atlas: torch.Tensor,
                      num_classes: int) -> torch.Tensor:
    """The per-class component filter of ``labels`` (3-D uint8; 0 and any
    value >= ``num_classes`` are background) against ``atlas`` (bool or
    uint8, nonzero inside), as a new uint8 tensor on their device: what
    :func:`filter_components_np` computes. A CUDA tensor launches the
    kernel on the current stream without a host sync, or raises; a CPU
    tensor takes :func:`filter_components_plain`."""
    _check_filter_args(labels, atlas, num_classes)
    if labels.device.type == "cpu":
        return filter_components_plain(labels, atlas, num_classes)
    if labels.device.type != "cuda":
        raise ValueError(f"no component filter for device {labels.device}")
    if num_classes > MAX_CLASSES:
        raise ValueError(f"the kernel takes at most {MAX_CLASSES} classes, "
                         f"got {num_classes}")
    if not (labels.is_contiguous() and atlas.is_contiguous()):
        raise ValueError("labels and atlas must be contiguous")
    n = labels.numel()
    if n >= 2 ** 31:
        raise ValueError(f"{n} voxels exceed one launch")
    dev = labels.device
    out = torch.empty_like(labels)
    if n == 0:
        return out
    parent = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int64, device=dev)
    best = torch.empty(2 * num_classes, dtype=torch.int64, device=dev)
    lib = _library()
    nx, ny, nz = labels.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.filter_components_u8(
            labels.data_ptr(), atlas.data_ptr(), nx, ny, nz, num_classes,
            parent.data_ptr(), counts.data_ptr(), best.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        msg = lib.filter_components_error_string(err).decode()
        raise RuntimeError(f"filter_components launch failed: error {err} "
                           f"({msg})")
    count_launch(_add_filter_launches)
    return out
