"""Connected-component labeling (port of subcort_tpu/ops/connected.py).

Reference counterpart: ``scipy.ndimage.label`` inside
``post_process_segmentation`` (base.py:469). Two implementations:

- :func:`label_components_np`: host path via scipy (the default).
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
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from scipy import ndimage

from subcort_tpu_torch.config import resolve_device


def label_components_np(mask: np.ndarray):
    """scipy 6-connectivity labeling: (labels int32, num)."""
    labels, num = ndimage.label(mask)
    return labels.astype(np.int32), int(num)


def _sweep(lab: torch.Tensor, mask: torch.Tensor, big: int) -> torch.Tensor:
    """One Jacobi sweep: every in-mask voxel takes the minimum of its own
    label and its 6 neighbours' labels in ``lab`` (the border reads ``big``,
    which never wins, so it needs no pad); outside the mask ``big``."""
    m = lab.clone()
    for axis in range(lab.dim()):
        s = lab.shape[axis]
        if s < 2:
            continue
        hi, lo = m.narrow(axis, 1, s - 1), m.narrow(axis, 0, s - 1)
        torch.minimum(hi, lab.narrow(axis, 0, s - 1), out=hi)
        torch.minimum(lo, lab.narrow(axis, 1, s - 1), out=lo)
    return m.masked_fill_(~mask, big)


@torch.no_grad()
def _propagate_min(mask: torch.Tensor, sweeps_per_check: int = 32,
                   max_checks: int = 64):
    """Min-label propagation to the fixpoint (or the sweep cap) on
    ``mask``'s device.

    Returns (labels, converged): labels = per-voxel component root (the
    component's minimum linear index; -1 outside the mask), int32;
    converged = False iff the last check still saw a change, i.e. the
    result may be unconverged and the caller must not trust it.
    """
    mask = mask.bool()
    n = mask.numel()
    big = n
    lab = torch.where(
        mask, torch.arange(n, dtype=torch.int32,
                           device=mask.device).view(mask.shape), big)
    changed = True
    for _ in range(max_checks):
        new = lab
        for _ in range(sweeps_per_check):
            new = _sweep(new, mask, big)
        changed = bool((new != lab).any())  # one read back per check
        lab = new
        if not changed:
            break
    return torch.where(mask, lab, -1), not changed


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
        warnings.warn(
            "device connected-components hit the sweep cap "
            f"({sweeps_per_check * max_checks} sweeps) before convergence; "
            "falling back to scipy.ndimage.label")
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
