"""The dense evaluator over several devices, one sub-slab each (port of
subcort_tpu/parallel/fcn_sharded.py).

The JAX split geometry: the candidate bbox is cut along its largest axis
into one sub-slab per device entry, ``ceil(dims[axis] / entries)`` voxels
each (the last may overhang the bbox, where no candidate lies; the slab
cut zero-fills outside the volume); each runs
:func:`~subcort_tpu_torch.models.fcn.fcn_forward_slab` on its device, and
the host scatters the results. A sub-slab without candidates runs nothing.

Left out of the JAX version (ROADMAP.md "Not to port"), which shaped it
as one sharded program for a TPU behind a slow link: the packed-bitmask
candidate wire, the common row budget padded with background-pattern
prior rows, and the placeholder shard. Only the geometry stays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from subcort_tpu_torch.engine.infer import _fcn_scatter_results, _fcn_slab
from subcort_tpu_torch.ops.normalize import normalize_stats
from subcort_tpu_torch.parallel.mesh import DeviceWorkers


def spmd_sub_bboxes(lo, dims, ndev: int) -> list:
    """The ``ndev`` (lo, dims) sub-slabs of one bbox (fcn_sharded.py:
    172-187): equal cuts of its largest axis."""
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


def fcn_run_spmd(nets: Dict[torch.device, torch.nn.Module],
                 workers: DeviceWorkers, image: np.ndarray,
                 atlas: np.ndarray, lo, dims, centers: np.ndarray,
                 label_vol: np.ndarray, prob_vol, want_probs: bool,
                 prior_dtype, probs_dtype) -> None:
    """Segment the candidate bbox (lo, dims) with one sub-slab per entry of
    ``workers``, ``nets[device]`` on each, scattering into ``label_vol`` /
    ``prob_vol`` (the contract of ``engine.infer._fcn_run_bboxes``)."""
    stats = normalize_stats(image)
    futures = [
        workers.submit(i, _fcn_slab, nets[dev], image, stats, atlas, sub_lo,
                       sub_dims, prior_dtype, probs_dtype, centers,
                       want_probs, dev)
        for i, (dev, (sub_lo, sub_dims)) in enumerate(zip(
            workers.devices, spmd_sub_bboxes(lo, dims, len(workers.devices))))]
    for f in futures:
        res = f.result()
        if res is not None:  # else no candidates in this sub-slab
            _fcn_scatter_results(*res, label_vol, prob_vol, want_probs)
