"""The patch engine over several devices (port of
subcort_tpu/parallel/infer_sharded.py).

The candidate-voxel axis is split over the devices, one contiguous part of
whole chunks per device entry; each part runs the single-device engine:
the normalized padded volume (``_normalized_padded``) and, on the card,
the gather kernel's layouts (``prepare_gather_volume``), once per distinct
device, then :func:`~subcort_tpu_torch.engine.forward.forward_centers`
over the part, chunk by chunk (gather kernel -> CNN -> argmax). No
collective; the host concatenates the parts. Every chunk holds the rows it
holds on one device, so labels and probabilities equal the single-device
run's.

Left out of the JAX version (ROADMAP.md "Not to port"): its padding to
``devices x chunk`` rows and its power-of-two chunk ladder, which kept
XLA's shapes few; the kernel's persistent grid takes any N.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Dict

import numpy as np
import torch

from subcort_tpu_torch.engine.forward import forward_centers
from subcort_tpu_torch.engine.infer import _normalized_padded
from subcort_tpu_torch.ops.gather_kernel import prepare_gather_volume
from subcort_tpu_torch.parallel.mesh import DeviceWorkers, shard_rows


def _volume(image: np.ndarray, device: torch.device):
    volume = _normalized_padded(image, device)
    return prepare_gather_volume(volume) if volume.is_cuda else volume


def _part(net, volume: Future, centers: np.ndarray, vecs: np.ndarray,
          chunk: int, want_probs: bool, probs_dtype, device):
    labels, probs = forward_centers(
        net, volume.result(), torch.from_numpy(centers).to(device),
        torch.from_numpy(vecs).to(device), chunk, want_probs,
        probs_dtype=getattr(torch, np.dtype(probs_dtype).name))
    return (labels.cpu().numpy(),
            probs.cpu().numpy() if want_probs else None)


def predict_labels_sharded(nets: Dict[torch.device, torch.nn.Module],
                           workers: DeviceWorkers, image: np.ndarray,
                           centers: np.ndarray, vecs: np.ndarray,
                           chunk: int, want_probs: bool = False,
                           probs_dtype=np.uint8):
    """Classify ``centers`` (N, 3) int32 of the raw ``image`` with their
    prior rows ``vecs`` (N, 15) float32 over ``workers``' device entries,
    ``nets[device]`` on each. Returns ((N,) uint8 labels, (N, 15) probs in
    ``probs_dtype`` or None) as numpy arrays. Gather launches: one per
    chunk of each part, as many as on one device."""
    devices = workers.devices
    parts = [(i, rows) for i, rows in enumerate(
        shard_rows(len(centers), len(devices), align=chunk))
        if rows.stop > rows.start]
    volumes = {}
    for i, _ in parts:
        if devices[i] not in volumes:
            # the first entry of each device with a part prepares its
            # volume; the others of that device wait for it in their own
            # thread
            volumes[devices[i]] = workers.submit(i, _volume, image,
                                                 devices[i])
    futures = [workers.submit(i, _part, nets[devices[i]],
                              volumes[devices[i]], centers[rows], vecs[rows],
                              chunk, want_probs, probs_dtype, devices[i])
               for i, rows in parts]
    results = [f.result() for f in futures]
    labels = np.concatenate([r[0] for r in results])
    probs = (np.concatenate([r[1] for r in results]) if want_probs
             else None)
    return labels, probs
