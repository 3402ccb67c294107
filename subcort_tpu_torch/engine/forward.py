"""Chunked patch-engine forward: gather -> CNN -> argmax, per center block.

Port of subcort_tpu/engine/forward.py::scan_forward_centers. The JAX
version is a ``lax.scan`` over a padded, power-of-two-bucketed chunk count
so that XLA compiles a bounded set of shapes; PyTorch runs eagerly, so this
is a plain loop over ``chunk``-sized slices and the last one may be short.
Reference counterpart: the per-batch ``net.predict`` loop of
cnn_cort/base.py:421-440.
"""

from __future__ import annotations

import torch

from subcort_tpu_torch.models.triplanar import TriPlanarNet
from subcort_tpu_torch.ops.gather_kernel import (GatherVolume,
                                                 gather_triplanar_cuda)
from subcort_tpu_torch.utils.runtime import check_nans


@torch.inference_mode()
def forward_centers(net: TriPlanarNet, volume: torch.Tensor | GatherVolume,
                    centers: torch.Tensor, atlas_vecs: torch.Tensor,
                    chunk: int, want_probs: bool,
                    probs_dtype: torch.dtype = torch.float32):
    """Classify ``centers`` (N, 3) int32 against the padded volume.

    ``volume``, ``centers`` and ``atlas_vecs`` (N, 15) float32 live on the
    net's device. On the card ``volume`` is the padded volume's
    :func:`~subcort_tpu_torch.ops.gather_kernel.prepare_gather_volume`
    layouts, made once per scan, and the gather is the CUDA kernel; on the
    CPU it is the padded volume and the gather its plain version. The
    gather stays float32 whatever the net's dtype (it does no
    arithmetic); the patches are cast to the net's dtype after it, as the
    JAX Pallas branch does (forward.py:59-70), and the head casts the
    priors. Returns ((N,) uint8 labels, (N, C) probs in ``probs_dtype`` or
    None). uint8 probs are ``round(p * 255)``, quantized once after the
    loop as the JAX version does (forward.py:86-87).
    """
    dtype = next(net.parameters()).dtype
    n = int(centers.shape[0])
    labels = torch.empty(n, dtype=torch.uint8, device=volume.device)
    probs = None
    if want_probs:
        store = torch.float32 if probs_dtype == torch.uint8 else probs_dtype
        probs = torch.empty((n, net.spec.num_classes), dtype=store,
                            device=volume.device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        ax, co, sa = (v.to(dtype) for v in
                      gather_triplanar_cuda(volume, centers[start:stop]))
        p = net(ax, co, sa, atlas_vecs[start:stop])
        check_nans("the patch engine's probabilities", p)
        labels[start:stop] = p.argmax(dim=1)
        if want_probs:
            probs[start:stop] = p
    if want_probs and probs_dtype == torch.uint8:
        probs = torch.round(probs * 255.0).to(torch.uint8)
    return labels, probs
