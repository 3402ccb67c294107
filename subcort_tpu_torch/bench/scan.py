"""Headline benchmark (port of the repo root's ``bench.py``): full-scan
voxelwise segmentation on one card.

Reproduces the reference's production inference configuration
(BASELINE.json config #3: speedup_segmentation=True — atlas-ROI cropped
candidate set, pretrained miccai2012_v1 weights, 15-class labels) on an
MNI-sized synthetic scan, and reports per-scan wall-clock + voxel
throughput.

Baseline: the reference records no per-scan number (BASELINE.md); the
north-star target is < 5 s per scan. ``vs_baseline`` is reported against
that 5 s target (>1.0 = faster than target).

    python -m subcort_tpu_torch.bench.scan [--mode cpu]

Knobs, the original's: ``SUBCORT_BENCH_REPEATS`` (9 interleaved repeats
of each configuration) and ``SUBCORT_BENCH_ORACLE_N`` (256 oracle voxels).

Prints ONE JSON line, the original's keys:
  {"metric": "per_scan_segmentation_wallclock", "value": N,
   "unit": "seconds", "vs_baseline": N, ...}
``device`` is ``torch.cuda.get_device_name()``, or ``"cpu"``.
``peak_flops_assumed`` is the card's dense bfloat16 tensor-core peak from
:data:`PEAK_FLOPS`; for a device not in the table it and both ``est_mfu_*``
keys are null. ``est_flops_per_scan`` counts the head MLP over the port's
own rows, one per candidate, where the JAX package counts its wire's
power-of-two padded rows.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time
from pathlib import Path

import numpy as np
import torch
from scipy import ndimage

from subcort_tpu_torch.bench.train import device_name
from subcort_tpu_torch.config import Options, exact_float32, select_device
from subcort_tpu_torch.engine.infer import (_atlas_vectors_host, _prepare,
                                            _slab_inputs, _wire, net_in_dtype,
                                            segment_volume)
from subcort_tpu_torch.engine.postprocess import post_process_segmentation
from subcort_tpu_torch.models import (DEFAULT_SPEC, TriPlanarNet,
                                      init_params, load_theano_checkpoint)
from subcort_tpu_torch.models.fcn import fcn_forward_slab, slab_flops
from subcort_tpu_torch.ops.normalize import normalize_nonzero
from subcort_tpu_torch.ops.patches import gather_triplanar_np

REF_CKPT = "/root/reference/nets/miccai2012_v1/miccai2012_v1.pkl"
TARGET_SECONDS = 5.0  # north-star: <5 s/scan (BASELINE.md)
SHAPE = (181, 217, 181)
# dense bfloat16 tensor-core peak, FLOP/s, by torch.cuda.get_device_name():
# H100 SXM5, NVIDIA's data sheet (1,979 TFLOP/s is the figure with sparsity)
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}
DEVICE_CALLS = 8
ORACLE = Path(__file__).resolve().parents[2] / "tests" / "lasagne_oracle.py"


def make_scan(rng):
    """MNI-dimension synthetic T1 + prior atlas + subcortical ROI."""
    # int16 voxels: the dtype real T1 NIfTIs ship with — exercises the
    # raw-slab path (device-side normalization, half the h2d bytes)
    image = np.zeros(SHAPE, np.int16)
    # brain-ish ellipsoid of nonzero intensities
    x, y, z = np.ogrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    brain = (((x - 90) / 80.0) ** 2 + ((y - 108) / 95.0) ** 2
             + ((z - 90) / 78.0) ** 2) < 1.0
    image[brain] = (rng.random(int(brain.sum())) * 800 + 100).astype(np.int16)

    atlas = np.zeros(SHAPE + (15,), np.float32)
    atlas[..., 14] = 1.0
    # subcortical blob: central region with structure priors
    roi = (((x - 90) / 28.0) ** 2 + ((y - 108) / 32.0) ** 2
           + ((z - 90) / 26.0) ** 2) < 1.0
    pri = rng.random((int(roi.sum()), 15)).astype(np.float32)
    pri /= pri.sum(1, keepdims=True)
    atlas[roi] = pri
    return image, atlas, roi


def peak_flops(name: str):
    """The dense bfloat16 peak in FLOP/s of the device called ``name``
    (``torch.cuda.get_device_name``), or None when the table does not hold
    it."""
    return PEAK_FLOPS.get(name)


def _seconds(device: torch.device, fn) -> float:
    """Seconds that ``fn`` takes on ``device``: CUDA events around it on a
    card, the host's clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3


def _load_oracle():
    """tests/lasagne_oracle.py, the numpy float64 forward with the
    reference's Lasagne semantics (it imports only numpy and pickle)."""
    spec = importlib.util.spec_from_file_location("lasagne_oracle", ORACLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(net: TriPlanarNet, image: np.ndarray, atlas: np.ndarray,
        roi: np.ndarray, rng: np.random.Generator, *, device,
        repeats: int, oracle_n: int, checkpoint: str | None = None) -> dict:
    """The benchmark on ``net`` (on ``device``) over one scan, in the
    original's order; prints its JSON line and returns it. ``rng`` is the
    generator ``make_scan`` drew from: the oracle's voxel sample comes
    next from it. ``checkpoint`` is the reference-format pickle ``net``
    holds, which the oracle canary reads; None (seeded weights) skips the
    canary, as the original does without its checkpoint."""
    device = torch.device(device)
    # candidate voxels: dilated subcortical ROI (reference crop semantics)
    b_mask = ndimage.binary_dilation(roi, iterations=10)
    centers = np.stack(np.nonzero(b_mask), axis=1).astype(np.int32)
    n_vox = centers.shape[0]

    # warm-up: cuDNN's first calls (algorithm choice, handles) excluded,
    # as the reference's Theano compile would be
    labels, _ = segment_volume(net, image, atlas, centers)
    segment_volume(net, image, atlas, centers, want_probs=True)

    # headline: the reference's default production config
    # (speedup_segmentation=True + post_process=True, configuration.cfg)
    def run_exact():
        nonlocal labels
        labels, _ = segment_volume(net, image, atlas, centers)
        post_process_segmentation(None, labels, atlas_mask=roi)

    # secondary: the fast profile — bfloat16 activations + uint8 prior
    # rows. Lossy by design; label agreement vs the exact path is reported
    # alongside.
    fast_kw = dict(compute_dtype="bfloat16", prior_dtype=np.uint8)
    labels_fast, _ = segment_volume(net, image, atlas, centers, **fast_kw)

    def run_fast():
        nonlocal labels_fast
        labels_fast, _ = segment_volume(net, image, atlas, centers,
                                        **fast_kw)
        post_process_segmentation(None, labels_fast, atlas_mask=roi)

    # secondary: + 15-class probability maps (out_probabilities=True)
    def run_probs():
        labels_p, _ = segment_volume(net, image, atlas, centers,
                                     want_probs=True)
        post_process_segmentation(None, labels_p, atlas_mask=roi)

    # the three configurations interleaved, so that they sample the same
    # phases of the host's load; per-config min and median. segment_volume
    # returns numpy, so each call ends synchronized.
    samples = {"exact": [], "fast": [], "probs": []}
    for _ in range(repeats):
        for name, fn in (("exact", run_exact), ("fast", run_fast),
                         ("probs", run_probs)):
            t0 = time.perf_counter()
            fn()
            samples[name].append(time.perf_counter() - t0)

    def stats(name):
        ts = sorted(samples[name])
        return ts[0], ts[len(ts) // 2]

    per_scan, per_scan_med = stats("exact")
    fast_per_scan, fast_med = stats("fast")
    with_probs, with_probs_med = stats("probs")

    # device time: the headline configs' fcn_forward_slab on inputs staged
    # once by segment_volume's own input stage (raw slab, prior rows, int64
    # candidate indices, norm), one warm-up call, then DEVICE_CALLS back to
    # back, TF32 off
    scan, nstats = _prepare(image, _wire(image), centers, device)
    dims = scan.dims

    def time_device(timed_net, prior_dtype):
        slab, vecs, lin, norm, _ = _slab_inputs(
            scan, nstats, atlas, scan.lo, dims, prior_dtype, centers)
        args = (timed_net, slab, vecs)
        kw = dict(gather_idx=lin, norm=norm)
        with exact_float32():
            fcn_forward_slab(*args, **kw)

            def calls():
                for _ in range(DEVICE_CALLS):
                    fcn_forward_slab(*args, **kw)

            seconds = _seconds(device, calls)
        return seconds / DEVICE_CALLS, len(vecs)

    device_f32, m_rows = time_device(net, np.uint16)
    device_bf16, _ = time_device(net_in_dtype(net, "bfloat16"), np.uint8)
    # FLOPs of one slab call: dense à-trous branches over the align-16
    # bbox + head MLP over the candidate rows
    flops = slab_flops(dims, m_rows=m_rows, spec=net.spec)
    peak = peak_flops(device_name(device))

    # quality canary: the two independent engines (dense à-trous vs the
    # patch engine's gather kernel) must agree at scale
    labels_patch, _ = segment_volume(net, image, atlas, centers,
                                     engine="patch")
    sel = centers[:, 0], centers[:, 1], centers[:, 2]
    agreement = float((labels[sel] == labels_patch[sel]).mean())

    # independent oracle canary: the pure-numpy Lasagne-semantics forward
    # (tests/lasagne_oracle.py) on a voxel sample of this scan; drift
    # common to both engines would pass the engine agreement but not this
    oracle_agreement = None
    if checkpoint is not None:
        oracle = _load_oracle()
        raw = oracle.load_raw(checkpoint)
        # 256 samples: enough resolution to flag drift (1 disagreement =
        # 0.996) without dominating the benchmark's wall clock
        sub = centers[rng.choice(n_vox, size=oracle_n, replace=False)]
        norm, _, _ = normalize_nonzero(image)
        ax, co, sa = gather_triplanar_np(norm, sub)
        vec = _atlas_vectors_host(atlas, sub)
        want = oracle.forward(raw, ax[:, None], co[:, None], sa[:, None],
                              vec).argmax(1)
        got = labels[sub[:, 0], sub[:, 1], sub[:, 2]]
        oracle_agreement = float((got == want).mean())

    rec = {
        "metric": "per_scan_segmentation_wallclock",
        "value": round(per_scan, 4),
        "fcn_vs_patch_agreement": round(agreement, 6),
        "oracle_agreement": (round(oracle_agreement, 6)
                             if oracle_agreement is not None else None),
        "unit": "seconds",
        "vs_baseline": round(TARGET_SECONDS / per_scan, 3),
        "median_seconds": round(per_scan_med, 4),
        "n_repeats": repeats,
        "voxels_per_sec_per_chip": int(n_vox / per_scan),
        # device_seconds times the headline's slab call on staged inputs;
        # host_wire_seconds is the rest of the headline number (uploads,
        # host prep, readback, post-process)
        "device_seconds": round(device_f32, 4),
        "bf16_device_seconds": round(device_bf16, 4),
        "host_wire_seconds": round(per_scan - device_f32, 4),
        "est_flops_per_scan": int(flops),
        "est_mfu_bf16": (round(flops / device_bf16 / peak, 4)
                         if peak else None),
        "est_mfu_f32_vs_bf16_peak": (round(flops / device_f32 / peak, 4)
                                     if peak else None),
        "peak_flops_assumed": peak,
        "with_prob_maps_seconds": round(with_probs, 4),
        "with_prob_maps_median": round(with_probs_med, 4),
        "bf16_fast_seconds": round(fast_per_scan, 4),
        "bf16_fast_median": round(fast_med, 4),
        "bf16_fast_agreement": round(
            float((labels[sel] == labels_fast[sel]).mean()), 6),
        "candidate_voxels": int(n_vox),
        "volume_shape": list(image.shape),
        "includes_post_process": True,
        "device": device_name(device),
        "checkpoint": ("random-init" if checkpoint is None
                       else Path(checkpoint).stem),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m subcort_tpu_torch.bench.scan")
    ap.add_argument("--mode", default="tpu",
                    help="Options.mode: the card by default (tpu, cuda0, "
                         "...); cpu runs on the CPU")
    args = ap.parse_args(argv)
    device = select_device(Options(mode=args.mode))  # no card: raise here
    repeats = max(1, int(os.environ.get("SUBCORT_BENCH_REPEATS", "9")))
    oracle_n = int(os.environ.get("SUBCORT_BENCH_ORACLE_N", "256"))

    rng = np.random.default_rng(0)
    image, atlas, roi = make_scan(rng)
    if os.path.exists(REF_CKPT):
        params, checkpoint = load_theano_checkpoint(REF_CKPT), REF_CKPT
    else:  # seeded weights, so the benchmark runs standalone
        params = init_params(DEFAULT_SPEC, torch.Generator().manual_seed(0))
        checkpoint = None
    net = TriPlanarNet.from_params(params, DEFAULT_SPEC, device)
    return run(net, image, atlas, roi, rng, device=device, repeats=repeats,
               oracle_n=oracle_n, checkpoint=checkpoint)


if __name__ == "__main__":
    main()
