#!/usr/bin/env python3
"""Smoke run of the PyTorch port (subcort_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (PATH or $CUDA_HOME, default /usr/local/cuda)
and this checkout; imports no jax. Phases, in order; any failure raises
and the exit code is non-zero:

1. device facts: nvidia-smi name and power limit, torch's device name,
   the global TF32 flags (segment_volume turns TF32 off for its own work:
   the exact path is full float32);
2. build the gather kernel from ops/csrc/gather_triplanar.cu;
3. kernel vs plain PyTorch version on the card, bit-equal (torch.equal),
   on prepare_gather_volume layouts: single volume (MNI 181x217x181,
   padded) at 8,192 random centers plus the 8 corners, and a 3-subject
   stack. Times at N=8,192 (CUDA events) of the kernel, its plain version
   and a library yardstick (one torch.take over the precomputed window
   indices, which the port never calls) in three uses: random centers in
   one volume, the scan's first 8,192 candidates in raster order in situ
   on its normalized volume, and random centers in the 3-subject stack;
   each beside its bound (gather_roofline_bytes over 3.35 TB/s); and the
   time of prepare_gather_volume on the MNI volume;
4. the patch path: a synthetic MNI-sized subject written as NIfTI,
   segmented by SegmentationEngine.segment_folder with use_fcn=False at the
   model's full width (random weights from a seeded generator); checks the
   output file and that the gather kernel launched at least once per
   chunk; seconds of the second (warm) run;
5. card vs CPU: 2,048 candidates through the plain CPU path, label
   agreement >= 0.999;
6. the dense path (the default use_fcn=True, uint16 priors): the same
   subject through segment_folder; checks the output file, that no gather
   kernel launched and that fcn_forward_slab ran; warm seconds; then
   warm segment_folder seconds of both engines in bfloat16;
7. dense vs patch on all candidates (float32 priors and probs): label
   agreement >= 0.9999; the default uint8 prob map within a step;
8. dense card vs CPU on the candidates of one 24^3 sub-box: label
   agreement >= 0.999;
9. device time of fcn_forward_slab on the pre-staged MNI slab and of the
   patch engine's forward_centers (CUDA events), with TFLOP/s;
10. bfloat16 vs float32 on all candidates, both engines, with the
   segment_volume seconds of all four: label agreement at least the JAX
   package's own on the same scan and weights, less 0.002;
11. one JSON line of kernel facts, then the last line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N_TIMED = 8192
SHAPE = (181, 217, 181)
SUBJECTS = 3
# H100 SXM memory rate, bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
CARD_VS_CPU = 2048
MIN_AGREEMENT = 0.999
MIN_DENSE_VS_PATCH = 0.9999
SUB_BOX = 24
# bfloat16 vs float32 label agreement of the JAX package itself on this
# scan with these weights (the same seeded init bridged to JAX, every
# candidate, on the CPU). A random-weight net is undecided: its median
# top-2 probability margin is 0.0015, so bfloat16 rounding flips labels in
# both packages alike, and more in the patch engine, which argmaxes
# bfloat16 probabilities. The port may flip no more than the reference
# does, less BF16_SLACK; 0.999 is the bound for a trained net.
BF16_REFERENCE = {"fcn": 0.995660533358121, "patch": 0.9666345405889346}
BF16_SLACK = 0.002


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def make_scan(rng):
    """MNI-dimension synthetic int16 T1, 15-channel prior atlas and
    subcortical ROI (the same construction as bench.py::make_scan)."""
    image = np.zeros(SHAPE, np.int16)
    x, y, z = np.ogrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    brain = (((x - 90) / 80.0) ** 2 + ((y - 108) / 95.0) ** 2
             + ((z - 90) / 78.0) ** 2) < 1.0
    image[brain] = (rng.random(int(brain.sum())) * 800 + 100).astype(np.int16)
    atlas = np.zeros(SHAPE + (15,), np.float32)
    atlas[..., 14] = 1.0
    roi = (((x - 90) / 28.0) ** 2 + ((y - 108) / 32.0) ** 2
           + ((z - 90) / 26.0) ** 2) < 1.0
    pri = rng.random((int(roi.sum()), 15)).astype(np.float32)
    pri /= pri.sum(1, keepdims=True)
    atlas[roi] = pri
    return image, atlas, roi


def time_ms(torch, fn, iters: int = 50) -> float:
    """Mean device milliseconds per call, CUDA events, after a warm-up."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this "
                         "script runs only on an NVIDIA card")

    from subcort_tpu_torch import (NiftiImage, Options, SegmentationEngine,
                                   load_nii, save_nii, segment_volume,
                                   select_device)
    from subcort_tpu_torch.config import exact_float32
    from subcort_tpu_torch.engine.forward import forward_centers
    from subcort_tpu_torch.engine.infer import (DEFAULT_CHUNK,
                                                _atlas_vectors_host, _bbox_of,
                                                _fcn_slab_inputs,
                                                _normalized_padded,
                                                candidate_centers,
                                                net_in_dtype)
    from subcort_tpu_torch.models import (TriPlanarNet, TriPlanarSpec, fcn,
                                          init_params, slab_flops)
    from subcort_tpu_torch.ops.normalize import normalize_stats
    from subcort_tpu_torch.ops import gather_kernel
    from subcort_tpu_torch.ops.gather_kernel import (gather_roofline_bytes,
                                                     gather_triplanar_cuda,
                                                     prepare_gather_volume,
                                                     window_index)
    from subcort_tpu_torch.ops.patches import (gather_triplanar,
                                               gather_triplanar_subjects,
                                               pad_volume)
    from subcort_tpu_torch.utils.build import build_library

    # 1. device facts
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    device = select_device(Options(mode="cuda0"))
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    lib = build_library("gather_triplanar", [gather_kernel.SOURCE],
                        verbose=True)
    print(f"build: {lib.name} in {time.perf_counter() - t0:.3f} s")

    # 3. kernel vs plain on the card
    gen = torch.Generator(device=device).manual_seed(0)
    padded = pad_volume(torch.randn(SHAPE, generator=gen, device=device))
    rand = torch.stack([torch.randint(0, s, (N_TIMED,), generator=gen,
                                      device=device) for s in SHAPE], 1)
    rand = rand.to(torch.int32).contiguous()
    corners = torch.tensor([[x, y, z] for x in (0, SHAPE[0] - 1)
                            for y in (0, SHAPE[1] - 1)
                            for z in (0, SHAPE[2] - 1)],
                           dtype=torch.int32, device=device)
    centers = torch.cat([rand, corners]).contiguous()
    stack = torch.randn((SUBJECTS,) + tuple(padded.shape), generator=gen,
                        device=device)
    subj = torch.cat([torch.randint(0, SUBJECTS, (N_TIMED, 1), generator=gen,
                                    device=device, dtype=torch.int32),
                      rand], 1).contiguous()
    vol, stack_vol = prepare_gather_volume(padded), prepare_gather_volume(stack)
    max_err = 0.0
    for mode, got, want in (
            ("single", gather_triplanar_cuda(vol, centers),
             gather_triplanar(padded, centers)),
            ("subjects", gather_triplanar_cuda(stack_vol, subj),
             gather_triplanar_subjects(stack, subj))):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(g.shape == w.shape and torch.equal(g, w),
                  f"kernel == plain ({mode} mode)")
            max_err = max(max_err, float((g - w).abs().max()))
        print(f"kernel == plain, {mode} mode: {got[0].shape[0]} centers, "
              "bit-equal")

    image, atlas, roi = make_scan(np.random.default_rng(0))
    insitu = torch.from_numpy(candidate_centers(
        image, Options(), roi.astype(np.uint8))[:N_TIMED]).to(device)
    scan = _normalized_padded(image, device)
    scan_vol = prepare_gather_volume(scan)
    for g, w in zip(gather_triplanar_cuda(scan_vol, insitu),
                    gather_triplanar(scan, insitu)):
        check(torch.equal(g, w), "kernel == plain (in situ)")
        max_err = max(max_err, float((g - w).abs().max()))
    print(f"kernel == plain, in situ: {len(insitu)} candidates, bit-equal")

    def timed_use(name, plain_in, prepared, c, plain_fn):
        """Kernel, plain and library ms (interleaved plain, kernel,
        kernel, plain; the library call last) and the bound."""
        idx = window_index(c, plain_in.shape)
        plain_a = time_ms(torch, lambda: plain_fn(plain_in, c))
        kernel_a = time_ms(torch, lambda: gather_triplanar_cuda(prepared, c))
        kernel_b = time_ms(torch, lambda: gather_triplanar_cuda(prepared, c))
        plain_b = time_ms(torch, lambda: plain_fn(plain_in, c))
        library = time_ms(torch, lambda: torch.take(plain_in, idx))
        nbytes = gather_roofline_bytes(c, plain_in.shape)
        use = {"ms": (kernel_a + kernel_b) / 2,
               "plain_ms": (plain_a + plain_b) / 2, "library_ms": library,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
        print(f"gather {name} at N={len(c)}: kernel {use['ms']:.4f} ms "
              f"({kernel_a:.4f}, {kernel_b:.4f}), plain "
              f"{use['plain_ms']:.4f} ms ({plain_a:.4f}, {plain_b:.4f}), "
              f"torch.take {library:.4f} ms; bound {use['bound_ms']:.4f} ms "
              f"({nbytes} bytes), {use['bound_ms'] / use['ms']:.1%} of it")
        return use

    uses = {
        "random": timed_use("random", padded, vol, rand, gather_triplanar),
        "insitu": timed_use("in situ", scan, scan_vol, insitu,
                            gather_triplanar),
        "subjects": timed_use(f"random, {SUBJECTS}-subject stack", stack,
                              stack_vol, subj, gather_triplanar_subjects),
    }
    prepare_ms = time_ms(torch, lambda: prepare_gather_volume(padded),
                         iters=20)
    print(f"prepare_gather_volume: {tuple(padded.shape)} -> xyz "
          f"{tuple(vol.xyz.shape)}, zxy {tuple(vol.zxy.shape)}, "
          f"{prepare_ms:.4f} ms")
    del padded, rand, centers, subj, stack, vol, stack_vol, scan, scan_vol

    # 4. the patch path, at the model's full width
    spec = TriPlanarSpec()
    params = init_params(spec, torch.Generator().manual_seed(0))
    folder = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        sub = Path(folder) / "mni01"
        (sub / "tmp").mkdir(parents=True)
        save_nii(NiftiImage(image), str(sub / "T1.nii.gz"))
        save_nii(NiftiImage(atlas),
                 str(sub / "tmp" / "MNI_sub_probabilities.nii.gz"))
        save_nii(NiftiImage(roi.astype(np.uint8)),
                 str(sub / "tmp" / "MNI_subcortical_mask.nii.gz"))
        t1 = load_nii(str(sub / "T1.nii.gz"))
        seg_path = str(sub / "out_subcortical_seg_prec.nii.gz")

        def sweep(**kw):
            """A warm-up and a timed segment_folder run over the subject;
            the launch and slab counts start at 0 just before the timed
            run. Returns (engine, seconds, gather launches, slabs)."""
            options = Options(test_folder=folder, mode="cuda0",
                              post_process=True, crop=True, debug=False,
                              net_verbose=0, **kw)
            engine = SegmentationEngine(params, options, spec)
            engine.segment_folder()  # warm-up
            gather_kernel.LAUNCHES = 0
            fcn.SLABS = 0
            t0 = time.perf_counter()
            engine.segment_folder()
            seconds = time.perf_counter() - t0
            return engine, seconds, gather_kernel.LAUNCHES, fcn.SLABS

        def check_output(what: str) -> int:
            out = load_nii(seg_path)
            check(out.data.shape == image.shape,
                  f"{what}: output shape == input shape")
            check(np.array_equal(out.affine, t1.affine),
                  f"{what}: output affine == input")
            labelled = int((out.data != 0).sum())
            check(labelled > 0, f"{what}: non-zero labels in the output")
            return labelled

        engine, seconds, launches, _ = sweep(use_fcn=False)
        labelled = check_output("patch path")
        cands = candidate_centers(image, engine.options,
                                  roi.astype(np.uint8))
        n_chunks = math.ceil(len(cands) / DEFAULT_CHUNK)
        check(launches >= n_chunks,
              f"gather kernel launches {launches} >= chunks {n_chunks}")
        print(f"main path: {len(cands)} candidates, {n_chunks} chunks, "
              f"{launches} kernel launches, segment_folder {seconds:.4f} s "
              f"(warm), {len(cands) / seconds:.1f} candidates/s, "
              f"{labelled} labelled voxels")
        # the device part alone: upload, normalize, gather + CNN, readback
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels, _ = segment_volume(engine.net, image, atlas, cands,
                                   engine="patch")
        seg_seconds = time.perf_counter() - t0
        print(f"segment_volume alone: {seg_seconds:.4f} s, "
              f"{len(cands) / seg_seconds:.1f} candidates/s")

        # 5. card vs CPU on a sample of the candidates
        pick = np.sort(np.random.default_rng(1).choice(
            len(cands), CARD_VS_CPU, replace=False))
        sample = cands[pick]
        idx = tuple(sample.T)
        card_l, card_p = segment_volume(engine.net, image, atlas, sample,
                                        want_probs=True, engine="patch",
                                        probs_dtype=np.float32)
        cpu_net = TriPlanarNet.from_params(params, spec, "cpu")
        cpu_l, cpu_p = segment_volume(cpu_net, image, atlas, sample,
                                      want_probs=True, engine="patch",
                                      probs_dtype=np.float32)
        check(np.array_equal(card_l[idx], labels[idx]),
              "sampled labels == full-scan labels on the card")
        check(bool(np.isfinite(card_p[idx]).all()), "finite probabilities")
        check(bool(np.allclose(card_p[idx].sum(1), 1.0, atol=1e-4)),
              "probability rows sum to 1")
        agreement = float(np.mean(card_l[idx] == cpu_l[idx]))
        prob_err = float(np.abs(card_p[idx] - cpu_p[idx]).max())
        print(f"card vs CPU: {CARD_VS_CPU} candidates, label agreement "
              f"{agreement}, max |prob difference| {prob_err:.3e}")
        check(agreement >= MIN_AGREEMENT,
              f"card vs CPU label agreement {agreement} >= {MIN_AGREEMENT}")

        # 6. the dense path: the default use_fcn=True, uint16 priors
        dense, seconds, dense_launches, slabs = sweep(use_fcn=True)
        labelled = check_output("dense path")
        check(dense_launches == 0,
              f"dense path: gather kernel launches {dense_launches} == 0")
        check(slabs >= 1, f"dense path: fcn_forward_slab calls {slabs} >= 1")
        print(f"dense path: {len(cands)} candidates, {slabs} slab(s), "
              f"{dense_launches} gather launches, segment_folder "
              f"{seconds:.4f} s (warm), {len(cands) / seconds:.1f} "
              f"candidates/s, {labelled} labelled voxels")
        for use_fcn in (True, False):
            _, seconds, _, _ = sweep(use_fcn=use_fcn,
                                     compute_dtype="bfloat16")
            check_output(f"bfloat16 {'dense' if use_fcn else 'patch'}")
            print(f"bfloat16 {'dense' if use_fcn else 'patch'} path: "
                  f"segment_folder {seconds:.4f} s (warm), "
                  f"{len(cands) / seconds:.1f} candidates/s")
    finally:
        shutil.rmtree(folder)
    sel = tuple(cands.T)
    net = dense.net

    # 7. dense vs patch on every candidate
    f32 = dict(want_probs=True, prior_dtype=np.float32,
               probs_dtype=np.float32)
    dl, dp = segment_volume(net, image, atlas, cands, engine="fcn", **f32)
    pl, pp = segment_volume(net, image, atlas, cands, engine="patch", **f32)
    agreement = float(np.mean(dl[sel] == pl[sel]))
    print(f"dense vs patch: {len(cands)} candidates, label agreement "
          f"{agreement}, {int((dl[sel] != pl[sel]).sum())} mismatches, "
          f"max |prob difference| {np.abs(dp[sel] - pp[sel]).max():.3e}")
    check(agreement >= MIN_DENSE_VS_PATCH,
          f"dense vs patch label agreement {agreement} >= "
          f"{MIN_DENSE_VS_PATCH}")
    ql, qp = segment_volume(net, image, atlas, cands, engine="fcn",
                            want_probs=True)
    q_agree = float(np.mean(ql[sel] == dl[sel]))
    q_err = float(np.abs(qp[sel] - dp[sel]).max())
    print(f"dense, uint16 priors + uint8 probs vs float32: label agreement "
          f"{q_agree}, max |prob difference| {q_err:.3e}")
    check(q_err <= 1.0 / 255 + 1e-4, f"uint8 prob map within a step "
          f"({q_err:.3e})")
    check(q_agree >= MIN_AGREEMENT, f"uint16 prior label agreement "
          f"{q_agree} >= {MIN_AGREEMENT}")
    del dp, pp, qp

    # 8. dense card vs CPU on one sub-box of the candidates' bbox
    lo, dims = _bbox_of(cands, image.shape)
    box_lo = lo + np.array([dims[0] // 2 - SUB_BOX // 2,
                            dims[1] // 2 - SUB_BOX // 2, 0])
    inside = np.all((cands >= box_lo) & (cands < box_lo + SUB_BOX), axis=1)
    box = cands[inside]
    bsel = tuple(box.T)
    check(len(box) > 0, "candidates in the sub-box")
    card_l, card_p = segment_volume(net, image, atlas, box, engine="fcn",
                                    **f32)
    cpu_l, cpu_p = segment_volume(cpu_net, image, atlas, box, engine="fcn",
                                  **f32)
    agreement = float(np.mean(card_l[bsel] == cpu_l[bsel]))
    print(f"dense card vs CPU: {len(box)} candidates in a {SUB_BOX}^3 "
          f"sub-box at {box_lo.tolist()}, label agreement {agreement}, "
          f"max |prob difference| "
          f"{np.abs(card_p[bsel] - cpu_p[bsel]).max():.3e}")
    check(agreement >= MIN_AGREEMENT,
          f"dense card vs CPU label agreement {agreement} >= "
          f"{MIN_AGREEMENT}")

    # 9. device time on pre-staged inputs (CUDA events)
    slab, vecs, cs, lin, norm = _fcn_slab_inputs(
        image, normalize_stats(image), atlas, lo, dims, image.shape,
        np.uint16, cands)
    staged = (torch.from_numpy(slab).to(device),
              torch.from_numpy(vecs).to(device))
    staged_norm = (torch.from_numpy(norm[0]).to(device),) + norm[1:]
    staged_idx = torch.from_numpy(lin).to(device)
    flops = slab_flops(dims, len(cs))
    for name in ("float32", "bfloat16"):
        timed_net = net_in_dtype(net, name)
        with exact_float32():
            ms = time_ms(torch, lambda: fcn.fcn_forward_slab(
                timed_net, *staged, gather_idx=staged_idx, norm=staged_norm),
                iters=10)
        print(f"fcn_forward_slab {name}: bbox {dims}, {len(cs)} rows, "
              f"{ms:.3f} ms, {flops / 1e12:.4f} TFLOP, "
              f"{flops / ms / 1e9:.2f} TFLOP/s")
    volume = prepare_gather_volume(_normalized_padded(image, device))
    c_d = torch.from_numpy(cands).to(device)
    v_d = torch.from_numpy(_atlas_vectors_host(atlas, cands)).to(device)
    with exact_float32():
        ms = time_ms(torch, lambda: forward_centers(
            net, volume, c_d, v_d, DEFAULT_CHUNK, False), iters=3)
    print(f"forward_centers float32: {len(cands)} centers, {ms:.3f} ms")
    del staged, staged_idx, volume, c_d, v_d

    # 10. bfloat16 vs float32 on every candidate, both engines
    for eng in ("fcn", "patch"):
        out = {}
        for dt in ("float32", "bfloat16", "float32", "bfloat16"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[dt] = segment_volume(net, image, atlas, cands, engine=eng,
                                     compute_dtype=dt)[0]
            out[dt + "_s"] = time.perf_counter() - t0
        agreement = float(np.mean(out["float32"][sel] == out["bfloat16"][sel]))
        floor = BF16_REFERENCE[eng] - BF16_SLACK
        print(f"bfloat16 vs float32, {eng}: label agreement {agreement} "
              f"(JAX package {BF16_REFERENCE[eng]}), segment_volume "
              f"{out['float32_s']:.4f} s float32, {out['bfloat16_s']:.4f} s "
              f"bfloat16 (warm)")
        check(agreement >= floor, f"bfloat16 vs float32 label agreement, "
              f"{eng}: {agreement} >= {floor}")

    # 11. results
    print(json.dumps({"kernels": [{
        "name": "gather_triplanar",
        "route": "cuda",
        "source": "subcort_tpu_torch/ops/csrc/gather_triplanar.cu",
        "replaces": "subcort_tpu/ops/pallas_gather.py:176",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": uses["random"]["ms"],
        "plain_ms": uses["random"]["plain_ms"],
        "bound_ms": uses["random"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": uses["random"]["library_ms"],
        "insitu_ms": uses["insitu"]["ms"],
        "subjects_ms": uses["subjects"]["ms"],
        "prepare_ms": prepare_ms,
        "uses": uses,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
