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
9. device time of fcn_forward_slab on the pre-staged MNI slab (CUDA
   events), with TFLOP/s; the patch engine's forward_centers over every
   candidate: device ms by CUDA events beside the host's enqueue ms and
   its wall ms (ended by a synchronize), and by torch.profiler the kernels
   per chunk and the device's busy share;
10. bfloat16 vs float32 on all candidates, both engines, with the
   segment_volume seconds of all four: label agreement at least the JAX
   package's own on the same scan and weights, less 0.002;
11. training, at the model's full width, float32, TF32 off:
   (a) three MNI-sized synthetic subjects (make_scan's T1, each with its
       own seed, 14 structures cut from the ROI ellipsoid plus a class-15
       ring, informative priors) written as NIfTI and read back by
       build_training_index; the shuffled index capped at 32,768 samples,
       the whole 3-subject stack kept (136 MB, beyond the 50 MB L2);
       Trainer.fit at batch 128 for 2 epochs, every step after two
       warm-up steps a replay of one captured CUDA graph. Checks: gather
       kernel launches == train steps + eval batches (one per replay),
       two warm-up steps and the rest replayed, finite losses, epoch 2's
       train loss below epoch 1's, the best-only checkpoint reloads bit-
       equal to the trainer's params, and the trained params segment the
       phase-4 subject through segment_folder (the dense default) with
       non-zero labels. Prints epoch seconds and samples/s, the capture's
       ms and the bytes the caching allocator holds after the fit;
   (b) CUDA-event ms over 50 steps on a pre-staged batch of 128, each
       beside the host's ms to enqueue it, beside the card's name and
       power limit: the train step eager in float32 and bfloat16, the
       float32 step with the plain gather, the gather kernel alone on the
       stack beside its bound, its plain version and torch.take; the
       float32 step's parts (forward, forward + backward, Adam, BN EMA);
       the gather's share of the step; torch.profiler over 20 eager
       float32 steps: device ms by part, kernels per step, the device's
       busy share; then the same steps graphed (make_train_multistep: one
       call of 50 replays after a call that captured), float32 and
       bfloat16, and torch.profiler over a call of 20 replays, with the
       gather kernel's device us per launch inside them;
   (c) one step (dropout 0, no augmentation) from the same seeded params
       and batch on the card and on the CPU: in float32, relative loss
       difference and BN EMA within 1e-5; in bfloat16, the relative loss
       difference within 1e-3 and the mean |BN EMA difference| within a
       quarter of the CPU's own bfloat16 vs float32 one;
   (d) quality: tests/test_trainqual.py's phantom (3 subjects 48x54x44,
       noise 4, exact priors, seed 1), 6 epochs at batch 128 on an index
       capped at 4,096, with cuDNN's deterministic algorithms: best
       valid_accuracy >= 0.90 and held-out Dice >= 0.85 through
       segment_volume;
   (e) a 1-epoch fit graphed and one with every step eager (fit's
       _eager) from the same seed on (a)'s index, under cuDNN's
       deterministic algorithms: histories (dur aside) and parameters
       equal bit for bit. Prints, without a gate, bfloat16 vs float32
       label agreement of the trained MNI weights on the phase-4 scan;
12. registration with backend="torch" on the card, float32, TF32 off:
   (a) the resampler card vs CPU: the 15-channel MNI-sized prior volume
       (427 MB) through resample_through_cpp (a seeded smooth control grid
       at 10 mm) and resample_through_affine, max |difference| <= 1e-4 of
       the value range; CUDA-event ms of each device program and GB/s
       against the bytes read and written;
   (b) quality on bench_reg.py's phantoms (64x72x60; bench/reg.py's
       make_phantom, make_affine_phantom and structure_dice): FFD SSD on
       the same-intensity subject, FFD NMI on the remapped one
       (spacing_mm=6, iters=(60, 10)), the 12-dof affine on
       the affine phantom: structure Dice >= 0.93 and, for the FFDs, min
       det(J)/det(A) > 0.05, the identity Dice beside them; the SSD fit
       again on the card (are two runs bit-equal?) and on the CPU (Dice
       within 0.01, final loss within 2%); torch.profiler over a short fit:
       no index_put kernel (the floating image takes no gradient);
   (c) full width through the entry points: an MNI-sized template and
       15-channel atlas in a temporary atlas directory (the phase-4
       subject and priors under a known 12-dof misalignment plus a smooth
       warp of a few voxels, the template's intensities remapped), and a
       copy of the phase-4 subject with NO tmp/ directory through
       SegmentationEngine.segment_folder with reg_backend = torch,
       reg_similarity = nmi and no register_fn, at the default iterations.
       Checks: the six tmp/ files and their shapes, transform.nii reloads,
       min det(J)/det(A) > 0, the warped template's NMI against the
       subject rose, the warped priors' ROI Dice against the phase-4 ROI
       >= REG_MNI_DICE (the identity Dice beside it), a segmentation with
       non-zero labels, a second register_masks call under 1 s, every
       level replayed one captured iteration (its register.level span).
       Then the same subject again through register_masks with every
       level a plain loop (``_eager=True``): both calls' transform.nii
       controls and transf.txt equal. Prints both calls' seconds per
       stage and peak device memory per stage (from the register.* spans),
       and each level's ms per optimiser iteration (CUDA events
       beside the host's enqueue ms; the warm-up's apart), capture ms and
       wall ms; then one iteration of the quarter-resolution affine level
       and of both FFD levels under torch.profiler;
   (d) the priors-miss path of training: build_training_index on one
       phantom subject without tmp/, reg_backend = torch;
14. the command line on the card, ``subcort_tpu_torch.cli.main`` called in
   this process (so the gather launch count is read; set to 0 before each
   command), once as ``python -m subcort_tpu_torch.cli`` in a process of
   its own:
   (a) tests/test_trainqual.py's phantom (3 subjects 48x54x44, seed 1) and
       a configuration.cfg with mode = cuda0, batch 128, 2 epochs, the
       model's full width: ``run`` (the checkpoint, three segmentations,
       gather launches >= train steps + eval batches), ``evaluate`` (three
       subject lines and the cohort line; prints the cohort Dice), ``loo
       --folds s00,s01`` (two fold lines and the summary), ``infer`` with
       use_fcn = False (launches >= chunks), and ``infer --profile DIR``
       under ``python -X importtime -m`` (rc 0, a trace with CUDA kernel
       events, no jax module imported);
   (b) three MNI-sized scans (make_scan with seeds 1, 0, 2; the second is
       the phase-4 subject), priors in tmp/, phase 4's seeded weights
       through a checkpoint: ``infer`` serial, pipelined, serial, pipelined
       (folder_pipeline), every output array-equal to the first run's; wall
       seconds of each, os.cpu_count(), the card's name and power limit;
       then the second scan's tmp/ removed before a pipelined run, where
       the loader thread registers it (reg_backend = torch, phase 12(c)'s
       template and atlas) while the first segments, and again before a
       serial run: in both the first and third scans equal the serial
       run's and both TF32 flags are as before; seconds of both, and
       whether the second scan's labels agree between them;
   (c) post_process_segmentation of the phase-7 labels with
       cc_backend = "device" and "scipy": array-equal, no fallback warning;
       seconds of both;
   (d) one float32 train step at patch 40 (dropout 0) on the phase-11
       stack, every subject's 8 corner centers in the batch of 128: finite,
       no gather launch, loss and BN EMA card vs CPU within 1e-5;
15. the multi-device paths on the one card (no scaling can show here):
   (a) the phase-4 scan through segment_volume over [cuda:0, cuda:0],
       one host thread per entry: the patch engine (labels equal to one
       device's on every candidate; gather launches, counted from 0 just
       before, equal to the two parts' chunks), the dense engine with
       fcn_spmd True and False (labels equal; no gather launch, a slab per
       entry at least); warm seconds of each beside one device's;
   (b) one step (TriPlanarSpec() with its dropout, augmentation on) from
       seeded params on 2 x 128 rows of phase 11's index, under cuDNN's
       deterministic algorithms: two gloo ranks on the card
       (parallel/distributed.py::launch) against one process at 256 rows:
       in float32, loss and BN EMA within 1e-5 (the shares of gradient
       elements within 1e-4 of their tensor's largest and of parameters
       within 1e-5 printed: a max-pool argmax or PReLU sign near a tie,
       and Adam's first step on a near-zero gradient, move a few float32
       values by more, as far as the one-process float32 step is from
       float64); in float64, the same and every gradient within 1e-9 of
       its tensor's largest and every parameter after Adam within 1e-5;
       the ranks' parameters equal.
       Step ms by CUDA events (cuDNN's default algorithms) of both, and
       of one NCCL rank. Then Trainer.fit over two
       ranks on the index capped at 6,912 for 2 epochs: finite falling
       loss, gather launches per rank = its steps + eval batches, files
       from rank 0 only;
   (c) one NCCL rank (world 1): its step equals the plain step bit for
       bit, both under cuDNN's deterministic algorithms; in the same rank,
       Trainer.fit through parallel/distributed.py::train_rank (as a fit
       over several cards runs each rank) on the index capped at 6,912
       for 2 epochs at batch 128, graphed (the rank's captured step
       replayed, the synced BN's and the gradients' all-reduces inside
       the graph) and once with _eager=True, both under cuDNN's
       deterministic algorithms: histories, parameters, BN EMA, Adam
       state and the step generator bit-equal; gather launches = steps +
       eval batches in both; 2 warm-up steps and the rest replayed, the
       capture's ms; then, with cuDNN's default algorithms, the rank's
       multistep on the step's 256 rows, 20 steps a call, graphed and
       eager, and one process's graphed: ms per step by CUDA events beside
       the host's enqueue ms. The two gloo ranks of (b)'s fit report eager
       steps. Then one NCCL rank whose step reads a value back: its two
       eager warm-up steps run, the capture raises, and the launch fails
       (RuntimeError naming rank 0) within 75 s, with no fit finished;
   (d) Trainer(data_parallel = 2) raises ValueError with one card, and
       _data_parallel_devices clamps to [cuda:0] with its note;
   (e) every launch of the phase (the 2-rank gloo step, the NCCL rank, the
       failing capture and (b)'s fit) went through the launcher's own
       store: each launch's rendezvous port and its seconds from launch to
       its return (or raise), beside the card's name and power limit;
16. the quality and training benchmarks of subcort_tpu_torch/bench/, each
   through its main() or run() on the card, each with the gather launch
   count set to 0 just before it and read just after (launches >= the
   train steps + eval batches of its fits), each JSON line holding the
   original's keys (BENCH_KEYS):
   (a) bench/reg.py at its defaults: every row passes its floors (Dice
       >= 0.93, min_jac > 0.05); without tools/ the native rows print the
       original's "skipped" line;
   (b) bench/train.py --samples 4096 --epochs 2 (the MNI-sized 4-subject
       stack);
   (c) bench/trainqual.py with 2 + 1 subjects of 48x54x44, 6 epochs,
       seed 1, the floors of tests/test_trainqual.py (Dice >= 0.85,
       valid_accuracy >= 0.90), under cuDNN's deterministic algorithms;
   (d) bench/robust.py at tests/test_robustqual.py's recipe (2 subjects
       of 48x54x44, 6 epochs, seed 1; bias_field >= 0.82, combined >=
       0.65), registering on the card, the same algorithms;
17. the headline benchmark, subcort_tpu_torch/bench/scan.py (the port of
   bench.py), through its run() on the phase-4 scan and the generator that
   built it, at the model's full width: phase 4's seeded weights written
   as a reference-format pickle (save_theano_checkpoint) and read back for
   the net, 3 interleaved repeats, the oracle canary on 32 voxels from
   that pickle; the gather launch count set to 0 just before it. Checks:
   one JSON line with the original's keys (BENCH_KEYS["scan"]),
   fcn_vs_patch_agreement >= 0.9999, oracle_agreement >= 31/32,
   bf16_fast_agreement at least the JAX package's own on the same scan
   and weights (BF16_FAST_REFERENCE) less 0.002, gather launches equal to
   the patch engine's chunks (25), the candidate count and FLOP count of
   the MNI scan, peak_flops_assumed from bench/scan.py's table
   (989.4e12 on the H100 SXM);
13. printed last: one JSON line of kernel facts (with dp_* keys: the
   two-device patch launches, launches per rank, the backends; bench_*
   keys: each benchmark's launches, steps + eval batches and seconds;
   bench_scan_* keys: phase 17's launches, chunks, seconds and line), then
   the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pickle
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
# training (phase 11)
TRAIN_CAP = 32768
TRAIN_BATCH = 128
TRAIN_EPOCHS = 2
STEP_ITERS = 50
CARD_VS_CPU_STEP = 1e-5
# a bfloat16 step card vs CPU (the CPU's is held to the JAX package's in
# tests/test_torch_train.py): the mean |BN EMA difference| within this
# share of the CPU's own bfloat16 vs float32 one, so a card step that ran
# in float32 fails; the loss within a quarter of bfloat16's 2^-8 step
BF16_STEP_SHARE = 0.25
BF16_STEP_LOSS = 1e-3
PROFILE_STEPS = 20
# device kernels by the part of the train step they belong to, first
# match wins
KERNEL_PARTS = (
    ("gather kernel", ("gather_triplanar",)),
    ("BN (native batch_norm fwd + bwd)", ("batch_norm",)),
    ("PReLU fwd + bwd", ("prelu",)),
    ("max-pool fwd + bwd", ("max_pool",)),
    ("convolutions (cuDNN: implicit GEMM, FFT, wgrad)",
     ("fprop", "dgrad", "wgrad", "fft2d", "flip_filter", "convolve",
      "cf32", "cudnn")),
    ("dense layers (cuBLAS GEMMs)", ("gemm", "gemv")),
    ("Adam + BN EMA (foreach)", ("multi_tensor",)),
    ("reductions (bias and alpha grads, loss)", ("reduce_kernel",)),
    ("dropout masks", ("bernoulli", "distribution")),
)
QUALITY_VALID_ACC, QUALITY_DICE = 0.90, 0.85
# the multi-device paths (phase 15): one global step of 2 x DP_BATCH rows
# against one process; the short fit's index and epochs; timed steps
DP_BATCH = 128
DP_STEP_TOL = 1e-5
DP_GRAD_TOL = 1e-4
DP_F64_TOL = 1e-9
DP_FIT_CAP = 6912
DP_FIT_EPOCHS = 2
DP_TIMED_STEPS = 20
# registration (phase 12); the floors of (b) are bench_reg.py's
REG_RESAMPLE_TOL = 1e-4
REG_DICE_FLOOR, REG_MIN_JAC_FLOOR = 0.93, 0.05
REG_CARD_VS_CPU_DICE, REG_CARD_VS_CPU_LOSS = 0.01, 0.02
REG_MNI_DICE = 0.995
# device kernels of one optimiser iteration by kind, first match wins
REG_KERNEL_PARTS = (
    ("gathers (trilinear corners)", ("index", "gather")),
    ("matmuls (cuBLAS: B-spline contractions, histogram)",
     ("gemm", "gemv", "cutlass", "cublas")),
    ("reductions", ("reduce",)),
    ("copies and concatenations", ("copy", "cat", "Memcpy", "Memset",
                                   "fill")),
)
# the benchmarks (phase 16): the keys of the originals' JSON lines, copied
# here because bench_*.py at the repo root import jax, which the card's
# machine lacks (tests/test_torch_bench.py holds the port's benchmarks to
# the originals' sources on the CPU); the smoke runs' sizes and floors are
# tests/test_trainqual.py's and tests/test_robustqual.py's
BENCH_KEYS = {
    "reg_ffd": ["backend", "cost", "dice_floor", "first_call_seconds",
                "identity_dice", "metric", "min_jac", "min_jac_floor",
                "neg_fraction", "passed", "remapped_intensities", "seconds",
                "unit", "value"],
    "reg_affine": ["backend", "cost", "dice_floor", "first_call_seconds",
                   "metric", "passed", "seconds", "stage", "unit", "value"],
    "reg_skipped": ["backend", "skipped"],
    "train": ["batch_size", "device", "epochs", "first_epoch_seconds",
              "metric", "samples", "samples_per_sec_per_chip",
              "total_seconds", "unit", "value", "vs_baseline"],
    "trainqual": ["best_epoch", "device", "dice_floor", "early_stopped",
                  "epochs_run", "metric", "n_samples", "n_train_subjects",
                  "passed", "per_subject_dice", "train_seconds", "unit",
                  "valid_acc_floor", "valid_accuracy", "valid_loss", "value",
                  "vs_baseline"],
    "robust": ["degradation", "dice_floor", "metric", "passed",
               "pipeline_seconds", "unit", "value"],
    "robust_summary": ["intensity_augment", "metric", "passed",
                       "per_degradation", "unit", "value", "volume_shape"],
    "scan": ["bf16_device_seconds", "bf16_fast_agreement",
             "bf16_fast_median", "bf16_fast_seconds", "candidate_voxels",
             "checkpoint", "device", "device_seconds", "est_flops_per_scan",
             "est_mfu_bf16", "est_mfu_f32_vs_bf16_peak",
             "fcn_vs_patch_agreement", "host_wire_seconds",
             "includes_post_process", "median_seconds", "metric",
             "n_repeats", "oracle_agreement", "peak_flops_assumed", "unit",
             "value", "volume_shape", "voxels_per_sec_per_chip",
             "vs_baseline", "with_prob_maps_median",
             "with_prob_maps_seconds"],
}
BENCH_TRAIN_ARGS = ["--samples", "4096", "--epochs", "2"]
BENCH_SMALL = dict(shape=(48, 54, 44), max_epochs=6, patience=8, seed=1)
BENCH_TRAINQUAL_FLOORS = dict(dice_floor=0.85, valid_acc_floor=0.90)
BENCH_ROBUST_FLOORS = {"bias_field": 0.82, "combined": 0.65}
# the headline benchmark (phase 17): its repeats and oracle sample; the
# MNI scan's candidates and FLOPs of one slab call (one head row per
# candidate); the JAX package's own fast-profile agreement (bfloat16 with
# uint8 priors vs float32 with uint16) on this scan with phase 4's seeded
# weights, every candidate, on the CPU (scripts/jax_scan_fast_agreement.py)
SCAN_REPEATS = 3
SCAN_ORACLE_N = 32
SCAN_CANDIDATES = 204_403
SCAN_FLOPS = 780_233_270_760
BF16_FAST_REFERENCE = 0.9952055498206973
REG_FILES = {"rT1_template.nii.gz": SHAPE, "rT1d_template.nii.gz": SHAPE,
             "transform.nii": (22, 26, 22, 1, 3),
             "MNI_sub_probabilities.nii.gz": SHAPE + (15,),
             "MNI_subcortical_mask.nii.gz": SHAPE}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def make_training_subject(seed: int):
    """An MNI-sized training subject: make_scan's T1 (its own seed) with
    a 15-class GT, classes 1..14 the ROI ellipsoid cut into 7 angular
    sectors around its z axis times its two z halves, class 15 a ring of
    boundary background 2 voxels wide around it; each structure brightens
    the T1 by 20 per class, and the prior puts 0.6 of its mass on the
    voxel's structure, so both inputs carry the labels."""
    from subcort_tpu_torch.bench.scan import make_scan

    rng = np.random.default_rng(seed)
    image, atlas, roi = make_scan(rng)
    x, y, z = np.ogrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    sector = ((np.arctan2(y - 108.0, x - 90.0) + np.pi)
              / (2 * np.pi) * 7).astype(np.int64) % 7
    cls = (1 + sector + 7 * (z >= 90)).astype(np.uint8)
    gt = np.zeros(SHAPE, np.uint8)
    gt[roi] = np.broadcast_to(cls, SHAPE)[roi]
    ring = (((x - 90) / 30.0) ** 2 + ((y - 108) / 34.0) ** 2
            + ((z - 90) / 28.0) ** 2) < 1.0
    gt[ring & ~roi] = 15
    image[roi] += (gt[roi] * 20).astype(np.int16)
    pri = atlas[roi] * 0.4
    pri[np.arange(len(pri)), gt[roi].astype(np.int64) - 1] += 0.6
    atlas[roi] = pri
    return image, gt, atlas


def time_ms(torch, fn, iters: int = 50, host: bool = False):
    """Mean device milliseconds per call, CUDA events, after a warm-up;
    with ``host``, also the host's milliseconds per call to enqueue them
    (before the closing synchronize): when the two agree, the host's
    launches hold the card back."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.synchronize()
    device_ms = start.elapsed_time(end) / iters
    return (device_ms, host_ms) if host else device_ms


def profile_steps(torch, step, steps: int = PROFILE_STEPS,
                  parts=None, per_call: int = 1) -> dict:
    """torch.profiler over ``steps`` calls of ``step``, each ``per_call``
    train steps: device ms per step by part of the step (``parts``, by
    default KERNEL_PARTS), kernels per step, the device's busy share
    (device time over the window's wall time), and the gather kernel's
    device us per launch (None when it did not run)."""
    parts = KERNEL_PARTS if parts is None else parts
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # the kernels themselves: an aten op's own row repeats its kernels'
    # time, and a user annotation's (Optimizer.step) is the span of its
    # kernels, idle gaps included
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    device_ms = sum(device_us(e) for e in events) / 1e3
    n = steps * per_call
    by_part = {}
    for e in events:
        part = next((name for name, keys in parts
                     if any(k in e.key for k in keys)), "other elementwise")
        by_part[part] = by_part.get(part, 0.0) + device_us(e) / 1e3 / n
    gathers = [e for e in events if "gather_triplanar" in e.key]
    launches = sum(e.count for e in gathers)
    return {"steps": n, "wall_ms_per_step": wall_ms / n,
            "device_ms_per_step": device_ms / n,
            "device_busy_share": device_ms / wall_ms,
            "kernels_per_step": sum(e.count for e in events) / n,
            "gather_us_per_launch": (sum(device_us(e) for e in gathers)
                                     / launches if launches else None),
            "device_ms_per_step_by_part": dict(sorted(
                by_part.items(), key=lambda kv: -kv[1]))}


def train_phase(torch, device, smi, image, atlas, roi) -> tuple:
    """Phase 11: training on the card (see the module docstring). Returns
    its facts and the capped index, whose 3-subject stack phases 14(d) and
    15(b) train on again."""
    import dataclasses

    from subcort_tpu_torch import (NiftiImage, Options, SegmentationEngine,
                                   Trainer, TrainingIndex, TriPlanarNet,
                                   TriPlanarSpec, build_training_index,
                                   init_params, load_nii,
                                   load_theano_checkpoint, save_nii,
                                   segment_volume)
    from subcort_tpu_torch.engine import (candidate_centers,
                                          list_training_subjects, mean_dice,
                                          train_split_stratified)
    from subcort_tpu_torch.config import exact_float32
    from subcort_tpu_torch.engine.train import (ADAM, DeviceAdam, _forward,
                                                make_train_multistep,
                                                train_step)
    from subcort_tpu_torch.models import update_bn_ema
    from subcort_tpu_torch.ops import gather_kernel
    from subcort_tpu_torch.ops.gather_kernel import (gather_roofline_bytes,
                                                     gather_triplanar_cuda,
                                                     prepare_gather_volume)
    from subcort_tpu_torch.ops.patches import gather_triplanar_subjects
    from subcort_tpu_torch.registration import make_synthetic_cohort

    spec = TriPlanarSpec()
    out = {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        # (a) the MNI-sized cohort, through NIfTI and build_training_index
        t0 = time.perf_counter()
        for i in range(3):
            t1, gt, prior = make_training_subject(100 + i)
            sub = root / "cohort" / f"mni{i:02d}"
            (sub / "tmp").mkdir(parents=True)
            save_nii(NiftiImage(t1), str(sub / "T1.nii.gz"))
            save_nii(NiftiImage(gt), str(sub / "gt_15_classes.nii.gz"))
            save_nii(NiftiImage(prior),
                     str(sub / "tmp" / "MNI_sub_probabilities.nii.gz"))
        del t1, gt, prior
        options = Options(experiment="chip_smoke", mode="cuda0",
                          train_folder=str(root / "cohort"),
                          batch_size=TRAIN_BATCH, max_epochs=TRAIN_EPOCHS,
                          patience=5, train_split=0.25, net_verbose=1,
                          load_weights=False, debug=False, seed=0)
        full = build_training_index(options)
        index = TrainingIndex(full.volumes, full.centers[:TRAIN_CAP],
                              full.labels[:TRAIN_CAP],
                              full.atlas[:TRAIN_CAP], full.subject_names)
        print(f"training cohort: 3 subjects {SHAPE}, stack "
              f"{index.volumes.shape} ({index.volumes.nbytes} bytes), "
              f"{len(full)} samples, capped at {len(index)}; written and "
              f"indexed in {time.perf_counter() - t0:.3f} s")
        del full
        train_idx, valid_idx = train_split_stratified(index.labels, 0.25)
        steps = len(train_idx) // TRAIN_BATCH * TRAIN_EPOCHS
        eval_batches = -(-len(valid_idx) // max(TRAIN_BATCH, 2048)) \
            * TRAIN_EPOCHS
        trainer = Trainer(options, spec, weights_path=str(root / "nets"))
        gather_kernel.LAUNCHES = 0
        history = trainer.fit(index)
        launches = gather_kernel.LAUNCHES
        reserved = torch.cuda.memory_reserved(device)
        graph = trainer.step_graph
        check(len(history) == TRAIN_EPOCHS, "Trainer.fit ran every epoch")
        check(launches == steps + eval_batches,
              f"train gather launches {launches} == steps {steps} + eval "
              f"batches {eval_batches}")
        check(graph is not None and graph.warmup_calls == 2
              and graph.replays == steps - 2,
              f"the fit replayed a captured step: {steps} steps, "
              f"{getattr(graph, 'warmup_calls', None)} warm-up, "
              f"{getattr(graph, 'replays', None)} replayed")
        print(f"train fit: {graph.warmup_calls} warm-up steps, "
              f"{graph.replays} replays of one captured step, capture "
              f"{graph.capture_ms:.3f} ms; {reserved} bytes reserved by the "
              "caching allocator after the fit")
        losses = [(h["train_loss"], h["valid_loss"]) for h in history]
        check(bool(np.isfinite(losses).all()), f"finite losses {losses}")
        check(history[1]["train_loss"] < history[0]["train_loss"],
              f"epoch 2's train loss below epoch 1's: {losses}")
        check(trainer.best_epoch == TRAIN_EPOCHS,
              f"validation loss fell in the last epoch: {losses}")
        saved = load_theano_checkpoint(trainer.weights_file)
        params = trainer.params
        check(saved.keys() == params.keys()
              and all(torch.equal(saved[k], params[k]) for k in params),
              "best-only checkpoint == the trainer's params, bit for bit")
        per_epoch = len(train_idx) // TRAIN_BATCH * TRAIN_BATCH
        for h in history:
            print(f"train epoch {h['epoch']}: {h['dur']:.4f} s, "
                  f"{per_epoch / h['dur']:.1f} samples/s, train_loss "
                  f"{h['train_loss']:.6f}, valid_loss {h['valid_loss']:.6f}, "
                  f"valid_accuracy {h['valid_accuracy']:.6f}")
        print(f"train main path: {steps} steps of {TRAIN_BATCH} + "
              f"{eval_batches} eval batches, {launches} gather launches")
        out.update(train_launches=launches, train_graphed_launches=launches,
                   train_steps=steps, train_eval_batches=eval_batches,
                   train_capture_ms=graph.capture_ms,
                   train_warmup_steps=graph.warmup_calls,
                   train_replayed_steps=graph.replays,
                   train_reserved_bytes_after_fit=reserved,
                   train_epoch_s=[h["dur"] for h in history],
                   train_samples_per_s=[per_epoch / h["dur"]
                                        for h in history])

        seg = root / "segment" / "mni01"
        (seg / "tmp").mkdir(parents=True)
        save_nii(NiftiImage(image), str(seg / "T1.nii.gz"))
        save_nii(NiftiImage(atlas),
                 str(seg / "tmp" / "MNI_sub_probabilities.nii.gz"))
        save_nii(NiftiImage(roi.astype(np.uint8)),
                 str(seg / "tmp" / "MNI_subcortical_mask.nii.gz"))
        engine = SegmentationEngine(saved, Options(
            test_folder=str(seg.parent), mode="cuda0", debug=False,
            net_verbose=0))
        engine.segment_folder()
        labelled = int((load_nii(str(
            seg / "out_subcortical_seg_prec.nii.gz")).data != 0).sum())
        check(labelled > 0, "trained params: non-zero labels")
        print(f"trained params through segment_folder (dense): {labelled} "
              "labelled voxels")

        # (b) step times on a pre-staged batch
        volume = prepare_gather_volume(
            torch.from_numpy(index.volumes).to(device))
        rows = torch.from_numpy(train_idx[:TRAIN_BATCH]).to(device)
        c = torch.from_numpy(index.centers).to(device)[rows].contiguous()
        lab = torch.from_numpy(index.labels.astype(np.int64)).to(device)[rows]
        at = torch.from_numpy(index.atlas).to(device)[rows]
        padded = volume.padded()
        gen = torch.Generator(device=device).manual_seed(0)
        net = TriPlanarNet.from_params(params, spec, device, trainable=True)
        opt = DeviceAdam(net.parameters(), **ADAM)

        def step(gather, dtype=None):
            return lambda: train_step(net, opt, gather(), lab, at, gen,
                                      compute_dtype=dtype)

        kernel = lambda: gather_triplanar_cuda(volume, c)  # noqa: E731
        plain = lambda: gather_triplanar_subjects(padded, c)  # noqa: E731
        for got, want in zip(kernel(), plain()):
            check(torch.equal(got, want), "train batch: kernel == plain")
        idx = gather_kernel.window_index(c, padded.shape)
        times = {
            "step_f32": time_ms(torch, step(kernel), STEP_ITERS, host=True),
            "step_bf16": time_ms(torch, step(kernel, torch.bfloat16),
                                 STEP_ITERS, host=True),
            "step_plain_gather": time_ms(torch, step(plain), STEP_ITERS,
                                         host=True),
            "gather": time_ms(torch, kernel, STEP_ITERS, host=True),
            "gather_plain": time_ms(torch, plain, STEP_ITERS, host=True),
            "gather_take": time_ms(torch, lambda: torch.take(padded, idx),
                                   STEP_ITERS, host=True),
        }

        # the float32 step by part, on the kernel's patches of the batch
        views = kernel()

        def forward():
            net.train()
            return _forward(net, views, at, gen, None)

        def forward_backward():
            opt.zero_grad(set_to_none=True)
            torch.nn.functional.cross_entropy(forward(), lab).backward()

        forward_backward()  # gradients for the optimizer-only timing
        bns = [m for m in net.modules()
               if getattr(m, "batch_stats", None) is not None]
        stats = [m.batch_stats for m in bns]

        def ema():
            for m, st in zip(bns, stats):
                m.batch_stats = st
            update_bn_ema(net)

        with exact_float32():
            for name, fn in (("forward", forward),
                             ("forward_backward", forward_backward),
                             ("adam", opt.step), ("bn_ema", ema)):
                times[name] = time_ms(torch, fn, STEP_ITERS, host=True)
        profile = profile_steps(torch, step(kernel))
        nbytes = gather_roofline_bytes(c, padded.shape)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ms = {k: v[0] for k, v in times.items()}
        print(f"train step, batch {TRAIN_BATCH}, full width (CUDA events, "
              f"{STEP_ITERS} steps): float32 {ms['step_f32']:.4f} ms, "
              f"bfloat16 {ms['step_bf16']:.4f} ms, float32 with the "
              f"plain gather {ms['step_plain_gather']:.4f} ms")
        print("train step parts, (device ms, host enqueue ms) per call: "
              + ", ".join(f"{k} ({v[0]:.4f}, {v[1]:.4f})"
                          for k, v in times.items()))
        print(f"train step profile: {json.dumps(profile)}")
        print(f"train gather at B={TRAIN_BATCH} on the 3-subject stack: "
              f"kernel {ms['gather']:.4f} ms, plain "
              f"{ms['gather_plain']:.4f} ms, torch.take "
              f"{ms['gather_take']:.4f} ms; bound {bound:.4f} ms "
              f"({nbytes} bytes), {bound / ms['gather']:.1%} of it; "
              f"{ms['gather'] / ms['step_f32']:.2%} of the float32 "
              "step")
        out.update(train_gather_ms=ms["gather"],
                   train_gather_plain_ms=ms["gather_plain"],
                   train_gather_library_ms=ms["gather_take"],
                   train_gather_bound_ms=bound,
                   train_step_ms=ms["step_f32"],
                   train_step_bf16_ms=ms["step_bf16"],
                   train_step_plain_gather_ms=ms["step_plain_gather"],
                   train_step_host_ms=times["step_f32"][1],
                   train_step_profile=profile)

        # the same steps graphed: make_train_multistep's replays of one
        # captured step on the pre-staged batch, STEP_ITERS steps a call
        stacked = [t.expand((STEP_ITERS,) + tuple(t.shape)).contiguous()
                   for t in (c, lab, at)]

        def graphed(dtype):
            """(CUDA-event ms, host enqueue ms) per step of a call of
            STEP_ITERS replays (time_ms's first warm-up call captures),
            the capture's ms, and in float32 torch.profiler over a call of
            PROFILE_STEPS replays."""
            with make_train_multistep(net, opt, volume, gen, spec.patch_size,
                                      STEP_ITERS, compute_dtype=dtype) as m:
                dev_ms, host_ms = time_ms(torch, lambda: m(*stacked),
                                          iters=1, host=True)
                prof = None
                if dtype is None:
                    sub = [t[:PROFILE_STEPS] for t in stacked]
                    prof = profile_steps(torch, lambda: m(*sub), steps=1,
                                         per_call=PROFILE_STEPS)
                check(m.graphed.warmup_calls == 2 and m.graphed.replays
                      == 6 * STEP_ITERS - 2 + (6 * PROFILE_STEPS
                                               if prof else 0),
                      f"timed steps replayed: {m.graphed.replays}")
                return (dev_ms / STEP_ITERS, host_ms / STEP_ITERS,
                        m.graphed.capture_ms, prof)

        g32, g16 = graphed(None), graphed(torch.bfloat16)
        print(f"train step graphed vs eager, batch {TRAIN_BATCH}, full "
              f"width, {smi} (CUDA events over {STEP_ITERS} steps; device "
              f"ms, host enqueue ms per step): float32 graphed {g32[0]:.4f}, "
              f"{g32[1]:.4f}, eager {times['step_f32'][0]:.4f}, "
              f"{times['step_f32'][1]:.4f}; bfloat16 graphed {g16[0]:.4f}, "
              f"{g16[1]:.4f}, eager {times['step_bf16'][0]:.4f}, "
              f"{times['step_bf16'][1]:.4f}; capture {g32[2]:.3f} ms "
              f"(float32), {g16[2]:.3f} ms (bfloat16)")
        print(f"train step graphed profile ({PROFILE_STEPS} replays): "
              f"{json.dumps(g32[3])}")
        out.update(train_step_graphed_ms=g32[0],
                   train_step_graphed_enqueue_ms=g32[1],
                   train_step_bf16_graphed_ms=g16[0],
                   train_step_bf16_graphed_enqueue_ms=g16[1],
                   train_step_bf16_host_ms=times["step_bf16"][1],
                   train_step_graphed_profile=g32[3])
        del net, opt, volume, padded, idx, views, bns, stats, stacked

        # (c) one step on the card and on the CPU, float32 and bfloat16,
        # from seeded initial params, so every run checks the same numbers
        # (trained params differ from run to run, and their confident
        # logits put bfloat16's rounding of one hard sample into the loss)
        spec0 = dataclasses.replace(spec, dropout_conv=0.0, dropout_fc=0.0)
        init = init_params(spec0, torch.Generator().manual_seed(0))

        def one_step(dev, dtype=None):
            net = TriPlanarNet.from_params(init, spec0, dev, trainable=True)
            opt = torch.optim.Adam(net.parameters(), **ADAM)
            vol = prepare_gather_volume(
                torch.from_numpy(index.volumes).to(dev))
            loss = train_step(net, opt, gather_triplanar_cuda(vol, c.to(dev)),
                              lab.to(dev), at.to(dev), compute_dtype=dtype)
            return float(loss), {k: v.cpu() for k, v in
                                 net.state_dict().items()
                                 if k.endswith((".mean", ".inv_std"))}

        def differ(a, b):
            """(relative loss difference, max and mean |EMA difference|)"""
            diffs = torch.cat([(a[1][k] - b[1][k]).abs() for k in a[1]])
            return (abs(a[0] - b[0]) / abs(b[0]), float(diffs.max()),
                    float(diffs.mean()))

        cpu = torch.device("cpu")
        runs = {(dev.type, dt): one_step(dev, dt) for dev in (device, cpu)
                for dt in (None, torch.bfloat16)}
        f32 = differ(runs["cuda", None], runs["cpu", None])
        bf16 = differ(runs["cuda", torch.bfloat16], runs["cpu", torch.bfloat16])
        gap = differ(runs["cpu", torch.bfloat16], runs["cpu", None])
        print(f"train step card vs CPU, float32: loss "
              f"{runs['cuda', None][0]:.8f} vs {runs['cpu', None][0]:.8f}, "
              f"relative difference {f32[0]:.3e}; BN EMA max |difference| "
              f"{f32[1]:.3e}")
        print(f"train step card vs CPU, bfloat16: loss relative difference "
              f"{bf16[0]:.3e}, BN EMA max / mean |difference| {bf16[1]:.3e} "
              f"/ {bf16[2]:.3e}; the CPU's bfloat16 vs float32: "
              f"{gap[0]:.3e}, {gap[1]:.3e} / {gap[2]:.3e}")
        check(f32[0] <= CARD_VS_CPU_STEP, f"step loss card vs CPU {f32[0]:.3e}")
        check(f32[1] <= CARD_VS_CPU_STEP, f"BN EMA card vs CPU {f32[1]:.3e}")
        check(bf16[0] <= BF16_STEP_LOSS,
              f"bfloat16 step loss card vs CPU {bf16[0]:.3e} <= "
              f"{BF16_STEP_LOSS}")
        check(bf16[2] <= BF16_STEP_SHARE * gap[2],
              f"bfloat16 BN EMA card vs CPU, mean {bf16[2]:.3e} <= "
              f"{BF16_STEP_SHARE} x {gap[2]:.3e}")
        out.update(train_step_card_vs_cpu=f32, train_step_bf16_card_vs_cpu=bf16,
                   train_step_bf16_vs_f32_cpu=gap)

        # (d) quality on tests/test_trainqual.py's phantom
        cohort = str(root / "phantom")
        make_synthetic_cohort(cohort, n_subjects=3, shape=(48, 54, 44),
                              seed=1, noise=4.0, prior_error=0)
        qopts = Options(experiment="trainqual", train_folder=cohort,
                        mode="cuda0", max_epochs=6, patience=8,
                        batch_size=128, train_split=0.25, net_verbose=0,
                        load_weights=False, debug=False, seed=1)
        subjects = list_training_subjects(qopts)
        q = build_training_index(qopts, subjects=subjects[:2])
        q = TrainingIndex(q.volumes, q.centers[:4096], q.labels[:4096],
                          q.atlas[:4096], q.subject_names)
        qtrainer = Trainer(qopts, spec, weights_path=str(root / "nets"))
        # deterministic cuDNN algorithms, so the floors see the same
        # weights in every run (the default backward sums in no fixed order)
        cudnn = torch.backends.cudnn
        flags = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            qhist = qtrainer.fit(q)
        finally:
            cudnn.deterministic, cudnn.benchmark = flags
        best = min(qhist, key=lambda h: h["valid_loss"])
        held = Path(subjects[2].t1_path).parent
        himage = np.asarray(load_nii(str(held / "T1.nii.gz")).data)
        hgt = np.asarray(load_nii(str(held / "gt_15_classes.nii.gz")).data)
        hgt = np.where(hgt == 15, 0, hgt).astype(np.uint8)
        hatlas = np.asarray(load_nii(str(
            held / "tmp" / "MNI_sub_probabilities.nii.gz")).data, np.float32)
        hmask = np.asarray(load_nii(str(
            held / "tmp" / "MNI_subcortical_mask.nii.gz")).data)
        qnet = TriPlanarNet.from_params(
            load_theano_checkpoint(qtrainer.weights_file), spec, device)
        labels, _ = segment_volume(qnet, himage, hatlas,
                                   candidate_centers(himage, qopts, hmask))
        dice = mean_dice(labels, hgt)
        print(f"quality: valid_accuracy by epoch "
              f"{[round(h['valid_accuracy'], 6) for h in qhist]}, best "
              f"(epoch {best['epoch']}) {best['valid_accuracy']:.6f}; "
              f"held-out Dice {dice:.6f}")
        check(best["valid_accuracy"] >= QUALITY_VALID_ACC,
              f"best valid_accuracy {best['valid_accuracy']} >= "
              f"{QUALITY_VALID_ACC}")
        check(dice >= QUALITY_DICE, f"held-out Dice {dice} >= {QUALITY_DICE}")
        out.update(quality_valid_accuracy=best["valid_accuracy"],
                   quality_dice=dice)

        # (e) a graphed and an eager 1-epoch fit from the same seed on (a)'s
        # index, under cuDNN's deterministic algorithms
        fits = {}
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            for eager in (False, True):
                t = Trainer(dataclasses.replace(
                    options, max_epochs=1, net_verbose=0,
                    experiment=f"graphed_vs_eager_{eager}"), spec,
                    weights_path=str(root / "nets"))
                h = t.fit(index, _eager=eager)[0]
                fits[eager] = ({k: v for k, v in h.items() if k != "dur"},
                               t.params, h["dur"], t.step_graph)
        finally:
            cudnn.deterministic, cudnn.benchmark = flags
        same = fits[False][0] == fits[True][0] and all(
            torch.equal(fits[False][1][k], v)
            for k, v in fits[True][1].items())
        print(f"1-epoch fit graphed vs eager: {fits[False][2]:.4f} s vs "
              f"{fits[True][2]:.4f} s, {fits[False][3].replays} replays; "
              f"histories and parameters bit-equal: {same}")
        check(same and fits[True][3] is None,
              "graphed fit == eager fit, bit for bit")
        out.update(train_epoch_graphed_vs_eager_s=[fits[False][2],
                                                   fits[True][2]])
    finally:
        shutil.rmtree(root)

    # bfloat16 vs float32 labels of the trained MNI weights: a fact for
    # ROADMAP A3's 0.999 question, not a gate
    trained = TriPlanarNet.from_params(saved, spec, device)
    cands = candidate_centers(image, Options(), roi.astype(np.uint8))
    sel = tuple(cands.T)
    f32 = segment_volume(trained, image, atlas, cands)[0]
    bf16 = segment_volume(trained, image, atlas, cands,
                          compute_dtype="bfloat16")[0]
    agreement = float(np.mean(f32[sel] == bf16[sel]))
    print(f"trained MNI weights, bfloat16 vs float32 labels (dense, "
          f"{len(cands)} candidates): {agreement}")
    out["trained_bf16_agreement"] = agreement
    return out, index


def dice(a, b) -> float:
    return 2.0 * int((a & b).sum()) / max(int(a.sum()) + int(b.sum()), 1)


def registration_spans(recs):
    """``register_masks``'s calls from their spans: (seconds and peak bytes
    by stage, each stage's seconds less its NIfTI IO and mask, which are
    ``io_s`` and ``mask_s``, so that they sum to the calls; the attributes
    of each ``register.level`` span, with its ``level_ms``)."""
    report = {}
    kids = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    for r in recs:
        if r.name in ("register.affine", "register.ffd",
                      "register.prior_warp"):
            stage = r.name.split(".")[1]
            apart = 0
            for k in kids.get(r.id, []):
                if k.name in ("register.io", "register.mask"):
                    key = k.name.split(".")[1] + "_s"
                    report[key] = report.get(key, 0.0) + k.duration_ns * 1e-9
                    apart += k.duration_ns
            report[stage + "_s"] = (r.duration_ns - apart) * 1e-9
            if "peak_bytes" in r.attrs:
                report[stage + "_peak_bytes"] = r.attrs["peak_bytes"]
    levels = [dict(r.attrs, level_ms=r.duration_ns * 1e-6)
              for r in sorted(recs, key=lambda r: r.start_ns)
              if r.name == "register.level"]
    return report, levels


def print_levels(levels) -> None:
    """One line per ``register.level`` span (:func:`registration_spans`)."""
    for lv in levels:
        print(f"  level {lv['stage']} {lv.get('dof', '')} {lv['shape']}: "
              f"{lv['iters']} iterations, replayed {lv['replayed']} "
              f"(warm-up {lv['warmup_iters']}, capture {lv['capture_ms']} "
              f"ms); {lv['device_ms_per_iter']} ms per iteration by CUDA "
              f"events, host enqueue {lv['host_enqueue_ms_per_iter']} ms "
              f"(warm-up: {lv['warmup_device_ms_per_iter']} and "
              f"{lv['warmup_enqueue_ms_per_iter']} ms); the level "
              f"{lv['level_ms']} ms; {lv['reserved_bytes']} bytes reserved")


def registration_phase(torch, device, image, atlas, roi, params, spec,
                       atlas_dir: Path) -> dict:
    """Phase 12: on-device registration (see the module docstring). The
    MNI-sized template and atlas of (c) go to ``atlas_dir``, which the
    caller keeps for phase 14(b)."""
    from scipy import ndimage

    from subcort_tpu_torch import (NiftiImage, Options, SegmentationEngine,
                                   build_training_index, load_nii, save_nii)
    from subcort_tpu_torch.bench.reg import (make_affine_phantom,
                                             make_phantom, masks_dice,
                                             structure_dice)
    from subcort_tpu_torch.config import exact_float32
    from subcort_tpu_torch.models import fcn
    from subcort_tpu_torch.ops import gather_kernel
    from subcort_tpu_torch.registration import (load_cpp_grid,
                                                make_synthetic_cohort,
                                                register_masks,
                                                resample_through_affine,
                                                resample_through_cpp)
    from subcort_tpu_torch.registration.torch_affine import \
        register_affine_torch
    from subcort_tpu_torch.registration.torch_backend import (
        CppGrid, _resample_affine, _resample_cpp)
    from subcort_tpu_torch.registration.torch_ffd import (_grid_counts, _nmi,
                                                          jacobian_stats,
                                                          nmi_normalisation,
                                                          register_ffd_torch)
    from subcort_tpu_torch.utils import runtime

    out = {}
    eye = np.eye(4)
    rng = np.random.default_rng(12)

    # the known misalignment of (a) and (c): a 12-dof affine about the
    # volume's centre and a smooth warp of up to 3 voxels on a 10 mm grid
    rz = np.deg2rad(5.0)
    c, s = np.cos(rz), np.sin(rz)
    M = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]) @ np.diag(
        [1.04, 0.97, 1.02])
    center = (np.asarray(SHAPE) - 1) / 2.0
    B = np.eye(4)
    B[:3, :3] = M
    B[:3, 3] = center - M @ center + np.array([3.0, -2.0, 1.5])
    nc = _grid_counts(SHAPE, 10.0)
    smooth = ndimage.gaussian_filter(rng.standard_normal(nc + (3,)),
                                     (2, 2, 2, 0))
    smooth = (smooth * 3.0 / np.abs(smooth).max()).astype(np.float32)
    ii, jj, kk = np.meshgrid(*[np.arange(n) for n in nc], indexing="ij")
    cp = np.stack([(ii - 1) * 10.0, (jj - 1) * 10.0, (kk - 1) * 10.0], -1)
    baked = (cp @ B[:3, :3].T + B[:3, 3] - cp).astype(np.float32)
    grid = CppGrid(baked + smooth, 10.0, eye)
    check(jacobian_stats(grid, SHAPE, device)["min_jac"] > 0.5,
          "the known misalignment is far from folding")

    # (a) the resampler, card vs CPU, on the 427 MB prior volume
    flo = torch.from_numpy(atlas).to(device)
    n_bytes = 2 * atlas.nbytes
    results = {}
    for name, public, transform, program, args in (
            ("resample_through_cpp", resample_through_cpp, grid,
             _resample_cpp, (grid.disp, (10.0, 10.0, 10.0), eye, eye, SHAPE)),
            ("resample_through_affine", resample_through_affine, B,
             _resample_affine, (B, eye, eye, SHAPE))):
        card = results[name] = public(atlas, eye, transform, SHAPE, eye,
                                      device=device)
        cpu = public(atlas, eye, transform, SHAPE, eye, device="cpu")
        check(card.shape == atlas.shape and bool(np.isfinite(card).all()),
              f"{name}: finite, the reference grid's shape")
        err = float(np.abs(card - cpu).max())
        span = float(atlas.max() - atlas.min())
        with torch.no_grad(), exact_float32():
            ms = time_ms(torch, lambda: program(flo, *args), iters=5)
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        print(f"{name}: {atlas.shape} float32 ({atlas.nbytes} bytes), card "
              f"vs CPU max |difference| {err:.3e} of a value range of "
              f"{span}; device program {ms:.3f} ms, "
              f"{n_bytes / ms / 1e6:.1f} GB/s of {n_bytes} bytes read and "
              f"written (bound {bound:.3f} ms)")
        check(err <= REG_RESAMPLE_TOL * span,
              f"{name} card vs CPU {err:.3e} <= {REG_RESAMPLE_TOL} of {span}")
        out[f"reg_{name}_ms"] = ms
        out[f"reg_{name}_card_vs_cpu"] = err
    # the template's atlas: the phase-4 priors through the known transform
    template_atlas = results["resample_through_cpp"]
    del flo, card, cpu, results

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_reg_"))
    env = os.environ.get("SUBCORT_ATLAS_DIR")
    try:
        # (b) quality on bench_reg.py's phantoms (bench/reg.py's copies)
        template, subject, subject_remap, p_atlas, gt_masks = make_phantom()
        nc6 = _grid_counts(template.shape, 6.0)
        identity = structure_dice(
            CppGrid(np.zeros(nc6 + (3,), np.float32), 6.0, eye), p_atlas,
            gt_masks, device)
        phantoms = {}

        def ffd(ref, cost, dev):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, losses = register_ffd_torch(ref, template, spacing_mm=6.0,
                                           iters=(60, 10), cost=cost,
                                           device=dev)
            seconds = time.perf_counter() - t0
            stats = jacobian_stats(g, ref.shape, dev)
            d = structure_dice(g, p_atlas, gt_masks, dev)
            return g, losses, d, stats, seconds

        for cost, ref in (("ssd", subject), ("nmi", subject_remap)):
            ffd(ref, cost, device)  # first calls (cuBLAS, allocator)
            g, losses, d, stats, seconds = ffd(ref, cost, device)
            print(f"phantom FFD {cost}: structure Dice {d:.4f} (identity "
                  f"{identity:.4f}), min det(J)/det(A) "
                  f"{stats['min_jac']:.4f}, neg_fraction "
                  f"{stats['neg_fraction']}, {seconds:.3f} s")
            check(d >= REG_DICE_FLOOR,
                  f"phantom FFD {cost}: Dice {d} >= {REG_DICE_FLOOR}")
            check(stats["min_jac"] > REG_MIN_JAC_FLOOR,
                  f"phantom FFD {cost}: min_jac {stats['min_jac']} > "
                  f"{REG_MIN_JAC_FLOOR}")
            phantoms[cost] = {"dice": d, "min_jac": stats["min_jac"],
                              "seconds": seconds}
            if cost == "ssd":
                again = ffd(ref, cost, device)
                rerun = float(np.abs(again[0].disp - g.disp).max())
                cpu = ffd(ref, cost, "cpu")
                loss_diff = float(abs(cpu[1][1][-1] - losses[1][-1])
                                  / abs(cpu[1][1][-1]))
                print(f"phantom FFD ssd: a second run on the card differs "
                      f"by at most {rerun:.3e} mm in the control values "
                      f"(bit-equal: {rerun == 0.0}); on the CPU: Dice "
                      f"{cpu[2]:.4f}, final loss {cpu[1][1][-1]:.6f} vs "
                      f"{losses[1][-1]:.6f} (relative {loss_diff:.3e}), "
                      f"max |control difference| "
                      f"{np.abs(cpu[0].disp - g.disp).max():.3e} mm, "
                      f"{cpu[4]:.3f} s")
                check(abs(cpu[2] - d) <= REG_CARD_VS_CPU_DICE,
                      f"phantom FFD card vs CPU Dice {d} vs {cpu[2]}")
                check(loss_diff <= REG_CARD_VS_CPU_LOSS,
                      f"phantom FFD card vs CPU final loss {loss_diff:.3e}")
                phantoms["ssd"].update(rerun_max_diff=rerun,
                                       cpu_dice=cpu[2],
                                       cpu_loss_rel_diff=loss_diff)

        # the backward holds no scatter into the floating image
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            register_ffd_torch(subject_remap, template, spacing_mm=6.0,
                               iters=(3, 2), cost="nmi", device=device)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        scatter = [n for n in names if "index_put" in n
                   or "indexing_backward" in n or "index_add" in n]
        check(not scatter, f"no scatter kernel in an FFD fit: {scatter}")
        print(f"profile of a 5-iteration FFD fit: {len(names)} distinct ops "
              "and kernels, none of them index_put / indexing_backward")

        a_template, a_subject, a_atlas, a_masks = make_affine_phantom()
        register_affine_torch(a_subject, a_template, cost="ssd",
                              device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A = register_affine_torch(a_subject, a_template, cost="ssd",
                                  device=device)
        seconds = time.perf_counter() - t0
        d = masks_dice(resample_through_affine(
            a_atlas, eye, A, a_subject.shape, eye, device=device), a_masks)
        a_identity = masks_dice(a_atlas, a_masks)
        print(f"phantom affine ssd: structure Dice {d:.4f} (identity "
              f"{a_identity:.4f}), {seconds:.3f} s")
        check(d >= REG_DICE_FLOOR,
              f"phantom affine: Dice {d} >= {REG_DICE_FLOOR}")
        phantoms["affine"] = {"dice": d, "seconds": seconds}
        out["reg_phantoms"] = phantoms
        out["reg_phantom_identity_dice"] = identity

        # (c) full width, through the entry points
        t0 = time.perf_counter()
        t1f = image.astype(np.float32)
        template = resample_through_cpp(t1f, eye, grid, SHAPE, eye,
                                        device=device)
        tmax = float(template.max())
        template = (tmax * (template / tmax) ** 1.6).astype(np.float32)
        atlas_dir.mkdir()
        save_nii(NiftiImage(template), str(atlas_dir / "T1_template.nii.gz"))
        save_nii(NiftiImage(template_atlas),
                 str(atlas_dir / "atlas_subcortical_MNI.nii.gz"))
        sub = root / "scans" / "mni01"
        sub.mkdir(parents=True)
        scan = str(sub / "T1.nii.gz")
        save_nii(NiftiImage(image), scan)
        print(f"MNI-sized template, atlas and subject written in "
              f"{time.perf_counter() - t0:.3f} s")
        os.environ["SUBCORT_ATLAS_DIR"] = str(atlas_dir)
        options = Options(test_folder=str(sub.parent), mode="cuda0",
                          reg_backend="torch", reg_similarity="nmi",
                          debug=False, net_verbose=0)
        engine = SegmentationEngine(params, options, spec)
        check(engine.register_fn is None, "no register_fn: the engine binds "
              "register_masks itself")
        gather_kernel.LAUNCHES = 0
        fcn.SLABS = 0
        runtime.clear_records()
        t0 = time.perf_counter()
        with runtime.recording():
            engine.segment_folder()
        seconds = time.perf_counter() - t0
        report, levels = registration_spans(runtime.records())
        check(fcn.SLABS >= 1, "the registered scan went through the dense "
              "evaluator")
        tmp = sub / "tmp"
        check(np.loadtxt(str(tmp / "transf.txt")).shape == (4, 4),
              "transf.txt holds a 4x4 affine")
        loaded = {}
        for name, shape in REG_FILES.items():
            check((tmp / name).exists(), f"{name} exists")
            loaded[name] = np.asarray(load_nii(str(tmp / name)).data)
            check(loaded[name].shape == shape,
                  f"{name}: shape {loaded[name].shape} == {shape}")
        fitted = load_cpp_grid(str(tmp / "transform.nii"), eye)
        stats = jacobian_stats(fitted, SHAPE, device)
        check(stats["min_jac"] > 0.0,
              f"the fitted transform does not fold: {stats}")

        def nmi_with_subject(moving):
            with torch.no_grad(), exact_float32():
                ref = torch.from_numpy(t1f).to(device)
                mov = torch.from_numpy(moving).to(device)
                ref01, lo, scale = nmi_normalisation(ref, mov)
                return float(_nmi(ref01, torch.clamp((mov - lo) * scale,
                                                     0.0, 1.0), 32))

        nmi_before = nmi_with_subject(template)
        nmi_affine = nmi_with_subject(loaded["rT1_template.nii.gz"])
        nmi_after = nmi_with_subject(loaded["rT1d_template.nii.gz"])
        check(nmi_after > nmi_before,
              f"NMI with the subject rose: {nmi_before} -> {nmi_after}")

        def roi_of(priors):
            return priors[..., :14].sum(-1) > 0.5

        d = dice(roi_of(loaded["MNI_sub_probabilities.nii.gz"]), roi)
        d_identity = dice(roi_of(template_atlas), roi)
        check(d >= REG_MNI_DICE, f"warped priors' ROI Dice {d} >= "
              f"{REG_MNI_DICE} (identity {d_identity})")
        seg = load_nii(str(sub / "out_subcortical_seg_prec.nii.gz"))
        labelled = int((seg.data != 0).sum())
        check(seg.data.shape == SHAPE and labelled > 0,
              "a segmentation with non-zero labels")
        again = register_masks(scan, backend="torch", similarity="nmi",
                               device=device)
        check(again < 1.0, f"the stage cache: a second register_masks call "
              f"took {again:.3f} s < 1 s")
        reg_s = sum(v for k, v in report.items() if k.endswith("_s"))
        print(f"MNI-sized scan without tmp/: segment_folder {seconds:.3f} s; "
              f"register_masks (graphed levels) {reg_s:.3f} s, by stage "
              f"(io_s: NIfTI reads and writes only) {json.dumps(report)}; "
              f"second call {again:.4f} s")
        print_levels(levels)
        check(len(levels) == 6 and all(lv["replayed"] for lv in levels),
              "every affine and FFD level replayed one captured iteration: "
              f"{[(lv['stage'], lv['replayed']) for lv in levels]}")

        # the same subject registered again with every level a plain loop
        eager_scan = root / "eager" / "mni01" / "T1.nii.gz"
        eager_scan.parent.mkdir(parents=True)
        shutil.copy(scan, eager_scan)
        runtime.clear_records()
        with runtime.recording():
            register_masks(str(eager_scan), backend="torch",
                           similarity="nmi", device=device, _eager=True)
        report_eager, levels_eager = registration_spans(runtime.records())
        eager_s = sum(v for k, v in report_eager.items() if k.endswith("_s"))
        print(f"the same subject, every level a plain loop: register_masks "
              f"{eager_s:.3f} s, by stage {json.dumps(report_eager)}")
        print_levels(levels_eager)
        check(len(levels_eager) == 6
              and not any(lv["replayed"] for lv in levels_eager),
              "the eager call ran every level as a plain loop")
        eager_tmp = eager_scan.parent / "tmp"
        controls = (fitted.disp,
                    load_cpp_grid(str(eager_tmp / "transform.nii"), eye).disp)
        affines = (np.loadtxt(str(tmp / "transf.txt")),
                   np.loadtxt(str(eager_tmp / "transf.txt")))
        graph_vs_eager = {
            "controls_max_abs_diff": float(np.abs(np.subtract(*controls)).max()),
            "affine_max_abs_diff": float(np.abs(np.subtract(*affines)).max())}
        print(f"graphed vs eager register_masks: {json.dumps(graph_vs_eager)}")
        check(np.array_equal(*controls) and np.array_equal(*affines),
              "graphed and eager levels give the same transform.nii controls "
              f"and transf.txt: {graph_vs_eager}")
        print(f"MNI-sized registration: NMI with the subject "
              f"{nmi_before:.6f} unregistered, {nmi_affine:.6f} affine, "
              f"{nmi_after:.6f} deformable; ROI Dice {d:.6f} (identity "
              f"{d_identity:.6f}); min det(J)/det(A) {stats['min_jac']:.4f}, "
              f"neg_fraction {stats['neg_fraction']}; {labelled} labelled "
              "voxels")
        # the device's own work in one iteration of the quarter-resolution
        # affine level and of both FFD levels: the levels' own iteration
        # (adam_level), eager, under torch.profiler
        from subcort_tpu_torch.registration import torch_affine, torch_ffd
        from subcort_tpu_torch.registration.torch_backend import (adam_level,
                                                                  downsample2)

        profiles = {}
        ref_full = torch.from_numpy(t1f).to(device)
        flo_full = torch.from_numpy(template).to(device)
        ref_half, half_affine = downsample2(ref_full, eye)
        flo_half, _ = downsample2(flo_full, eye)
        ref_quarter, quarter_affine = downsample2(ref_half, half_affine)
        flo_quarter, _ = downsample2(flo_half, half_affine)
        d0 = torch.from_numpy(fitted.disp).to(device)
        center = torch.from_numpy(
            torch_affine._moments(t1f, eye)[0].astype(np.float32)).to(device)
        for name, ref, flo, aff, spacing, offset in (
                ("affine quarter level", ref_quarter, flo_quarter,
                 quarter_affine, None, None),
                ("ffd half level", ref_half, flo_half, half_affine, 5.0, 0.25),
                ("ffd full level", ref_full, flo_full, eye, 10.0, 0.0)):
            aff_t = torch.from_numpy(aff.astype(np.float32)).to(device)
            inv_t = torch.from_numpy(
                np.linalg.inv(aff).astype(np.float32)).to(device)
            with exact_float32():
                if spacing is None:
                    loss_fn = torch_affine._level_loss(
                        center, ref, flo, aff_t, inv_t, cost="nmi")
                    x0 = torch.zeros(12, device=device)
                else:
                    loss_fn = torch_ffd._level_loss(
                        d0, ref, flo, aff_t, inv_t, (spacing,) * 3, 5e-4,
                        cost="nmi", jw=1.0, vox_offset=offset)
                    x0 = d0
                # room in the loss vector for the warm-up and the 3 steps
                step, _, _ = adam_level(loss_fn, x0, 16, 0.01)
                profiles[name] = profile_steps(torch, step, steps=3,
                                               parts=REG_KERNEL_PARTS)
            print(f"  {name} {list(ref.shape)}, one iteration under the "
                  f"profiler: {json.dumps(profiles[name])}")
            del loss_fn, step
        del ref_full, flo_full, ref_half, flo_half, ref_quarter, flo_quarter
        out.update(reg_segment_folder_s=seconds, reg_stages=report,
                   reg_level_profiles=profiles,
                   reg_levels=levels, reg_levels_eager=levels_eager,
                   reg_stages_eager=report_eager,
                   reg_graph_vs_eager=graph_vs_eager, reg_mni_dice=d,
                   reg_mni_identity_dice=d_identity,
                   reg_mni_min_jac=stats["min_jac"],
                   reg_mni_nmi=[nmi_before, nmi_affine, nmi_after],
                   reg_cached_call_s=again)

        # (d) the priors-miss path of training
        cohort = str(root / "cohort")
        make_synthetic_cohort(cohort, n_subjects=1, shape=(48, 54, 44),
                              seed=1, write_priors=False)
        os.environ["SUBCORT_ATLAS_DIR"] = cohort + "_atlases"
        t0 = time.perf_counter()
        index = build_training_index(Options(
            train_folder=cohort, mode="cuda0", reg_backend="torch",
            debug=False, seed=1))
        seconds = time.perf_counter() - t0
        prior = Path(cohort) / "s00" / "tmp" / "MNI_sub_probabilities.nii.gz"
        check(prior.exists() and len(index) > 0,
              "build_training_index registered the subject and built an "
              "index")
        informed = float((index.atlas[:, :14].sum(1) > 0).mean())
        check(informed > 0.5, f"the registered priors reach the sampled "
              f"centres ({informed:.3f} of them)")
        print(f"training priors-miss path: {len(index)} samples from one "
              f"subject registered on the card, {seconds:.3f} s; structure "
              f"prior mass at {informed:.3f} of the centres")
        out["reg_training_index_s"] = seconds
    finally:
        runtime.clear_records()
        if env is None:
            os.environ.pop("SUBCORT_ATLAS_DIR", None)
        else:
            os.environ["SUBCORT_ATLAS_DIR"] = env
        shutil.rmtree(root)
    return out


CLI_CFG = """\
[database]
train_folder = {folder}
inference_folder = {folder}
t1_name = T1.nii.gz
roi_name = gt_15_classes.nii.gz

[model]
name = {name}
mode = cuda0
batch_size = 128
patience = 5
max_epochs = 2
train_split = 0.25
net_verbose = 0
load_weights = False
debug = False

[tpu]
use_fcn = {use_fcn}
folder_pipeline = {pipeline}
reg_backend = torch
seed = 1
"""


def write_cfg(path: Path, folder: Path, name: str, use_fcn: bool = True,
              pipeline: bool = False) -> str:
    path.write_text(CLI_CFG.format(folder=folder, name=name, use_fcn=use_fcn,
                                   pipeline=pipeline))
    return str(path)


def run_cli(*argv) -> tuple:
    """``cli.main(argv)`` in this process, with the gather launch count set
    to 0 just before it; its stdout is echoed. Returns (stdout, launches,
    seconds); a non-zero return code fails the phase."""
    import io

    from subcort_tpu_torch import cli
    from subcort_tpu_torch.ops import gather_kernel

    buf = io.StringIO()
    gather_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    seconds = time.perf_counter() - t0
    launches = gather_kernel.LAUNCHES
    text = buf.getvalue()
    print(text, end="")
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return text, launches, seconds


def json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def cli_phase(torch, device, smi, image, atlas, roi, labels, params,
              stack, atlas_dir: Path) -> dict:
    """Phase 14: the command line on the card (see the module docstring)."""
    import warnings

    from subcort_tpu_torch import (NiftiImage, TriPlanarNet, TriPlanarSpec,
                                   build_training_index, init_params,
                                   load_nii, load_options, save_nii,
                                   save_theano_checkpoint,
                                   train_split_stratified)
    from subcort_tpu_torch.bench.scan import make_scan
    from subcort_tpu_torch.engine import candidate_centers
    from subcort_tpu_torch.engine.infer import DEFAULT_CHUNK
    from subcort_tpu_torch.engine.postprocess import post_process_segmentation
    from subcort_tpu_torch.engine.train import ADAM, train_step
    from subcort_tpu_torch.ops import gather_kernel
    from subcort_tpu_torch.ops.gather_kernel import (gather_triplanar_cuda,
                                                     prepare_gather_volume)
    from subcort_tpu_torch.registration import make_synthetic_cohort

    out = {}
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    env = os.environ.get("SUBCORT_ATLAS_DIR")
    try:
        # (a) train, evaluate, loo and infer on tests/test_trainqual.py's
        # phantom, the model at its full width
        cohort = root / "cohort"
        make_synthetic_cohort(str(cohort), n_subjects=3, shape=(48, 54, 44),
                              seed=1, noise=4.0, prior_error=0)
        nets = str(root / "nets")
        cfg = write_cfg(root / "configuration.cfg", cohort, "cli_smoke")
        options = load_options(cfg)
        index = build_training_index(options)
        train_idx, valid_idx = train_split_stratified(
            index.labels, options["train_split"])
        epochs = options["max_epochs"]
        steps = len(train_idx) // options["batch_size"] * epochs
        eval_batches = -(-len(valid_idx) // max(options["batch_size"],
                                                2048)) * epochs
        del index

        text, launches, seconds = run_cli("run", "--config", cfg,
                                          "--weights-path", nets)
        check(Path(nets, "cli_smoke", "cli_smoke.pkl").exists(),
              "cli run wrote the checkpoint")
        for sub in ("s00", "s01", "s02"):
            seg = load_nii(str(cohort / sub /
                               "out_subcortical_seg_prec.nii.gz")).data
            check(seg.shape == (48, 54, 44) and bool((seg != 0).any()),
                  f"cli run segmented {sub}")
        check(launches >= steps + eval_batches,
              f"cli run: gather launches {launches} >= train steps {steps} "
              f"+ eval batches {eval_batches}")
        print(f"cli run: {steps} train steps + {eval_batches} eval batches, "
              f"{launches} gather launches, {seconds:.3f} s")
        out.update(cli_run_launches=launches, cli_run_steps=steps,
                   cli_run_eval_batches=eval_batches, cli_run_s=seconds)

        text, _, seconds = run_cli("evaluate", "--config", cfg)
        lines = json_lines(text)
        check([l.get("subject") for l in lines[:3]] == ["s00", "s01", "s02"]
              and all("mean_dice" in l for l in lines[:3]),
              "cli evaluate: a line for each subject")
        check(len(lines) == 4 and lines[3]["n_subjects"] == 3,
              "cli evaluate: the cohort line")
        print(f"cli evaluate: cohort Dice {lines[3]['cohort_mean_dice']} "
              f"after 2 epochs, {seconds:.3f} s")
        out.update(cli_cohort_dice=lines[3]["cohort_mean_dice"])

        text, launches, seconds = run_cli("loo", "--config", cfg, "--folds",
                                          "s00,s01", "--weights-path", nets)
        lines = json_lines(text)
        check([l.get("fold") for l in lines[:2]] == ["s00", "s01"]
              and all(l["epochs"] == epochs for l in lines[:2]),
              "cli loo: a line for each fold")
        check(len(lines) == 3 and lines[2]["n_folds"] == 2,
              "cli loo: the summary line")
        check(launches > 0, f"cli loo trained through the kernel ({launches} "
              "gather launches)")
        print(f"cli loo: mean Dice {lines[2]['loo_mean_dice']}, {launches} "
              f"gather launches, {seconds:.3f} s")
        out.update(cli_loo_mean_dice=lines[2]["loo_mean_dice"],
                   cli_loo_launches=launches, cli_loo_s=seconds)

        patch_cfg = write_cfg(root / "patch.cfg", cohort, "cli_smoke",
                              use_fcn=False)
        chunks = 0
        for sub in ("s00", "s01", "s02"):
            t1 = np.asarray(load_nii(str(cohort / sub / "T1.nii.gz")).data)
            mask = np.asarray(load_nii(str(
                cohort / sub / "tmp" / "MNI_subcortical_mask.nii.gz")).data)
            chunks += -(-len(candidate_centers(t1, options, mask))
                        // DEFAULT_CHUNK)
        text, launches, seconds = run_cli("infer", "--config", patch_cfg,
                                          "--weights-path", nets)
        check(launches >= chunks, f"cli infer (patch engine): gather "
              f"launches {launches} >= chunks {chunks}")
        print(f"cli infer, use_fcn = False: {chunks} chunks, {launches} "
              f"gather launches, {seconds:.3f} s")
        out.update(cli_infer_launches=launches, cli_infer_chunks=chunks,
                   cli_infer_s=seconds)

        # the module entry point, once, in a process of its own: imports
        # listed by -X importtime
        trace_dir = root / "trace"
        proc = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", "subcort_tpu_torch.cli",
             "infer", "--config", patch_cfg, "--weights-path", nets,
             "--profile", str(trace_dir)],
            cwd=str(Path(__file__).resolve().parent), capture_output=True,
            text=True, timeout=600)
        check(proc.returncode == 0,
              f"python -m subcort_tpu_torch.cli infer --profile: rc "
              f"{proc.returncode}\n{proc.stderr[-4000:]}")
        modules = {line.rsplit("|", 1)[-1].strip()
                   for line in proc.stderr.splitlines()
                   if line.startswith("import time:")}
        bad = sorted(m for m in modules if m in ("jax", "subcort_tpu")
                     or m.startswith(("jax.", "subcort_tpu.")))
        check("torch" in modules and not bad,
              f"the CLI process imported torch and nothing of jax: {bad}")
        check(f"[profile] trace written to {trace_dir}" in proc.stdout,
              "the profile line")
        traces = sorted(trace_dir.glob("*.json"))
        check(len(traces) == 1, f"one trace file in {trace_dir}")
        events = json.loads(traces[0].read_text())["traceEvents"]
        kernels = [e.get("name", "") for e in events
                   if e.get("cat") == "kernel"]
        gathers = sum("gather_triplanar" in k for k in kernels)
        check(len(kernels) >= 1, "the trace holds CUDA kernel events")
        print(f"python -m subcort_tpu_torch.cli infer --profile: rc 0, "
              f"{len(modules)} modules imported, none of jax; trace "
              f"{traces[0].stat().st_size} bytes, {len(kernels)} CUDA kernel "
              f"events, {gathers} of them the gather kernel")
        out.update(cli_profile_kernel_events=len(kernels),
                   cli_profile_gather_events=gathers)

        # (b) the pipelined sweep over three MNI-sized scans (mni01 is the
        # phase-4 subject), serial and pipelined in turn
        folder = root / "mni"
        priors = root / "priors.nii.gz"
        save_nii(NiftiImage(atlas), str(priors))
        for i, seed in enumerate((1, 0, 2)):
            t1 = image if seed == 0 else make_scan(
                np.random.default_rng(seed))[0]
            sub = folder / f"mni{i:02d}"
            (sub / "tmp").mkdir(parents=True)
            save_nii(NiftiImage(t1), str(sub / "T1.nii.gz"))
            shutil.copyfile(priors, sub / "tmp" /
                            "MNI_sub_probabilities.nii.gz")
            save_nii(NiftiImage(roi.astype(np.uint8)),
                     str(sub / "tmp" / "MNI_subcortical_mask.nii.gz"))
        Path(nets, "mni").mkdir(parents=True)
        save_theano_checkpoint(params, str(Path(nets, "mni", "mni.pkl")))
        cfgs = {mode: write_cfg(root / f"{mode}.cfg", folder, "mni",
                                pipeline=(mode == "pipelined"))
                for mode in ("serial", "pipelined")}
        names = ("mni00", "mni01", "mni02")

        def segmented():
            return [np.asarray(load_nii(str(
                folder / n / "out_subcortical_seg_prec.nii.gz")).data)
                for n in names]

        walls = {"serial": [], "pipelined": []}
        first = None
        for mode in ("serial", "pipelined", "serial", "pipelined"):
            _, _, seconds = run_cli("infer", "--config", cfgs[mode],
                                    "--weights-path", nets)
            walls[mode].append(seconds)
            segs = segmented()
            if first is None:
                first = segs
            check(all(np.array_equal(a, b) for a, b in zip(segs, first)),
                  f"{mode} sweep: every volume equals the first serial run's")
            print(f"cli infer, 3 MNI-sized scans, {mode}: {seconds:.3f} s")
        print(f"folder sweep serial {walls['serial']} s, pipelined "
              f"{walls['pipelined']} s; os.cpu_count() {os.cpu_count()}; "
              f"{smi}")
        out.update(cli_sweep_serial_s=walls["serial"],
                   cli_sweep_pipelined_s=walls["pipelined"],
                   cli_sweep_cpu_count=os.cpu_count())

        # the second scan without priors: it registers on the loader
        # thread while the first segments; then the same sweep serial
        os.environ["SUBCORT_ATLAS_DIR"] = str(atlas_dir)
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        registering = {}
        for mode in ("pipelined", "serial"):
            shutil.rmtree(folder / "mni01" / "tmp")
            _, _, registering[mode] = run_cli("infer", "--config", cfgs[mode],
                                              "--weights-path", nets)
            after = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
            check(after == flags, f"{mode}: TF32 flags after the sweep "
                  f"{after} == before {flags}")
            check((folder / "mni01" / "tmp" /
                   "MNI_sub_probabilities.nii.gz").exists(),
                  f"{mode}: mni01 registered")
            segs = segmented()
            check(np.array_equal(segs[0], first[0])
                  and np.array_equal(segs[2], first[2]),
                  f"{mode}: mni00 and mni02 equal the serial run's while "
                  "mni01 registered")
            check(bool((segs[1] != 0).any()),
                  f"{mode}: mni01 segmented after registering")
            if mode == "pipelined":
                registered = segs[1]
        same = bool(np.array_equal(segs[1], registered))
        print(f"cli infer with mni01 registering (on the loader thread when "
              f"pipelined): pipelined {registering['pipelined']:.3f} s, "
              f"serial {registering['serial']:.3f} s; mni00 and mni02 equal "
              f"the serial run's; TF32 flags {after} as before; mni01's "
              f"labels equal in both: {same}")
        out.update(cli_sweep_registering_s=registering,
                   cli_sweep_registered_equal=same)

        # (c) the post-process's connected components on the card, on the
        # phase-7 labels of the phase-4 scan
        mask = roi.astype(np.uint8)
        results, times = {}, {}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for backend in ("scipy", "device", "scipy", "device"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results[backend] = post_process_segmentation(
                    "", labels, atlas_mask=mask, cc_backend=backend,
                    device=device)
                times.setdefault(backend, []).append(
                    time.perf_counter() - t0)
        fallback = [str(w.message) for w in caught if "sweep cap"
                    in str(w.message)]
        check(not fallback, f"device CC converged: {fallback}")
        check(np.array_equal(results["device"], results["scipy"]),
              "cc_backend = device == scipy on the MNI-sized labels")
        print(f"post_process_segmentation on the phase-4 scan's labels "
              f"({int((labels != 0).sum())} labelled voxels): device CC "
              f"{times['device']} s, scipy {times['scipy']} s (cold, warm); "
              f"array-equal, no fallback")
        out.update(cli_cc_device_s=times["device"],
                   cli_cc_scipy_s=times["scipy"])

        # (d) a train step at patch 40 on the phase-11 stack, border
        # centers among the batch: the plain gather on the card
        spec40 = TriPlanarSpec(patch_size=40, dropout_conv=0.0,
                               dropout_fc=0.0)
        init = init_params(spec40, torch.Generator().manual_seed(0))
        rng = np.random.default_rng(40)
        corners = [[s, x, y, z] for s in range(SUBJECTS)
                   for x in (0, SHAPE[0] - 1) for y in (0, SHAPE[1] - 1)
                   for z in (0, SHAPE[2] - 1)]
        rand = np.stack([rng.integers(0, SUBJECTS, TRAIN_BATCH)]
                        + [rng.integers(0, n, TRAIN_BATCH) for n in SHAPE], 1)
        centers = np.concatenate([corners, rand])[:TRAIN_BATCH]
        centers = torch.from_numpy(centers.astype(np.int32))
        lab = torch.from_numpy(rng.integers(0, 15, TRAIN_BATCH))
        at = torch.from_numpy(rng.random((TRAIN_BATCH, 15)).astype(np.float32))

        def step40(dev):
            net = TriPlanarNet.from_params(init, spec40, dev, trainable=True)
            opt = torch.optim.Adam(net.parameters(), **ADAM)
            vol = prepare_gather_volume(torch.from_numpy(stack).to(dev))
            views = gather_triplanar_cuda(vol, centers.to(dev), 40)
            loss = train_step(net, opt, views, lab.to(dev), at.to(dev))
            return float(loss), {k: v.cpu() for k, v in
                                 net.state_dict().items()
                                 if k.endswith((".mean", ".inv_std"))}

        gather_kernel.LAUNCHES = 0
        card = step40(device)
        check(gather_kernel.LAUNCHES == 0,
              f"patch 40 launched no kernel ({gather_kernel.LAUNCHES})")
        cpu = step40(torch.device("cpu"))
        rel = abs(card[0] - cpu[0]) / abs(cpu[0])
        ema = max(float((card[1][k] - cpu[1][k]).abs().max()) for k in cpu[1])
        check(math.isfinite(card[0]), f"patch 40 step: finite loss {card[0]}")
        check(rel <= CARD_VS_CPU_STEP and ema <= CARD_VS_CPU_STEP,
              f"patch 40 step card vs CPU: loss {rel:.3e}, EMA {ema:.3e} <= "
              f"{CARD_VS_CPU_STEP}")
        print(f"train step at patch 40, batch {TRAIN_BATCH} with "
              f"{len(corners)} corner centers, on the phase-11 stack: loss "
              f"{card[0]:.8f} on the card, {cpu[0]:.8f} on the CPU (relative "
              f"{rel:.3e}), BN EMA max |difference| {ema:.3e}; 0 gather "
              "launches")
        out.update(cli_patch40_loss_rel_diff=rel, cli_patch40_ema_diff=ema)
        out["cli_phase_s"] = time.perf_counter() - t_phase
        print(f"phase 14: {out['cli_phase_s']:.3f} s")
    finally:
        if env is None:
            os.environ.pop("SUBCORT_ATLAS_DIR", None)
        else:
            os.environ["SUBCORT_ATLAS_DIR"] = env
        shutil.rmtree(root)
    return out


def _dp_step_rank(rank, world, device, workdir, tag, dtypes,
                  timed_steps=0):
    """A rank of phase 15(b) and (c): one train step on this rank's share
    of the global batch (``workdir``'s seeded params, rows and generator
    seed; the stack memory-mapped) in each of ``dtypes`` ("float32",
    "float64"), each saved for the caller as ``step_{tag}_{rank}_{dtype}``;
    then, in float32 with cuDNN's default algorithms, ``timed_steps`` more
    steps timed by CUDA events (rank 0 saves their ms)."""
    import torch

    from subcort_tpu_torch import TriPlanarNet, TriPlanarSpec
    from subcort_tpu_torch.engine.train import ADAM, train_step
    from subcort_tpu_torch.ops.gather_kernel import (gather_triplanar_cuda,
                                                     prepare_gather_volume)

    work = Path(workdir)
    setup = torch.load(work / "setup.pt")
    rows = slice(rank * len(setup["labels"]) // world,
                 (rank + 1) * len(setup["labels"]) // world)
    volume = prepare_gather_volume(torch.from_numpy(
        np.load(work / "stack.npy", mmap_mode="c")).to(device))
    centers, labels, atlas = (setup[k][rows].to(device)
                              for k in ("centers", "labels", "atlas"))

    def make_step(dtype):
        net = TriPlanarNet.from_params(setup["params"], TriPlanarSpec(),
                                       device, trainable=True).to(dtype)
        opt = torch.optim.Adam(net.parameters(), **ADAM)
        gen = torch.Generator(device=device).manual_seed(setup["seed"])

        def step():
            views = tuple(v.to(dtype)
                          for v in gather_triplanar_cuda(volume, centers))
            return train_step(net, opt, views, labels, atlas.to(dtype), gen,
                              augment=True)
        return net, step

    for name in dtypes:
        net, step = make_step(getattr(torch, name))
        loss = float(step())
        torch.save({"loss": loss, "state": {k: v.cpu() for k, v in
                                            net.state_dict().items()},
                    "grads": {k: p.grad.cpu()
                              for k, p in net.named_parameters()}},
                   work / f"step_{tag}_{rank}_{name}.pt")
    if timed_steps:
        torch.backends.cudnn.deterministic = False
        ms = time_ms(torch, make_step(torch.float32)[1], timed_steps)
        if rank == 0:
            (work / f"step_ms_{tag}.json").write_text(json.dumps(ms))


def _multistep_ms(device, workdir, timed_steps, modes=("graphed", "eager")):
    """The multistep on phase 15's step (``workdir``'s seeded full-width
    params, generator seed and rows; augmentation on), ``timed_steps``
    steps a call, graphed and or eager (``modes``): {mode: CUDA-event ms
    and host enqueue ms per step, the capture's ms}."""
    import torch

    from subcort_tpu_torch import TriPlanarNet, TriPlanarSpec
    from subcort_tpu_torch.engine.train import (ADAM, DeviceAdam,
                                                make_train_multistep)
    from subcort_tpu_torch.ops.gather_kernel import prepare_gather_volume

    work = Path(workdir)
    setup = torch.load(work / "setup.pt")
    volume = prepare_gather_volume(torch.from_numpy(
        np.load(work / "stack.npy", mmap_mode="c")).to(device))
    stacked = [setup[k].to(device).expand(
        (timed_steps,) + tuple(setup[k].shape)).contiguous()
        for k in ("centers", "labels", "atlas")]
    times = {}
    for name in modes:
        eager = name == "eager"
        net = TriPlanarNet.from_params(setup["params"], TriPlanarSpec(),
                                       device, trainable=True)
        gen = torch.Generator(device=device).manual_seed(setup["seed"])
        with make_train_multistep(
                net, DeviceAdam(net.parameters(), **ADAM), volume, gen,
                net.spec.patch_size, timed_steps, augment=True,
                _eager=eager) as m:
            ms, host_ms = time_ms(torch, lambda: m(*stacked), iters=1,
                                  host=True)
            times[name] = {"ms": ms / timed_steps,
                           "enqueue_ms": host_ms / timed_steps,
                           "capture_ms": (None if eager
                                          else m.graphed.capture_ms)}
    return times


def _dp_nccl_rank(rank, world, device, workdir, timed_steps):
    """Phase 15(c)'s one NCCL rank: Trainer.fit through
    distributed.train_rank from the handoffs in ``workdir``'s
    ``fit_graphed`` and ``fit_eager`` (under the launcher's deterministic
    cuDNN flags); then :func:`_dp_step_rank`'s step (tag "nccl1"); then,
    with cuDNN's default algorithms, :func:`_multistep_ms` in the rank,
    saved as ``rank_step_ms.json``."""
    import torch

    from subcort_tpu_torch.parallel import distributed

    work = Path(workdir)
    for tag in ("fit_graphed", "fit_eager"):
        distributed.train_rank(rank, world, device, str(work / tag))
    _dp_step_rank(rank, world, device, workdir, "nccl1", ("float32",),
                  timed_steps)
    torch.backends.cudnn.deterministic = False
    (work / "rank_step_ms.json").write_text(json.dumps(
        _multistep_ms(device, workdir, timed_steps)))


def _dp_failing_capture_rank(rank, world, device, workdir):
    """Phase 15(c)'s NCCL rank whose step reads a value back, which the
    eager warm-up steps run and a capture refuses:
    distributed.train_rank on ``workdir``'s handoff, each call of the
    step adding one to ``workdir``'s ``calls`` file."""
    from subcort_tpu_torch.engine import train
    from subcort_tpu_torch.parallel import distributed

    calls = Path(workdir) / "calls"
    real = train.TrainMultistep.step

    def step(self):
        calls.write_text(str(int(calls.read_text()) + 1
                             if calls.exists() else 1))
        real(self)
        float(self.losses.sum())

    train.TrainMultistep.step = step
    distributed.train_rank(rank, world, device, workdir)


@contextlib.contextmanager
def recorded_launches(distributed):
    """Inside the block, every ``distributed.launch`` (also those that
    ``Trainer.fit`` makes) appends to the list it yields its target, ranks,
    the port of the store that the launcher hosted (None if it hosted
    none) and its seconds from the call to its return or raise."""
    launches = []
    launch, store = distributed.launch, distributed._rendezvous_store

    def recorded_launch(target, devices, *args, **kwargs):
        entry = {"target": target.__name__, "ranks": len(devices),
                 "port": None}
        launches.append(entry)
        t0 = time.perf_counter()
        try:
            return launch(target, devices, *args, **kwargs)
        finally:
            entry["s"] = time.perf_counter() - t0

    def recorded_store(world):
        hosted = store(world)
        launches[-1]["port"] = hosted.port
        return hosted

    distributed.launch = recorded_launch
    distributed._rendezvous_store = recorded_store
    try:
        yield launches
    finally:
        distributed.launch, distributed._rendezvous_store = launch, store


def _same(a, b) -> bool:
    """Nested dicts and lists of arrays and scalars equal, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def dp_phase(torch, device, smi, image, atlas, roi, params, spec, cands,
             index) -> dict:
    """Phase 15: the multi-device paths on the one card (see the module
    docstring), every launch recorded for (e)."""
    from subcort_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    with recorded_launches(distributed) as launches:
        out = dp_paths(torch, device, image, atlas, roi, params, spec, cands,
                       index)
    # (e) every launch through the launcher's own store
    for entry in launches:
        print(f"launch of {entry['target']} over {entry['ranks']} rank(s): "
              f"rendezvous port {entry['port']} (the launcher's store), "
              f"{entry['s']:.3f} s from launch to its return ({smi})")
    check([e["target"] for e in launches] == [
        "_dp_step_rank", "_dp_nccl_rank", "_dp_failing_capture_rank",
        "train_rank"] and all(e["port"] for e in launches),
          f"every launch hosted its own store: {launches}")
    out["dp_launches"] = launches
    out["dp_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 15: {out['dp_phase_s']:.3f} s")
    return out


def dp_paths(torch, device, image, atlas, roi, params, spec, cands,
             index) -> dict:
    """Phase 15 (a) to (d)."""
    import io

    from subcort_tpu_torch import (Options, Trainer, TrainingIndex,
                                   TriPlanarNet, init_params, segment_volume,
                                   train_split_stratified)
    from subcort_tpu_torch.engine.infer import (DEFAULT_CHUNK,
                                                _data_parallel_devices)
    from subcort_tpu_torch.models import fcn
    from subcort_tpu_torch.ops import gather_kernel
    from subcort_tpu_torch.parallel import distributed
    from subcort_tpu_torch.parallel.mesh import shard_rows
    from subcort_tpu_torch.utils.graphs import WARMUP

    out = {}
    two = [device, device]
    sel = tuple(cands.T)

    # (a) inference over [cuda:0, cuda:0], one host thread per entry
    net = TriPlanarNet.from_params(params, spec, device)

    def timed(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = segment_volume(net, image, atlas, cands, **kw)[0]
        return labels, time.perf_counter() - t0

    parts = shard_rows(len(cands), 2, align=DEFAULT_CHUNK)
    part_chunks = [-(-(p.stop - p.start) // DEFAULT_CHUNK) for p in parts]
    check(sum(part_chunks) == -(-len(cands) // DEFAULT_CHUNK),
          f"two parts of whole chunks {part_chunks}")
    seconds = {}
    for name, kw in (("patch", dict(engine="patch")),
                     ("dense_spmd", dict(engine="fcn", fcn_spmd=True)),
                     ("dense_fanout", dict(engine="fcn", fcn_spmd=False))):
        timed(**kw)  # warm-ups of both
        timed(devices=two, **kw)
        one, one_s = timed(**kw)
        gather_kernel.LAUNCHES = 0
        fcn.SLABS = 0
        got, two_s = timed(devices=two, **kw)
        launches, slabs = gather_kernel.LAUNCHES, fcn.SLABS
        differ = int((got[sel] != one[sel]).sum())
        print(f"two devices, {name}: {len(cands)} candidates, {differ} "
              f"labels differ from one device; {launches} gather launches, "
              f"{slabs} slab(s); segment_volume {two_s:.4f} s, one device "
              f"{one_s:.4f} s (warm; the same card either way)")
        check(differ == 0 and np.array_equal(got, one),
              f"two devices, {name}: labels == one device's")
        if name == "patch":
            check(launches == sum(part_chunks),
                  f"two-device patch launches {launches} == the parts' "
                  f"chunks {part_chunks}")
            out["dp_patch_launches"] = launches
            out["dp_patch_part_chunks"] = part_chunks
        else:
            check(launches == 0 and slabs >= 2,
                  f"two devices, {name}: no gather launch ({launches}), a "
                  f"slab per entry at least ({slabs})")
        seconds[name] = {"two_devices_s": two_s, "one_device_s": one_s}
    out["dp_inference_s"] = seconds
    del net

    # (b), (c) the synced step: two gloo ranks on the card, and one NCCL
    # rank, each against the one-process step on the same 2 x DP_BATCH rows
    # TriPlanarSpec() with its dropout, and augmentation on in the step:
    # the ranks draw the global batch's masks and keep their rows
    train_idx, _ = train_split_stratified(index.labels, 0.25)
    rows = train_idx[:2 * DP_BATCH]
    cap = min(DP_FIT_CAP, len(index))
    small_index = TrainingIndex(index.volumes, index.centers[:cap],
                                index.labels[:cap], index.atlas[:cap],
                                index.subject_names)
    t_idx, v_idx = train_split_stratified(small_index.labels, 0.25)

    def fit_options(name):
        return Options(experiment=name, mode="cuda0", batch_size=DP_BATCH,
                       max_epochs=DP_FIT_EPOCHS, patience=5, train_split=0.25,
                       net_verbose=1, load_weights=False, debug=False, seed=0)

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    cudnn = torch.backends.cudnn
    flags = cudnn.enabled, cudnn.deterministic, cudnn.benchmark
    try:
        np.save(root / "stack.npy", index.volumes)
        # (c)'s fits: the handoffs of a one-rank fit, graphed and eager,
        # and of the fit whose capture fails
        for tag, eager in (("fit_graphed", False), ("fit_eager", True),
                           ("fit_fails", False)):
            (root / tag).mkdir()
            Trainer(fit_options(tag), spec, weights_path=str(root / tag),
                    devices=[device]).hand_off(root / tag, small_index,
                                               DP_FIT_EPOCHS, eager)
        torch.save({"params": init_params(spec,
                                          torch.Generator().manual_seed(3)),
                    "seed": 17,
                    "centers": torch.from_numpy(index.centers[rows]),
                    "labels": torch.from_numpy(
                        index.labels[rows].astype(np.int64)),
                    "atlas": torch.from_numpy(index.atlas[rows])},
                   root / "setup.pt")
        # cuDNN's deterministic algorithms for the compared steps; the
        # launcher hands the ranks these flags
        cudnn.enabled, cudnn.deterministic, cudnn.benchmark = \
            True, True, False
        both = ("float32", "float64")
        t0 = time.perf_counter()
        backend2 = distributed.launch(
            _dp_step_rank, two, (str(root), "gloo2", both, DP_TIMED_STEPS),
            timeout=600)
        two_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        backend1 = distributed.launch(
            _dp_nccl_rank, [device], (str(root), DP_TIMED_STEPS),
            timeout=600)
        one_rank_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            distributed.launch(_dp_failing_capture_rank, [device],
                               (str(root / "fit_fails"),), timeout=600)
            failed = "the launch returned"
        except RuntimeError as e:
            failed = str(e)
        fails_s = time.perf_counter() - t0
        fails_calls = int((root / "fit_fails" / "calls").read_text())
        fails_finished = (root / "fit_fails" / "rank0.pkl").exists()
        nccl_fits = {}
        for tag in ("fit_graphed", "fit_eager"):
            with open(root / tag / "rank0.pkl", "rb") as fh:
                nccl_fits[tag] = pickle.load(fh)
        rank_step_ms = json.loads((root / "rank_step_ms.json").read_text())
        # the one-process step, in this process; then its multistep
        # graphed, beside the NCCL rank's (cuDNN's default algorithms)
        cudnn.deterministic = True
        _dp_step_rank(0, 1, device, str(root), "plain", both, DP_TIMED_STEPS)
        cudnn.deterministic = False
        one_process_ms = _multistep_ms(device, root, DP_TIMED_STEPS,
                                       ("graphed",))["graphed"]
        steps = {(tag, r, d): torch.load(root / f"step_{tag}_{r}_{d}.pt")
                 for tag, r, d in [("gloo2", 0, "float32"),
                                   ("gloo2", 1, "float32"),
                                   ("gloo2", 0, "float64"),
                                   ("gloo2", 1, "float64"),
                                   ("nccl1", 0, "float32"),
                                   ("plain", 0, "float32"),
                                   ("plain", 0, "float64")]}
        ms = {t: json.loads((root / f"step_ms_{t}.json").read_text())
              for t in ("gloo2", "nccl1", "plain")}
    finally:
        cudnn.enabled, cudnn.deterministic, cudnn.benchmark = flags
        shutil.rmtree(root)
    check(backend2 == "gloo" and backend1 == "nccl",
          f"backends: two ranks on one card {backend2}, one rank {backend1}")

    def compare(dtype):
        """The 2-rank step against the one-process step in ``dtype``:
        (loss relative difference, BN EMA and parameters after Adam max
        |difference|, gradients' largest difference over their tensor's
        largest gradient, the shares of gradient elements within
        DP_GRAD_TOL of it and of parameters within DP_STEP_TOL, the ranks'
        parameters equal)."""
        ranks = [steps["gloo2", r, dtype] for r in (0, 1)]
        plain = steps["plain", 0, dtype]
        loss = float(np.mean([r["loss"] for r in ranks]))
        facts = {"loss_rel": abs(loss - plain["loss"]) / abs(plain["loss"]),
                 "ema": 0.0, "params": 0.0, "grads": 0.0}
        g_ok = p_ok = total = 0
        for k, v in plain["state"].items():
            diff = float((ranks[0]["state"][k] - v).abs().max())
            if k.endswith((".mean", ".inv_std")):
                facts["ema"] = max(facts["ema"], diff)
                continue
            g, g2 = plain["grads"][k], ranks[0]["grads"][k]
            scale = float(g.abs().max()) or 1.0
            facts["params"] = max(facts["params"], diff)
            facts["grads"] = max(facts["grads"],
                                 float((g2 - g).abs().max()) / scale)
            g_ok += int(((g2 - g).abs() <= DP_GRAD_TOL * scale).sum())
            p_ok += int(((ranks[0]["state"][k] - v).abs()
                         <= DP_STEP_TOL).sum())
            total += g.numel()
        facts.update(grad_share=g_ok / total, param_share=p_ok / total,
                     same=all(torch.equal(ranks[0]["state"][k],
                                          ranks[1]["state"][k])
                              for k in plain["state"]))
        return facts

    f32, f64 = compare("float32"), compare("float64")
    # how far the one-process float32 step is from the float64 one
    exact, plain = steps["plain", 0, "float64"], steps["plain", 0, "float32"]
    own = max(float((plain["grads"][k].double() - g).abs().max())
              / (float(g.abs().max()) or 1.0)
              for k, g in exact["grads"].items())
    print(f"synced step, two gloo ranks on one card, {DP_BATCH} rows each "
          f"(augmentation and dropout on) vs one process at "
          f"{2 * DP_BATCH}, float64: loss relative difference "
          f"{f64['loss_rel']:.3e}, gradients' largest difference over "
          f"their tensor's largest {f64['grads']:.3e}, BN EMA "
          f"{f64['ema']:.3e}, parameters after Adam {f64['params']:.3e}; "
          f"float32: loss {f32['loss_rel']:.3e}, BN EMA {f32['ema']:.3e}, "
          f"{f32['grad_share']:.6f} of the gradient elements within "
          f"{DP_GRAD_TOL} of their tensor's largest and "
          f"{f32['param_share']:.6f} of the parameters within "
          f"{DP_STEP_TOL} (gradients {f32['grads']:.3e}, parameters "
          f"{f32['params']:.3e} at most); the one-process float32 step's "
          f"gradients differ from float64 by up to {own:.3e} of a "
          f"tensor's largest; the ranks' parameters equal: float32 "
          f"{f32['same']}, float64 {f64['same']}")
    for name, f in (("float32", f32), ("float64", f64)):
        check(f["loss_rel"] <= DP_STEP_TOL and f["ema"] <= DP_STEP_TOL
              and f["same"], f"2-rank {name} loss, BN EMA, ranks equal: {f}")
    check(f64["grads"] <= DP_F64_TOL and f64["params"] <= DP_STEP_TOL,
          f"2-rank float64 gradients and parameters: {f64}")
    nccl = steps["nccl1", 0, "float32"]
    bit = (nccl["loss"] == plain["loss"] and all(
        torch.equal(nccl[part][k], plain[part][k])
        for part in ("state", "grads") for k in plain[part]))
    print(f"synced step, one NCCL rank (world 1) vs the plain step: "
          f"bit-equal {bit} (loss {nccl['loss']!r} vs {plain['loss']!r})")
    check(bit, "the NCCL world-1 step == the plain step, bit for bit")
    print(f"train step ms (CUDA events, {DP_TIMED_STEPS} steps, cuDNN "
          f"default algorithms, augmentation and dropout on): two gloo "
          f"ranks on one card {ms['gloo2']:.4f} ms per global step of "
          f"{2 * DP_BATCH}; one NCCL rank at {2 * DP_BATCH} "
          f"{ms['nccl1']:.4f} ms; one process at {2 * DP_BATCH} "
          f"{ms['plain']:.4f} ms. The launches took {two_s:.3f} s (two "
          f"ranks) and {one_rank_s:.3f} s (one, with (c)'s two fits). Gloo "
          f"stages every collective through the host, and both ranks share "
          f"one card and the host's cores: no scaling is measured here")

    # (c) the NCCL rank's fit, graphed and eager
    graphed, eager = nccl_fits["fit_graphed"], nccl_fits["fit_eager"]
    steps1 = DP_FIT_EPOCHS * (len(t_idx) // DP_BATCH)
    want1 = steps1 + DP_FIT_EPOCHS * -(-len(v_idx) // max(DP_BATCH, 2048))

    def strip(history):
        return [{k: v for k, v in h.items() if k != "dur"} for h in history]

    same = strip(graphed["history"]) == strip(eager["history"]) and all(
        _same(graphed["state"][part], eager["state"][part])
        for part in ("params", "optimizer", "generator"))
    step = graphed["step"]
    print(f"fit in one NCCL rank (world 1, train_rank), {DP_FIT_EPOCHS} "
          f"epochs of {steps1 // DP_FIT_EPOCHS} steps of {DP_BATCH}: "
          f"graphed {json.dumps(step)}, eager {json.dumps(eager['step'])}; "
          f"epoch seconds graphed "
          f"{[round(h['dur'], 4) for h in graphed['history']]}, eager "
          f"{[round(h['dur'], 4) for h in eager['history']]}; gather "
          f"launches graphed {graphed['launches']}, eager "
          f"{eager['launches']} (steps + eval batches: {want1}); histories, "
          f"parameters, BN EMA, Adam state and generator bit-equal: {same}")
    check(step["graphed"] and step["warmup_steps"] == 2
          and step["replays"] == steps1 - 2 > 0 and step["capture_ms"] > 0,
          f"the NCCL rank's fit replays its captured step: {step}")
    check(not eager["step"]["graphed"],
          f"the NCCL rank's _eager fit runs the plain loop: {eager['step']}")
    check(graphed["launches"] == eager["launches"] == want1,
          f"NCCL rank launches {graphed['launches']}, {eager['launches']} "
          f"== {want1}")
    check(same, "the NCCL rank's graphed fit == its eager fit, bit for bit")
    print(f"NCCL rank whose step reads a value back: the launch raised "
          f"{failed!r} after {fails_s:.3f} s; the step ran {fails_calls} "
          f"time(s) ({WARMUP} warm-up steps and the refused capture); a fit "
          f"finished: {fails_finished}")
    check(failed.startswith("ranks [0] of 1") and fails_s < 75
          and fails_calls == WARMUP + 1 and not fails_finished,
          "an NCCL rank whose capture fails fails its launch at once")
    g, e = rank_step_ms["graphed"], rank_step_ms["eager"]
    print(f"rank step, one NCCL rank, {2 * DP_BATCH} rows, full width, "
          f"float32 (CUDA events over a call of {DP_TIMED_STEPS} steps, "
          f"cuDNN default algorithms; device ms, host enqueue ms per "
          f"step): graphed {g['ms']:.4f}, {g['enqueue_ms']:.4f}; eager "
          f"{e['ms']:.4f}, {e['enqueue_ms']:.4f}; capture "
          f"{g['capture_ms']:.3f} ms; one process graphed "
          f"{one_process_ms['ms']:.4f}, {one_process_ms['enqueue_ms']:.4f}")
    out.update(dp_nccl_fit_step=step, dp_nccl_fit_launches=graphed["launches"],
               dp_nccl_fit_steps=steps1,
               dp_nccl_fit_epoch_s={"graphed": [h["dur"] for h in
                                                graphed["history"]],
                                    "eager": [h["dur"] for h in
                                              eager["history"]]},
               dp_nccl_rank_step_ms=rank_step_ms,
               dp_one_process_graphed_step_ms=one_process_ms)
    out.update(dp_backends={"two_ranks_one_card": backend2,
                            "one_rank": backend1},
               dp_step_ms_two_ranks=ms["gloo2"],
               dp_step_ms_one_rank_nccl=ms["nccl1"],
               dp_step_ms_one_process=ms["plain"],
               dp_step_float32=f32, dp_step_float64=f64,
               dp_step_one_process_float32_vs_float64=own)

    # (b) a short fit over two gloo ranks on the card
    steps = len(t_idx) // (2 * DP_BATCH)
    evals = [-(-(p.stop - p.start) // max(DP_BATCH, 2048))
             for p in shard_rows(len(v_idx), 2)]
    want = [DP_FIT_EPOCHS * (steps + e) for e in evals]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dpfit_"))
    try:
        trainer = Trainer(fit_options("dp"), spec, weights_path=str(root),
                          devices=two)
        t0 = time.perf_counter()
        history = trainer.fit(small_index)
        fit_s = time.perf_counter() - t0
        files = sorted(p.name for p in (root / "dp").iterdir())
        lines = (root / "dp" / "dp_history.jsonl").read_text().splitlines()
    finally:
        shutil.rmtree(root)
    losses = [h["train_loss"] for h in history]
    print(f"fit over two gloo ranks on one card: {DP_FIT_EPOCHS} epochs of "
          f"{steps} global steps of {2 * DP_BATCH}, train losses {losses}, "
          f"epoch seconds {[round(h['dur'], 4) for h in history]} "
          f"({steps * 2 * DP_BATCH / history[-1]['dur']:.1f} samples/s in "
          f"the last), {fit_s:.3f} s with the ranks' start; gather "
          f"launches per rank {trainer.rank_launches} (steps + eval "
          f"batches: {want}); steps per rank {trainer.rank_steps}; files "
          f"{files}, {len(lines)} history lines")
    check(len(history) == DP_FIT_EPOCHS and bool(np.isfinite(losses).all())
          and losses[-1] < losses[0], f"finite, falling losses {losses}")
    check(trainer.rank_launches == want,
          f"launches per rank {trainer.rank_launches} == {want}")
    check(not any(r["graphed"] for r in trainer.rank_steps),
          f"the gloo ranks run eager steps: {trainer.rank_steps}")
    check(files == ["dp.pkl", "dp_history.jsonl", "dp_history.pkl",
                    "dp_state.pkl"] and len(lines) == DP_FIT_EPOCHS,
          f"only rank 0 wrote: {files}, {len(lines)} lines")
    out.update(dp_rank_launches=trainer.rank_launches,
               dp_gloo_rank_steps=trainer.rank_steps,
               dp_fit_steps=DP_FIT_EPOCHS * steps,
               dp_fit_epoch_s=[h["dur"] for h in history])

    # (d) the refusals: no second card here
    if torch.cuda.device_count() == 1:
        try:
            Trainer(Options(mode="cuda0", data_parallel=2, net_verbose=0),
                    spec, weights_path=tempfile.gettempdir())
            refused = False
        except ValueError as e:
            refused = "requested 2 devices, have 1" in str(e)
        check(refused, "Trainer(data_parallel=2) on one card raises "
              "ValueError")
        note = io.StringIO()
        with contextlib.redirect_stdout(note):
            got = _data_parallel_devices(Options(mode="cuda0",
                                                 data_parallel=2,
                                                 net_verbose=1))
        check(got == [device] and "only 1 device(s) present" in
              note.getvalue(), f"data_parallel=2 clamps to {got}: "
              f"{note.getvalue().strip()!r}")
        print(f"refusals: Trainer(data_parallel=2) raises ValueError; "
              f"inference clamps to {got} with the note "
              f"{note.getvalue().strip()!r}")
    return out


def bench_phase(torch, kind: str) -> dict:
    """Phase 16: the four benchmarks of ``subcort_tpu_torch/bench/`` through
    their ``main`` / ``run`` on the card (see the module docstring)."""
    import io
    from unittest import mock

    from subcort_tpu_torch.bench import reg, robust, train, trainqual
    from subcort_tpu_torch.engine.train import (Trainer,
                                                train_split_stratified)
    from subcort_tpu_torch.ops import gather_kernel

    out = {}
    t_phase = time.perf_counter()
    real_fit = Trainer.fit
    fits = []

    def fit_spy(self, index, max_epochs=None):
        history = real_fit(self, index, max_epochs)
        fits.append((index.labels, self.options["train_split"],
                     self.options["batch_size"], len(history)))
        return history

    def drive(name: str, fn) -> list:
        """One benchmark with the gather count at 0 just before it: its JSON
        lines; records its launches, the train steps + eval batches its
        fits took, and its seconds."""
        fits.clear()
        buf = io.StringIO()
        try:
            with mock.patch.object(Trainer, "fit", fit_spy), \
                    contextlib.redirect_stdout(buf):
                gather_kernel.LAUNCHES = 0
                t0 = time.perf_counter()
                fn()
                seconds = time.perf_counter() - t0
                launches = gather_kernel.LAUNCHES
        finally:
            print(buf.getvalue(), end="")
        need = 0
        for labels, split, batch, epochs in fits:
            t_idx, v_idx = train_split_stratified(labels, split)
            need += epochs * (len(t_idx) // batch
                              + -(-len(v_idx) // max(batch, 2048)))
        check(launches >= need, f"bench {name}: gather launches {launches} "
              f">= train steps + eval batches {need}")
        print(f"bench {name}: {seconds:.3f} s, {launches} gather launches "
              f"({need} train steps + eval batches in {len(fits)} fit(s))")
        out.update({f"bench_{name}_launches": launches,
                    f"bench_{name}_steps_and_evals": need,
                    f"bench_{name}_s": seconds})
        return json_lines(buf.getvalue())

    def keys_are(rec: dict, which: str) -> None:
        check(sorted(rec) == BENCH_KEYS[which],
              f"{which} line has the original's keys: {sorted(rec)}")

    # (a) bench/reg.py at its defaults (no tools/ here: the native rows
    # print the original's "skipped" line)
    for rec in drive("reg", lambda: reg.main(["--mode", "cuda0"])):
        which = ("reg_skipped" if "skipped" in rec else
                 "reg_affine" if rec.get("stage") == "affine" else "reg_ffd")
        keys_are(rec, which)
        check(which == "reg_skipped" or rec["passed"],
              f"bench reg row passed its floors: {rec}")
    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    # deterministic cuDNN algorithms, so the floors of (c) and (d) see the
    # same weights in every run
    cudnn.deterministic, cudnn.benchmark = True, False
    env = os.environ.get("SUBCORT_ATLAS_DIR")
    try:
        # (b) bench/train.py, MNI-sized stack, 4,096 samples, 2 epochs
        lines = drive("train", lambda: train.main(BENCH_TRAIN_ARGS
                                                  + ["--mode", "cuda0"]))
        check(len(lines) == 1, "bench train printed one JSON line")
        keys_are(lines[0], "train")
        check(lines[0]["device"] == kind and lines[0]["epochs"] == 2,
              f"bench train on the card, 2 epochs: {lines[0]}")
        # (c) bench/trainqual.py at tests/test_trainqual.py's size and
        # floors, on bench/trainqual.py's own cohort
        lines = drive("trainqual", lambda: trainqual.run(
            n_train=2, n_holdout=1, mode="cuda0", **BENCH_SMALL,
            **BENCH_TRAINQUAL_FLOORS))
        check(len(lines) == 1 and lines[0]["passed"],
              f"bench trainqual passed its floors: {lines}")
        keys_are(lines[0], "trainqual")
        # (d) bench/robust.py at tests/test_robustqual.py's recipe: the
        # default pipeline, registering on the card (reg_backend = torch)
        lines = drive("robust", lambda: robust.run(
            n_train=2, kinds=list(BENCH_ROBUST_FLOORS),
            sample_floors=BENCH_ROBUST_FLOORS, mode="cuda0", **BENCH_SMALL))
        check(len(lines) == 3 and lines[-1]["passed"],
              f"bench robust passed its floors: {lines}")
        for rec in lines[:-1]:
            keys_are(rec, "robust")
        keys_are(lines[-1], "robust_summary")
        out["bench_robust_dice"] = lines[-1]["per_degradation"]
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
        if env is None:
            os.environ.pop("SUBCORT_ATLAS_DIR", None)
        else:
            os.environ["SUBCORT_ATLAS_DIR"] = env
    out["bench_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 16: {out['bench_phase_s']:.3f} s")
    return out


def scan_phase(torch, device, kind, image, atlas, roi, rng, params,
               spec) -> dict:
    """Phase 17: the headline benchmark ``subcort_tpu_torch/bench/scan.py``
    through its ``run`` on the card (see the module docstring). ``rng`` is
    the generator that built the scan, so the oracle draws the original's
    voxels."""
    import io

    from subcort_tpu_torch.bench import scan
    from subcort_tpu_torch.engine.infer import DEFAULT_CHUNK
    from subcort_tpu_torch.models import (TriPlanarNet, load_theano_checkpoint,
                                          save_theano_checkpoint)
    from subcort_tpu_torch.ops import gather_kernel

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scan_") as tmp:
        ckpt = os.path.join(tmp, "seeded_init.pkl")
        save_theano_checkpoint(params, ckpt)
        net = TriPlanarNet.from_params(load_theano_checkpoint(ckpt), spec,
                                       device)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                gather_kernel.LAUNCHES = 0
                t0 = time.perf_counter()
                rec = scan.run(net, image, atlas, roi, rng, device=device,
                               repeats=SCAN_REPEATS, oracle_n=SCAN_ORACLE_N,
                               checkpoint=ckpt)
                seconds = time.perf_counter() - t0
                launches = gather_kernel.LAUNCHES
        finally:
            print(buf.getvalue(), end="")
    check(json_lines(buf.getvalue()) == [rec],
          "bench scan printed its one JSON line")
    check(sorted(rec) == BENCH_KEYS["scan"],
          f"scan line has the original's keys: {sorted(rec)}")
    chunks = math.ceil(rec["candidate_voxels"] / DEFAULT_CHUNK)
    check(rec["candidate_voxels"] == SCAN_CANDIDATES,
          f"bench scan candidates {rec['candidate_voxels']} == "
          f"{SCAN_CANDIDATES}")
    check(rec["est_flops_per_scan"] == SCAN_FLOPS,
          f"bench scan FLOPs {rec['est_flops_per_scan']} == {SCAN_FLOPS}")
    check(launches == chunks, f"bench scan: gather launches {launches} == "
          f"the patch canary's chunks {chunks}")
    check(rec["fcn_vs_patch_agreement"] >= MIN_DENSE_VS_PATCH,
          f"bench scan fcn_vs_patch_agreement "
          f"{rec['fcn_vs_patch_agreement']} >= {MIN_DENSE_VS_PATCH}")
    floor = (SCAN_ORACLE_N - 1) / SCAN_ORACLE_N
    check(rec["oracle_agreement"] is not None
          and rec["oracle_agreement"] >= floor,
          f"bench scan oracle_agreement {rec['oracle_agreement']} >= {floor}")
    floor = BF16_FAST_REFERENCE - BF16_SLACK
    check(rec["bf16_fast_agreement"] >= floor,
          f"bench scan bf16_fast_agreement {rec['bf16_fast_agreement']} >= "
          f"{floor} (JAX package {BF16_FAST_REFERENCE})")
    check(rec["device"] == kind and rec["checkpoint"] == "seeded_init",
          f"bench scan on the card, from the pickle: {rec['device']}, "
          f"{rec['checkpoint']}")
    peak = (989.4e12 if kind == "NVIDIA H100 80GB HBM3"
            else scan.peak_flops(kind))
    check(rec["peak_flops_assumed"] == peak,
          f"bench scan peak_flops_assumed {rec['peak_flops_assumed']} == "
          f"{peak} for {kind!r}")
    for key in ("value", "device_seconds", "bf16_device_seconds",
                "with_prob_maps_seconds", "bf16_fast_seconds"):
        check(math.isfinite(rec[key]) and rec[key] > 0,
              f"bench scan {key} {rec[key]} > 0")
    print(f"bench scan: {seconds:.3f} s, {launches} gather launches "
          f"({chunks} chunks), per scan {rec['value']} s (median "
          f"{rec['median_seconds']}), device {rec['device_seconds']} s, "
          f"bfloat16 device {rec['bf16_device_seconds']} s")
    out = {"bench_scan_launches": launches, "bench_scan_chunks": chunks,
           "bench_scan_s": seconds, "bench_scan_line": rec,
           "bench_scan_phase_s": time.perf_counter() - t_phase}
    print(f"phase 17: {out['bench_scan_phase_s']:.3f} s")
    return out


def main() -> None:
    t_start = time.perf_counter()
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
    from subcort_tpu_torch.bench.scan import make_scan
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

    # the generator goes on to phase 17, which draws its oracle sample
    scan_rng = np.random.default_rng(0)
    image, atlas, roi = make_scan(scan_rng)
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
    chunks = -(-len(cands) // DEFAULT_CHUNK)

    def centers_pass():
        forward_centers(net, volume, c_d, v_d, DEFAULT_CHUNK, False)

    with exact_float32():
        ms, enqueue_ms = time_ms(torch, centers_pass, iters=3, host=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            centers_pass()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        prof = profile_steps(torch, centers_pass, steps=2, parts=(),
                             per_call=chunks)
    forward_facts = {"ms": ms, "enqueue_ms": enqueue_ms, "wall_ms": wall_ms,
                     "chunks": chunks,
                     "kernels_per_chunk": prof["kernels_per_step"],
                     "device_busy_share": prof["device_busy_share"],
                     "profiled_device_ms": prof["device_ms_per_step"]
                     * chunks}
    print(f"forward_centers float32, {smi}: {len(cands)} centers in "
          f"{chunks} chunks of {DEFAULT_CHUNK}: {ms:.3f} ms by CUDA events, "
          f"{enqueue_ms:.3f} ms to enqueue, {wall_ms:.3f} ms wall (to a "
          f"synchronize); torch.profiler over 2 passes: "
          f"{prof['kernels_per_step']:.1f} kernels a chunk, "
          f"{forward_facts['profiled_device_ms']:.3f} ms of device work a "
          f"pass, busy share {prof['device_busy_share']:.4f}")
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

    # 11. training
    train, train_index = train_phase(torch, device, smi, image, atlas, roi)

    # 12. registration; its MNI-sized template and atlas stay for 14(b)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_work_"))
    try:
        reg = registration_phase(torch, device, image, atlas, roi, params,
                                 spec, work / "atlases")

        # 14. the command line (13, the results, is printed last)
        cli = cli_phase(torch, device, smi, image, atlas, roi, dl, params,
                        train_index.volumes, work / "atlases")
    finally:
        shutil.rmtree(work)

    # 15. the multi-device paths on the one card
    dp = dp_phase(torch, device, smi, image, atlas, roi, params, spec, cands,
                  train_index)

    # 16. the quality and training benchmarks
    bench = bench_phase(torch, kind)

    # 17. the headline benchmark
    bench.update(scan_phase(torch, device, kind, image, atlas, roi, scan_rng,
                            params, spec))

    # 13. results
    print(f"chip_smoke: {time.perf_counter() - t_start:.3f} s in all")
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
        "forward_centers": forward_facts,
        **train,
        **reg,
        **cli,
        **dp,
        **bench,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
