"""Degraded-phantom robustness gate (port of the repo root's
``bench_robust.py``). It drives the port's FULL default pipeline through
phantom subjects degraded the way real acquisitions are: registration on a
cache miss, prior warping, candidate enumeration (dilated-ROI crop,
base.py:369), normalization (nonzero mean / std, base.py:146), dense
segmentation, post-processing and the output files (``test_scan``,
base.py:401-458).

  bias_field       smooth multiplicative ±30% B1 inhomogeneity
  rician           magnitude-reconstruction Rician noise
  intensity_remap  monotone nonlinear (gamma) cross-protocol transfer
  oblique          rotated sform + anisotropic voxels
  int16_scl        int16 storage with scl_slope/inter
  combined         all of the above at once

A model is first trained to early stop on the clean cohort (the port's
``Trainer``); each degraded subject is then segmented through the port's
``test_scan`` with the port's DEFAULT ``Options`` (no cost, backend or
engine override; only ``mode``, which ``--mode`` sets) and scored against
its known GT. The port's default registration runs on the card
(``reg_backend = torch``, NMI): that is the port's out-of-the-box
pipeline, and the one default where it differs from the JAX package,
whose ``native`` default drives NiftyReg-style C++ tools on the CPU.

    python -m subcort_tpu_torch.bench.robust [--shape XxYxZ]
        [--train-subjects N] [--max-epochs N] [--patience N] [--seed N]
        [--kinds a,b] [--intensity-augment S] [--mode cpu]

Prints one JSON line per degradation plus a summary line, the original's
keys; asserts the per-degradation Dice floors.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np

# the original's per-degradation floors, set just below its measured r5
# values; "clean" is the undegraded control (same subject, same pipeline)
FLOORS = {
    "clean": 0.93,
    "bias_field": 0.88,
    "rician": 0.88,
    "intensity_remap": 0.88,
    "oblique": 0.85,
    "int16_scl": 0.93,
    "combined": 0.75,
}


def train_model(root: str, options, n_train: int, shape, max_epochs: int,
                patience: int, seed: int, intensity_augment: float = 0.0):
    """Fit the port's Trainer on a clean cohort; returns the best
    checkpoint as a ``TriPlanarNet`` on the trainer's device."""
    from subcort_tpu_torch.engine.data import build_training_index
    from subcort_tpu_torch.engine.train import Trainer
    from subcort_tpu_torch.models import TriPlanarNet, load_theano_checkpoint
    from subcort_tpu_torch.registration.atlas import make_synthetic_cohort

    cohort = os.path.join(root, "train_cohort")
    make_synthetic_cohort(cohort, n_subjects=n_train, shape=shape, seed=seed)
    topts = dataclasses.replace(options, train_folder=cohort,
                                max_epochs=max_epochs, patience=patience,
                                load_weights=False,
                                intensity_augment=intensity_augment)
    index = build_training_index(topts)
    print(f"--> training on {n_train} clean subjects, {len(index)} samples",
          flush=True)
    trainer = Trainer(topts, weights_path=os.path.join(root, "nets"))
    history = trainer.fit(index)
    best = min(history, key=lambda h: h["valid_loss"])
    print(f"--> best epoch {best['epoch']}: valid_acc "
          f"{best['valid_accuracy']:.4f}", flush=True)
    return TriPlanarNet.from_params(load_theano_checkpoint(
        trainer.weights_file), trainer.spec, trainer.device)


def evaluate_degraded(net, sub_dir: str, options) -> dict:
    """Run the COMPLETE per-scan pipeline (``test_scan``: register on a
    cache miss -> segment -> post-process -> write files) with ``net`` and
    score the written post-processed segmentation against the subject's
    GT."""
    from subcort_tpu_torch.engine.infer import test_scan
    from subcort_tpu_torch.engine.metrics import mean_dice
    from subcort_tpu_torch.io import load_nii

    scan = os.path.join(sub_dir, options["t1_name"])
    t0 = time.time()
    test_scan(net, scan, options)
    secs = time.time() - t0
    seg = np.asarray(load_nii(os.path.join(
        sub_dir, "out_subcortical_seg_prec.nii.gz")).data)
    gt = np.asarray(load_nii(os.path.join(
        sub_dir, options["roi_name"])).data)
    gt = np.where(gt == 15, 0, gt).astype(np.uint8)
    return {"dice": mean_dice(seg, gt), "seconds": round(secs, 2)}


def run(shape=(64, 72, 60), n_train: int = 4, max_epochs: int = 30,
        patience: int = 8, seed: int = 0, root: str = None,
        kinds=None, sample_floors=FLOORS, train_params=None,
        intensity_augment: float = 0.0, mode: str = "tpu"):
    """``train_params``, a ``TriPlanarNet`` (what :func:`train_model`
    returns), skips the training."""
    from subcort_tpu_torch.config import Options, select_device
    from subcort_tpu_torch.registration.atlas import (DEGRADATIONS,
                                                      make_degraded_subject,
                                                      make_synthetic_atlas)

    select_device(Options(mode=mode))  # no card: raise before any work
    tmp_ctx = tempfile.TemporaryDirectory() if root is None else None
    root = root or tmp_ctx.name
    atlas_dir = os.path.join(root, "atlases")
    make_synthetic_atlas(atlas_dir, shape=shape, seed=seed)
    # the registration subsystem resolves assets through this env hook
    os.environ["SUBCORT_ATLAS_DIR"] = atlas_dir

    # DEFAULT config: no registration backend/cost/engine overrides — the
    # point of the gate is that the out-of-the-box pipeline survives
    options = Options(experiment="robust", seed=seed, net_verbose=0,
                      debug=False, batch_size=128, train_split=0.25,
                      mode=mode)

    net = (train_params if train_params is not None
           else train_model(root, options, n_train, shape, max_epochs,
                            patience, seed,
                            intensity_augment=intensity_augment))

    kinds = list(kinds) if kinds else ["clean"] + list(DEGRADATIONS)
    results, records = {}, []
    holdout_root = os.path.join(root, "degraded")
    for kind in kinds:
        sub = make_degraded_subject(holdout_root, atlas_dir, kind,
                                    shape=shape, seed=seed)
        rec = evaluate_degraded(net, sub, options)
        floor = sample_floors.get(kind, 0.0)
        rec = {"metric": "robust_pipeline_dice", "degradation": kind,
               "value": round(rec["dice"], 4), "unit": "dice",
               "pipeline_seconds": rec["seconds"], "dice_floor": floor,
               "passed": bool(rec["dice"] >= floor)}
        results[kind] = rec["value"]
        records.append(rec)
        print(json.dumps(rec), flush=True)

    summary = {"metric": "robust_pipeline_dice_summary",
               "value": round(float(np.mean(list(results.values()))), 4),
               "unit": "dice", "per_degradation": results,
               "volume_shape": list(shape),
               "intensity_augment": intensity_augment,
               "passed": all(r["passed"] for r in records)}
    print(json.dumps(summary), flush=True)
    if tmp_ctx is not None:
        tmp_ctx.cleanup()
    assert summary["passed"], (
        "robustness gate FAILED: " +
        ", ".join(f"{r['degradation']}={r['value']} (floor {r['dice_floor']})"
                  for r in records if not r["passed"]))
    return records, summary


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m subcort_tpu_torch.bench.robust")
    ap.add_argument("--shape", default="64x72x60")
    ap.add_argument("--train-subjects", type=int, default=4)
    ap.add_argument("--max-epochs", type=int, default=30)
    ap.add_argument("--patience", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kinds", default=None,
                    help="comma-separated degradations (default: all)")
    ap.add_argument("--intensity-augment", type=float, default=0.0,
                    help="train with the [tpu] intensity_augment knob at "
                         "this strength (the gate's DEFAULT stays 0.0 — "
                         "this option measures the opt-in hardening)")
    ap.add_argument("--mode", default="tpu",
                    help="Options.mode: the card by default (tpu, cuda0, "
                         "...); cpu runs on the CPU")
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.shape.split("x"))
    kinds = args.kinds.split(",") if args.kinds else None
    return run(shape=shape, n_train=args.train_subjects,
               max_epochs=args.max_epochs, patience=args.patience,
               seed=args.seed, kinds=kinds,
               intensity_augment=args.intensity_augment, mode=args.mode)


if __name__ == "__main__":
    main()
