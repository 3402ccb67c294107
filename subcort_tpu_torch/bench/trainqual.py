"""Training-quality gate (port of the repo root's
``bench_trainqual.py``): fit to early stop on a synthetic cohort, then
segment held-out subjects and report the cohort mean Dice and the
validation accuracy.

The reference's only quantitative quality record is its shipped training
history — valid_accuracy 0.94998 at the best epoch
(nets/miccai2012_v1/miccai2012_v1_history.pkl) — plus the paper's Dice
claims. This gate proves that the port's *training stack* (balanced
boundary sampling, the gather kernel in every step, Adam, BN EMA, early
stopping, the checkpoint round trip) converges to a model that segments,
not merely that the loss falls. The cohort is the synthetic phantom family
(``registration/atlas.py``): subjects are shifted / intensity-jittered /
noised templates whose priors carry an extra voxel of registration-error
jitter, so the model must fuse intensity and prior rather than copy
channel 14.

    python -m subcort_tpu_torch.bench.trainqual [--train-subjects N]
        [--holdout-subjects N] [--shape XxYxZ] [--max-epochs N]
        [--patience N] [--batch N] [--seed N] [--mode cpu]

Prints ONE JSON line, the original's keys:
  {"metric": "train_quality_cohort_dice", "value": N, "unit": "dice",
   "valid_accuracy": N, "passed": bool, ...}

Floors (asserted, reported in the JSON), the original's: cohort mean Dice
>= 0.97, best-epoch valid_accuracy >= 0.995.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

DICE_FLOOR = 0.97
VALID_ACC_FLOOR = 0.995
REFERENCE_VALID_ACC = 0.94998  # shipped history, best epoch 42


def evaluate_holdout(net, sub_dir: str, options) -> float:
    """Segment one held-out subject through the port's inference path with
    ``net`` (a ``TriPlanarNet``, on its own device) and return its mean
    structure Dice (classes 1..14; GT ring class 15 counts as background,
    as in the reference's evaluation protocol)."""
    from subcort_tpu_torch.engine.infer import candidate_centers, \
        segment_volume
    from subcort_tpu_torch.engine.metrics import mean_dice
    from subcort_tpu_torch.io import load_nii

    image = np.asarray(load_nii(os.path.join(sub_dir, "T1.nii.gz")).data)
    gt = np.asarray(load_nii(os.path.join(sub_dir,
                                          "gt_15_classes.nii.gz")).data)
    gt = np.where(gt == 15, 0, gt).astype(np.uint8)
    atlas = np.asarray(load_nii(os.path.join(
        sub_dir, "tmp", "MNI_sub_probabilities.nii.gz")).data, np.float32)
    mask = np.asarray(load_nii(os.path.join(
        sub_dir, "tmp", "MNI_subcortical_mask.nii.gz")).data)
    centers = candidate_centers(image, options, mask)
    label_vol, _ = segment_volume(net, image, atlas, centers)
    return mean_dice(label_vol, gt)


def run(n_train: int = 6, n_holdout: int = 2, shape=(96, 108, 90),
        max_epochs: int = 50, patience: int = 10, batch_size: int = 128,
        seed: int = 0, root: str = None, mode: str = "tpu",
        dice_floor: float = DICE_FLOOR,
        valid_acc_floor: float = VALID_ACC_FLOOR):
    """Fit, reload the best checkpoint, segment the held-out subjects and
    assert the floors (the original's by default; a smoke run at a smaller
    recipe passes its own)."""
    from subcort_tpu_torch.bench.train import device_name
    from subcort_tpu_torch.config import Options, select_device
    from subcort_tpu_torch.engine.data import build_training_index, \
        list_training_subjects
    from subcort_tpu_torch.engine.train import Trainer
    from subcort_tpu_torch.models import TriPlanarNet, load_theano_checkpoint
    from subcort_tpu_torch.registration.atlas import make_synthetic_cohort

    select_device(Options(mode=mode))  # no card: raise before any work
    tmp_ctx = tempfile.TemporaryDirectory() if root is None else None
    root = root or tmp_ctx.name
    cohort_dir = os.path.join(root, "cohort")
    make_synthetic_cohort(cohort_dir, n_subjects=n_train + n_holdout,
                          shape=shape, seed=seed)

    options = Options(experiment="trainqual", train_folder=cohort_dir,
                      max_epochs=max_epochs, patience=patience,
                      batch_size=batch_size, train_split=0.25,
                      net_verbose=1, load_weights=False, debug=False,
                      seed=seed, mode=mode)
    subjects = list_training_subjects(options)
    train_subjects = subjects[:n_train]
    holdout_subjects = subjects[n_train:]

    index = build_training_index(options, subjects=train_subjects)
    print(f"--> cohort: {n_train} train + {n_holdout} holdout, "
          f"{len(index)} samples, shape {shape}", flush=True)

    t0 = time.time()
    trainer = Trainer(options, weights_path=os.path.join(root, "nets"))
    history = trainer.fit(index)
    train_seconds = time.time() - t0

    best = min(history, key=lambda h: h["valid_loss"])

    # evaluate with the *best* checkpoint (SaveWeights(only_best)
    # semantics): reload it through the Theano-format round trip
    net = TriPlanarNet.from_params(load_theano_checkpoint(
        trainer.weights_file), trainer.spec, trainer.device)

    dices = {}
    for sub in holdout_subjects:
        d = evaluate_holdout(net, os.path.dirname(sub.t1_path), options)
        dices[sub.name] = round(float(d), 4)
    cohort_dice = float(np.mean(list(dices.values())))

    passed = (cohort_dice >= dice_floor
              and best["valid_accuracy"] >= valid_acc_floor)
    result = {
        "metric": "train_quality_cohort_dice",
        "value": round(cohort_dice, 4),
        "unit": "dice",
        "vs_baseline": round(best["valid_accuracy"] / REFERENCE_VALID_ACC, 4),
        "valid_accuracy": round(best["valid_accuracy"], 5),
        "valid_loss": round(best["valid_loss"], 5),
        "best_epoch": best["epoch"],
        "epochs_run": len(history),
        "early_stopped": len(history) < max_epochs,
        "per_subject_dice": dices,
        "n_train_subjects": len(train_subjects),
        "n_samples": len(index),
        "train_seconds": round(train_seconds, 1),
        "dice_floor": dice_floor,
        "valid_acc_floor": valid_acc_floor,
        "passed": passed,
        "device": device_name(trainer.device),
    }
    print(json.dumps(result), flush=True)
    if tmp_ctx is not None:
        tmp_ctx.cleanup()
    assert passed, (f"training-quality gate FAILED: cohort_dice="
                    f"{cohort_dice:.4f} (floor {dice_floor}), valid_accuracy="
                    f"{best['valid_accuracy']:.4f} (floor {valid_acc_floor})")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m subcort_tpu_torch.bench.trainqual")
    ap.add_argument("--train-subjects", type=int, default=6)
    ap.add_argument("--holdout-subjects", type=int, default=2)
    ap.add_argument("--shape", default="96x108x90")
    ap.add_argument("--max-epochs", type=int, default=50)
    ap.add_argument("--patience", type=int, default=10)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", default="tpu",
                    help="Options.mode: the card by default (tpu, cuda0, "
                         "...); cpu runs on the CPU")
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.shape.split("x"))
    return run(n_train=args.train_subjects, n_holdout=args.holdout_subjects,
               shape=shape, max_epochs=args.max_epochs,
               patience=args.patience, batch_size=args.batch, seed=args.seed,
               mode=args.mode)


if __name__ == "__main__":
    main()
