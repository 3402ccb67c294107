"""Leave-one-out cross-validation driver (port of subcort_tpu/engine/loo.py).

The reference's ``load_data`` exists to amortize volume loading across
leave-one-out folds (cnn_cort/base.py:14-15: "All the data is loaded in
memory, so for LOO experiments data is loaded only once"), but the
reference ships no driver composing the folds. Here it is a workflow of
its own (``subcort_tpu_torch.cli loo``): the cohort is loaded into one
:class:`TrainingIndex` (each volume read and normalized once), each fold's
training set is a row-mask view sharing that volume stack, and each fold
trains to early stop, then segments its held-out subject through the
inference path and scores Dice against the GT mask. Training and
segmentation run on the device ``options.mode`` names.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np

from subcort_tpu_torch.config import Options, select_device
from subcort_tpu_torch.engine.data import (TrainingIndex, build_training_index,
                                           list_training_subjects)
from subcort_tpu_torch.engine.infer import candidate_centers, segment_volume
from subcort_tpu_torch.engine.metrics import mean_dice
from subcort_tpu_torch.engine.train import Trainer
from subcort_tpu_torch.io import load_nii
from subcort_tpu_torch.models.importer import load_theano_checkpoint
from subcort_tpu_torch.models.triplanar import DEFAULT_SPEC, TriPlanarNet


def fold_view(index: TrainingIndex, held_out: str) -> TrainingIndex:
    """The fold's training set: every sample whose subject is not
    ``held_out``, sharing the full index's volume stack (no copy of the
    volumes, the reference's load-once economics, base.py:14-15)."""
    try:
        si = index.subject_names.index(held_out)
    except ValueError:
        raise ValueError(f"no subject named {held_out!r} in the index") from None
    keep = index.centers[:, 0] != si
    if not keep.any():
        raise ValueError(f"excluding {held_out!r} empties the training set")
    return dataclasses.replace(
        index, centers=index.centers[keep], labels=index.labels[keep],
        atlas=index.atlas[keep])


def evaluate_fold(net: TriPlanarNet, sub_dir: str, options: Options) -> float:
    """Segment one held-out subject through the inference path with
    ``net`` (on its own device) and return its mean structure Dice
    (classes 1..14; the GT boundary ring, class 15, counts as background,
    the reference's evaluation protocol)."""
    image = np.asarray(load_nii(os.path.join(
        sub_dir, options["t1_name"])).data)
    gt = np.asarray(load_nii(os.path.join(
        sub_dir, options["roi_name"])).data)
    gt = np.where(gt == 15, 0, gt).astype(np.uint8)
    atlas = np.asarray(load_nii(os.path.join(
        sub_dir, "tmp", "MNI_sub_probabilities.nii.gz")).data, np.float32)
    mask_p = os.path.join(sub_dir, "tmp", "MNI_subcortical_mask.nii.gz")
    mask = np.asarray(load_nii(mask_p).data) if os.path.exists(mask_p) else None
    centers = candidate_centers(image, options, mask)
    label_vol, _ = segment_volume(
        net, image, atlas, centers,
        engine="auto" if options.bool("use_fcn") else "patch",
        prior_dtype=np.dtype(options["prior_dtype"]),
        compute_dtype=options["compute_dtype"])
    return mean_dice(label_vol, gt)


def run_loo(options: Options, weights_path: str = "nets",
            folds: Optional[Sequence[str]] = None, augment: bool = False,
            sample_cap: Optional[int] = None, spec=None) -> dict:
    """Run the leave-one-out protocol over the training folder.

    For each fold (default: every subject), trains a fresh model on the
    cohort minus the held-out subject, under
    ``<weights_path>/<experiment>_fold_<name>/`` with the Trainer's full
    artifact set, then segments the held-out scan with the fold's *best*
    checkpoint and scores Dice. Volumes are loaded once for all folds.

    ``sample_cap`` (optional) takes a seeded uniform subsample of each
    fold's training rows, the JAX package's draw
    (``np.random.default_rng([seed, rows])``, so the same rows), which is
    order-independent and so safe with ``randomize_train=False`` too: a
    test-budget knob, not a product setting.

    Returns {"folds": {name: {dice, valid_accuracy, valid_loss, epochs}},
    "mean_dice": float}.
    """
    spec = spec or DEFAULT_SPEC
    device = select_device(options)
    subjects = list_training_subjects(options)
    by_name = {s.name: s for s in subjects}
    if folds is None:
        folds = [s.name for s in subjects]
    unknown = [f for f in folds if f not in by_name]
    if unknown:
        raise ValueError(f"unknown fold subject(s) {unknown}; "
                         f"have {sorted(by_name)}")

    # one load of the whole cohort (base.py:14-15 economics); per-fold
    # training sets are row masks over this index
    index = build_training_index(options, subjects=subjects)

    base_name = options["experiment"]
    results = {}
    for name in folds:
        fold_idx = fold_view(index, name)
        if sample_cap is not None and sample_cap < len(fold_idx):
            # a seeded subsample, not a prefix: with randomize_train=False
            # the rows are in subject order, and a prefix would drop later
            # subjects from every fold
            rng = np.random.default_rng([int(options["seed"]), len(fold_idx)])
            sel = np.sort(rng.permutation(len(fold_idx))[:sample_cap])
            fold_idx = dataclasses.replace(
                fold_idx, centers=fold_idx.centers[sel],
                labels=fold_idx.labels[sel], atlas=fold_idx.atlas[sel])
        fold_opts = dataclasses.replace(
            options, experiment=f"{base_name}_fold_{name}",
            load_weights=False)  # each fold trains from scratch
        if options["net_verbose"]:
            print(f"--> fold {name}: {len(fold_idx)} train samples")
        trainer = Trainer(fold_opts, spec=spec, weights_path=weights_path,
                          augment=augment)
        history = trainer.fit(fold_idx)
        best = min(history, key=lambda h: h["valid_loss"])

        # evaluate with the fold's best checkpoint through the
        # Theano-format round trip (SaveWeights(only_best) semantics)
        net = TriPlanarNet.from_params(
            load_theano_checkpoint(trainer.weights_file), spec, device)
        dice = evaluate_fold(net, os.path.dirname(by_name[name].t1_path),
                             options)
        results[name] = {
            "dice": round(float(dice), 4),
            "valid_accuracy": round(best["valid_accuracy"], 5),
            "valid_loss": round(best["valid_loss"], 5),
            "epochs": len(history),
        }
        if options["net_verbose"]:
            print(f"--> fold {name}: dice {dice:.4f} "
                  f"(valid_acc {best['valid_accuracy']:.4f})")

    return {"folds": results,
            "mean_dice": round(float(np.mean(
                [r["dice"] for r in results.values()])), 4)}
