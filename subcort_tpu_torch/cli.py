"""Command-line driver of the port (copy of subcort_tpu/cli.py): the
reference's ``train_model.py`` as a command-line tool.

Reference flow (train_model.py:1-83): read ``configuration.cfg`` -> load
options -> [optionally train] -> batch inference over the inference folder.
Both phases are subcommands; ``run`` trains, then segments. The same six
subcommands, flags, defaults and stdout lines (``-->`` lines; JSON lines
from ``evaluate`` and ``loo``) as the JAX package's CLI.

Usage:
    python -m subcort_tpu_torch.cli train  [--config configuration.cfg]
    python -m subcort_tpu_torch.cli infer  [--config configuration.cfg]
    python -m subcort_tpu_torch.cli run    [--config configuration.cfg]
    python -m subcort_tpu_torch.cli evaluate | loo | import-atlas ...

The device is the one ``[model] mode`` names (``select_device``: the card
unless ``mode = cpu``), checked once before any work; the engine, the
trainer and the leave-one-out driver each take that device from the same
options. Without a card and with another mode the command raises rather
than run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="subcort_tpu_torch",
        description="sub-cortical segmentation, PyTorch / CUDA port")
    p.add_argument("command",
                   choices=["train", "infer", "run", "evaluate", "loo",
                            "import-atlas"],
                   help="train: fit the model; infer: segment the inference "
                        "folder; run: both; evaluate: Dice of existing "
                        "segmentations vs ground truth; loo: leave-one-out "
                        "cross-validation over the train folder (volumes "
                        "loaded once, one model + held-out Dice per fold); "
                        "import-atlas: validate + install user-supplied MNI "
                        "atlas assets")
    p.add_argument("--config", default="configuration.cfg",
                   help="path to a reference-format configuration.cfg")
    p.add_argument("--template", default=None,
                   help="import-atlas: path to the MNI T1 template NIfTI")
    p.add_argument("--atlas", default=None,
                   help="import-atlas: path to the (X,Y,Z,15) probabilistic "
                        "subcortical atlas NIfTI (channel 14 = background)")
    p.add_argument("--atlas-dir", default=None,
                   help="import-atlas: install directory (default: the "
                        "package atlases/ directory)")
    p.add_argument("--weights-path", default="nets",
                   help="experiment artifact root (reference: nets/)")
    p.add_argument("--augment", action="store_true",
                   help="enable rotation/flip augmentation (the reference "
                        "defines but never activates it)")
    p.add_argument("--intensity-augment", type=float, default=None,
                   metavar="S",
                   help="train-time intensity-robustness augmentation "
                        "strength (overrides [tpu] intensity_augment; "
                        "0 = off = reference-exact)")
    p.add_argument("--folds", default=None,
                   help="loo: comma-separated held-out subject names "
                        "(default: every subject in the train folder)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace (CPU, and CUDA on "
                        "the card) of train / infer / run into DIR as a "
                        "Chrome trace (view in Perfetto)")
    return p


def _evaluate(options) -> None:
    """Per-subject Dice of the written segmentations against the GT masks,
    one JSON line each, then a cohort line."""
    import numpy as np

    from subcort_tpu_torch.engine import (dice_per_class, load_test_names,
                                          mean_dice)
    from subcort_tpu_torch.io import load_nii

    t1_names, subjects = load_test_names(options)
    seg_name = ("out_subcortical_seg_prec.nii.gz"
                if options.bool("post_process")
                else "out_subcortical_rawseg.nii.gz")
    all_means = []
    for path, sub in zip(t1_names, subjects):
        d = os.path.dirname(path)
        seg_p = os.path.join(d, seg_name)
        gt_p = os.path.join(d, options["roi_name"])
        if not (os.path.exists(seg_p) and os.path.exists(gt_p)):
            print(json.dumps({"subject": sub, "skipped": True}))
            continue
        seg = np.asarray(load_nii(seg_p).data)
        gt = np.asarray(load_nii(gt_p).data).astype(np.int32)
        gt = np.where(gt == 15, 0, gt)  # boundary-bg is background
        per = dice_per_class(seg, gt)
        m = mean_dice(seg, gt)
        all_means.append(m)
        print(json.dumps({"subject": sub, "mean_dice": round(m, 4),
                          "per_class": {k: round(v, 4)
                                        for k, v in per.items()}}))
    if all_means:
        print(json.dumps({"cohort_mean_dice":
                          round(float(np.mean(all_means)), 4),
                          "n_subjects": len(all_means)}))


def _load_weights(weights_path: str, experiment: str, load_theano):
    """The experiment's weights: ``<experiment>.pkl`` (the tri-planar
    network, Theano format), else ``<experiment>.pt``, a state dict saved
    by ``torch.save``: FastSurfer's, one a view (``{"axial": ...,
    "coronal": ..., "sagittal": ...}``), which the engine runs by the
    multi-view path, or SynthSeg's or SwinUNETR's (MONAI's names), which
    it runs by their paths."""
    stem = os.path.join(weights_path, experiment, experiment)
    if os.path.exists(stem + ".pkl") or not os.path.exists(stem + ".pt"):
        print("--> loading weights from", stem + ".pkl")
        return load_theano(stem + ".pkl")
    import torch
    print("--> loading state dicts from", stem + ".pt")
    return torch.load(stem + ".pt", map_location="cpu", weights_only=True)


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    if args.command == "import-atlas":
        # a file operation: no config, no device
        if not (args.template and args.atlas):
            print("import-atlas requires --template and --atlas",
                  file=sys.stderr)
            return 2
        from subcort_tpu_torch.registration.atlas import (
            AtlasValidationError, install_atlas)
        try:
            dest = install_atlas(args.template, args.atlas,
                                 dest_dir=args.atlas_dir)
        except AtlasValidationError as e:
            print(f"atlas validation failed: {e}", file=sys.stderr)
            return 1
        print(f"--> atlas assets installed into {dest}")
        return 0

    from subcort_tpu_torch.config import (load_options, print_options,
                                          select_device)

    options = load_options(args.config)
    if args.intensity_augment is not None:
        options["intensity_augment"] = args.intensity_augment
    select_device(options)  # before any work: no card, no run (mode = cpu)

    # a multi-host launch (SUBCORT_NUM_PROCESSES > 1) joins its process
    # group here; segment_folder then takes this process's share of the
    # subjects. One process: a no-op
    from subcort_tpu_torch.parallel.distributed import initialize
    initialize()

    from subcort_tpu_torch.utils.runtime import (enable_nan_checks,
                                                 profile_trace)
    if options.bool("debug_nans"):
        enable_nan_checks()

    from subcort_tpu_torch.engine import (SegmentationEngine, Trainer,
                                          build_training_index)
    from subcort_tpu_torch.models import load_theano_checkpoint

    if options["net_verbose"]:
        print_options(options)

    if args.command == "evaluate":
        _evaluate(options)
        return 0

    if args.command == "loo":
        # leave-one-out (reference base.py:14-15: the data is loaded once
        # for all folds): one JSON line per fold and a summary line
        from subcort_tpu_torch.engine import loo

        folds = ([f.strip() for f in args.folds.split(",") if f.strip()]
                 if args.folds else None)
        summary = loo.run_loo(options, weights_path=args.weights_path,
                              folds=folds, augment=args.augment)
        for name, rec in summary["folds"].items():
            print(json.dumps({"fold": name, **rec}))
        print(json.dumps({"loo_mean_dice": summary["mean_dice"],
                          "n_folds": len(summary["folds"])}))
        return 0

    with profile_trace(args.profile):
        if args.command in ("train", "run"):
            print("--> loading training data")
            index = build_training_index(options)
            trainer = Trainer(options, weights_path=args.weights_path,
                              augment=args.augment)
            print("--> training")
            trainer.fit(index)
            params = trainer.params
        else:
            params = _load_weights(args.weights_path, options["experiment"],
                                   load_theano_checkpoint)

        if args.command in ("infer", "run"):
            engine = SegmentationEngine(params, options)
            times = engine.segment_folder()
            for sub, minutes in times.items():
                print(f"--> scan {sub} segmented in {minutes:.2f} min")
    return 0


if __name__ == "__main__":
    sys.exit(main())
