#!/usr/bin/env python3
"""bfloat16 vs float32 labels on trained weights, on the card.

    python3 scripts/torch_trainqual_bf16.py [--root DIR]

Runs ``subcort_tpu_torch.bench.trainqual`` at its defaults (6 + 2 subjects
of 96x108x90, up to 50 epochs, patience 10) in ``--root`` (kept, so the
best checkpoint and the cohort stay), then segments each held-out subject
with that checkpoint through ``segment_volume`` in float32 and with
``compute_dtype = bfloat16``, in both engines, and prints one JSON line per
subject and engine: the label agreement on every candidate against the
0.999 bound of bfloat16 and narrow wire dtypes. Exits non-zero when the
trainqual run missed its floors (after the agreement lines). Imports no
jax; needs a card.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BF16_BOUND = 0.999


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="working directory (default: a temporary one)")
    args = ap.parse_args(argv)

    from subcort_tpu_torch.bench import trainqual
    from subcort_tpu_torch.config import Options, select_device
    from subcort_tpu_torch.engine.data import list_training_subjects
    from subcort_tpu_torch.engine.infer import candidate_centers, \
        segment_volume
    from subcort_tpu_torch.io import load_nii
    from subcort_tpu_torch.models import TriPlanarNet, load_theano_checkpoint

    root = args.root or tempfile.mkdtemp(prefix="trainqual_bf16_")
    os.makedirs(root, exist_ok=True)
    device = select_device(Options())
    failure = None
    try:
        trainqual.run(root=root)
    except AssertionError as e:  # the floors: report, then the agreement
        failure = e
    options = Options(train_folder=os.path.join(root, "cohort"))
    holdout = list_training_subjects(options)[6:]
    net = TriPlanarNet.from_params(load_theano_checkpoint(os.path.join(
        root, "nets", "trainqual", "trainqual.pkl")), device=device)
    worst = 1.0
    for sub in holdout:
        d = os.path.dirname(sub.t1_path)
        image = np.asarray(load_nii(sub.t1_path).data)
        atlas = np.asarray(load_nii(os.path.join(
            d, "tmp", "MNI_sub_probabilities.nii.gz")).data, np.float32)
        mask = np.asarray(load_nii(os.path.join(
            d, "tmp", "MNI_subcortical_mask.nii.gz")).data)
        centers = candidate_centers(image, options, mask)
        sel = tuple(centers.T)
        for engine in ("fcn", "patch"):
            labels, seconds = {}, {}
            for dtype in ("float32", "bfloat16"):
                segment_volume(net, image, atlas, centers, engine=engine,
                               compute_dtype=dtype)  # first calls
                t0 = time.perf_counter()
                labels[dtype] = segment_volume(
                    net, image, atlas, centers, engine=engine,
                    compute_dtype=dtype)[0][sel]
                seconds[dtype] = time.perf_counter() - t0
            agree = float(np.mean(labels["float32"] == labels["bfloat16"]))
            worst = min(worst, agree)
            print(json.dumps({
                "metric": "bf16_vs_f32_label_agreement", "subject": sub.name,
                "engine": engine, "value": agree,
                "candidates": int(len(centers)),
                "mismatches": int((labels["float32"]
                                   != labels["bfloat16"]).sum()),
                "bound": BF16_BOUND, "passed": agree >= BF16_BOUND,
                "seconds": seconds}), flush=True)
    print(json.dumps({"metric": "bf16_vs_f32_label_agreement_min",
                      "value": worst, "bound": BF16_BOUND,
                      "passed": worst >= BF16_BOUND,
                      "trainqual_passed": failure is None}), flush=True)
    if failure is not None:
        print(f"trainqual: {failure}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
