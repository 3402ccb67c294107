#!/usr/bin/env python
"""The JAX package's own fast-profile label agreement on the headline
benchmark's MNI scan: the reference figure that chip_smoke.py records as
``BF16_FAST_REFERENCE`` for the port's ``bf16_fast_agreement``.

The port's seeded full-width weights (``init_params`` with a torch
generator seeded 0, what ``subcort_tpu_torch/bench/scan.py`` and
chip_smoke.py run) reach the JAX package through a reference-format
pickle (the port's ``save_theano_checkpoint``, the JAX package's
``load_theano_checkpoint``). The JAX package then segments
``make_scan(default_rng(0))`` at the candidates as bench.py does: the
exact profile (float32, uint16 priors) and the fast one (bfloat16, uint8
priors). Prints one JSON line with the agreement on every candidate,
bench.py's ``bf16_fast_agreement`` unrounded.

    JAX_PLATFORMS=cpu python scripts/jax_scan_fast_agreement.py

Runs on the CPU: about 4 GB and a few minutes.
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy import ndimage  # noqa: E402

from subcort_tpu.engine.infer import segment_volume  # noqa: E402
from subcort_tpu.models import load_theano_checkpoint  # noqa: E402
from subcort_tpu_torch.bench.scan import make_scan  # noqa: E402
from subcort_tpu_torch.models import (DEFAULT_SPEC, init_params,  # noqa: E402
                                      save_theano_checkpoint)


def main():
    image, atlas, roi = make_scan(np.random.default_rng(0))
    centers = np.stack(np.nonzero(ndimage.binary_dilation(
        roi, iterations=10)), axis=1).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seeded.pkl")
        save_theano_checkpoint(
            init_params(DEFAULT_SPEC, torch.Generator().manual_seed(0)), path)
        params = load_theano_checkpoint(path)
    exact, _ = segment_volume(params, image, atlas, centers)
    fast, _ = segment_volume(params, image, atlas, centers,
                             compute_dtype="bfloat16", prior_dtype=np.uint8)
    sel = centers[:, 0], centers[:, 1], centers[:, 2]
    print(json.dumps({
        "candidate_voxels": int(len(centers)),
        "bf16_fast_agreement": float(np.mean(exact[sel] == fast[sel])),
        "mismatches": int((exact[sel] != fast[sel]).sum()),
    }))


if __name__ == "__main__":
    main()
