"""Faults of the cell ``scan_swinunetr``, planted as ``faults.py``'s are
(``fault(setattr)``).

    python3 benchmark/faults_swinunetr.py --workload scan_swinunetr \
        --seeds ... [--control ...] [--fault NAME --faulted ...]

is ``calibrate.py`` with these faults among its choices; ``--control``
reads the TF32 control.
"""

from __future__ import annotations

import itertools
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def shift_mask_left_out(setattr_):
    """Shifted blocks attend across the rolled grid's seams."""
    from subcort_tpu_torch.models import swinunetr
    setattr_(swinunetr, "shift_mask", lambda padded, w, shift, device: None)


def position_bias_left_out(setattr_):
    """The relative position bias left out of every attention."""
    from subcort_tpu_torch.models import swinunetr
    setattr_(swinunetr.WindowAttention, "bias", lambda self, n: 0.0)


def roll_not_undone(setattr_):
    """A shifted block's tokens left rolled after the attention."""
    from subcort_tpu_torch.models import swinunetr
    real = swinunetr._roll
    setattr_(swinunetr, "_roll",
             lambda x, shift, sign: real(x, shift, sign) if sign < 0 else x)


def uniform_blend(setattr_):
    """The windows blended with uniform weights, not the Gaussian."""
    import torch

    from subcort_tpu_torch.engine import swinunetr
    setattr_(swinunetr, "gaussian",
             lambda roi, sigma_scale=0.125, device=None: torch.ones(
                 (roi,) * 3, device=device))


def merge_in_raster_order(setattr_):
    """PatchMerging's eight slices in raster order (MONAI's v2 order), not
    the v1 order the weights were made for."""
    from subcort_tpu_torch.models import swinunetr
    setattr_(swinunetr, "MERGE_OFFSETS",
             tuple(itertools.product(range(2), repeat=3)))


FAULTS = {f.__name__: f for f in (shift_mask_left_out, position_bias_left_out,
                                  roll_not_undone, uniform_blend,
                                  merge_in_raster_order)}


if __name__ == "__main__":
    from benchmark import calibrate, faults
    faults.FAULTS.update(FAULTS)
    sys.exit(calibrate.main())
