"""Faults of the cell ``scan_synthseg``, planted as ``faults.py``'s are
(``fault(setattr)``).

    python3 benchmark/faults_synthseg.py --workload scan_synthseg \
        --seeds ... [--control ...] [--fault NAME --faulted ...]

is ``calibrate.py`` with these faults among its choices.
"""

from __future__ import annotations

import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def flipped_forward_left_out(setattr_):
    """P from the unflipped forward alone."""
    from subcort_tpu_torch.engine import synthseg
    setattr_(synthseg, "PASSES", (False,))


def lr_swap_left_out(setattr_):
    """The flipped forward's left/right channels left unswapped."""
    from subcort_tpu_torch.engine import synthseg
    setattr_(synthseg, "_swap_lr", lambda soft, perm: soft)


def skip_zeroed(setattr_):
    """The finest level's skip replaced by zeros in the decoder."""
    import torch

    from subcort_tpu_torch.models import synthseg
    real = synthseg._merge

    def zeroed(up, skip, level):
        return real(up, torch.zeros_like(skip) if level == 0 else skip,
                    level)

    setattr_(synthseg, "_merge", zeroed)


def average_left_out(setattr_):
    """P the sum of the two passes' softmaxes, not their mean (each pass's
    softmax doubled, which the mean halves back to their sum): every
    argmax as it was, the values twice theirs."""
    from subcort_tpu_torch.engine import synthseg
    real = synthseg._softmax
    setattr_(synthseg, "_softmax", lambda net, x: real(net, x).mul_(2))


def topology_skipped(setattr_):
    """The post-process's component steps left out: the renormalised
    argmax of the averaged posteriors."""
    from subcort_tpu_torch.engine import synthseg
    setattr_(synthseg, "keep_largest", lambda prob: 0)


FAULTS = {f.__name__: f for f in (flipped_forward_left_out,
                                  lr_swap_left_out, skip_zeroed,
                                  average_left_out, topology_skipped)}


if __name__ == "__main__":
    from benchmark import calibrate, faults
    faults.FAULTS.update(FAULTS)
    sys.exit(calibrate.main())
