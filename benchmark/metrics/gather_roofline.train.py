"""Kernel B1's share of its roofline over the traced epoch, in %: the least
bytes each launch must move (``frozen.gather_roofline_bytes`` on its
centers: the distinct padded-volume bytes read once plus 12,288 bytes
written per center) over 3.35 TB/s, summed over the launches, over B1's
device time in the trace. Bound by bytes: the gather does no arithmetic."""

import torch

from benchmark import frozen, peaks

KERNEL = "gather_triplanar"


def read(run):
    t = run.trace
    launches = run.extra.get("gather_launches")
    if t.busy_s is None or not launches:
        return None
    names = [k for k in t.kernels if KERNEL in k]
    seconds = sum(t.kernels[k] for k in names)
    count = sum(t.launches[k] for k in names)
    if not seconds or count != len(launches):
        return None
    shape = run.extra["gather_padded_shape"]
    dev = run.device
    bound = sum(frozen.gather_roofline_bytes(
        torch.from_numpy(c).to(dev), shape) for c in launches)
    return 100.0 * bound / peaks.HBM_BYTES / seconds
