"""Segmentation metrics + per-scan observability (copy of
subcort_tpu/engine/metrics.py; numpy only, copied because
``subcort_tpu.engine`` imports jax)."""

from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np


def dice_per_class(pred: np.ndarray, gt: np.ndarray,
                   num_classes: int = 15) -> Dict[int, float]:
    """Dice coefficient per structure class 1..num_classes-1.

    Classes absent from BOTH volumes are omitted (undefined Dice).
    """
    out: Dict[int, float] = {}
    for c in range(1, num_classes):
        p = pred == c
        g = gt == c
        denom = int(p.sum()) + int(g.sum())
        if denom == 0:
            continue
        out[c] = 2.0 * int(np.logical_and(p, g).sum()) / denom
    return out


def mean_dice(pred: np.ndarray, gt: np.ndarray, num_classes: int = 15) -> float:
    d = dice_per_class(pred, gt, num_classes)
    return float(np.mean(list(d.values()))) if d else float("nan")


class ScanStats:
    """Collects per-scan timings/counters; one JSON line per scan."""

    def __init__(self, scan: str):
        self.scan = scan
        self.t0 = time.time()
        self.t_stop = None
        self.fields: dict = {}

    def set(self, **kw):
        self.fields.update(kw)
        return self

    def stop(self):
        """Pin the wall-clock now (for an ``emit()`` that runs later)."""
        self.t_stop = time.time()
        return self

    def emit(self, sink=None) -> dict:
        dt = max((self.t_stop or time.time()) - self.t0, 1e-9)
        rec = {"scan": self.scan, "wall_seconds": round(dt, 4), **self.fields}
        if rec.get("candidate_voxels"):
            rec["voxels_per_sec"] = int(rec["candidate_voxels"] / dt)
        line = json.dumps(rec)
        if sink is not None:
            sink.write(line + "\n")
        else:
            print(line)
        return rec
