"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests can hold: the
same drivers, references and checks, on small scans, few rows and, where
asked, narrow widths."""

from __future__ import annotations

import dataclasses
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

NARROW = dict(conv_filters=[4, 4, 8, 8, 8], fc_conv=16, fc_fc=32, fc2=16)
TRAFFIC = {
    "scan_dense": dict(shape=[40, 48, 40], scans=2, dilate=2),
    "train_b128": dict(shape=[20, 24, 20], samples=1200, batch=16,
                       steps_per_call=4, epoch_seconds=1.0),
}


def cell(workload: str, narrow: bool = True, **traffic) -> harness.Cell:
    c = harness.resolve(harness.load_manifest(ROOT), workload, ROOT)
    cfg = dict(c.config, **(NARROW if narrow else {}))
    tr = {**c.traffic, **TRAFFIC[workload], **traffic}
    return dataclasses.replace(c, config=cfg, traffic=tr)


def execute(workload: str, seed: int = 2 ** 33 + 5, seconds: float = 1.0,
            narrow: bool = True, **traffic) -> dict:
    """One run of the cut cell on the CPU: what ``run.py`` prints, without
    its look for a card."""
    c = cell(workload, narrow, **traffic)
    with tempfile.TemporaryDirectory() as tmp:
        return harness.execute(c, "cpu", seed, seconds, False, Path(tmp),
                               time.perf_counter())


def driver(workload: str, seed: int, tmp: Path, narrow: bool = True,
           **traffic):
    """The cut cell's driver, set up on the CPU."""
    c = cell(workload, narrow, **traffic)
    run = harness.Run(c, "cpu", seed, 0.0, False, tmp)
    drv = harness.load_module(
        harness.HERE / "drivers" / f"{c.traffic['driver']}.py").Driver(run)
    drv.setup()
    return drv
