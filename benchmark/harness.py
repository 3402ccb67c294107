"""The benchmark's general machinery, driven by ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
harness finds everything else by those names, so that a later change adds
a configuration, a traffic mix or a per-layer metric with new files and
entries only:

- ``configs/<config>.json``: the configuration as run (the ``file`` of its
  ``configs`` entry), and beside it ``configs/<config>.py``, which counts
  the configuration's FLOPs;
- ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` key names
  the general generator in ``drivers/<driver>.py`` that reads them;
- ``limits/<cell>.json``: the limit of each number the cell's correctness
  check compares, with the readings it was set from;
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(run)``
  returning a number, or None where the run has nothing to read.

A driver is a class ``Driver(run)`` with ``setup()``, ``window()``,
``release()`` and ``check()``; the harness times the set-up, reads the
device's peak memory between the window and the check, and assembles the
result line.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark.trace import Spans, Trace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "subcort_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_module(path: Path, name: Optional[str] = None):
    """The Python file ``path`` as a module of its own (names with dots,
    such as a metric's, are not importable by ``import``)."""
    name = name or "benchmark._loaded." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    flops: object          # configs/<config>.py
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def resolve(manifest: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` with its configuration, traffic, limits and
    the metrics it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg_path = root / conf["file"]
    with open(cfg_path) as fh:
        config = json.load(fh)
    flops = load_module(cfg_path.with_suffix(".py"))
    with open(HERE / "traffic" / f"{w['traffic']}.json") as fh:
        traffic = json.load(fh)
    with open(HERE / "limits" / f"{workload}.json") as fh:
        limits = json.load(fh)
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(workload, int(w["chips"]), config, flops, traffic, limits,
                e2e, per_layer)


class Run:
    """One run of a cell: what the driver measures and leaves for the
    metric readers."""

    def __init__(self, cell: Cell, device, seed: int, seconds: float,
                 trace: bool, workdir: Path):
        self.cell = cell
        self.device = torch.device(device)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.workdir = Path(workdir)
        self.spans = Spans()
        self.trace = Trace(trace, self.device, self.spans)
        self.traced = bool(trace)
        self.counts = {}       # what the window did: items, FLOPs
        self.end_to_end = {}   # metric -> value, set by the driver
        self.extra = {}        # what a reader needs beyond the above
        self.setup_parts = {}  # seconds of each part of the set-up
        self.window_t0 = None  # host clock where the window opened, if
        #                        not at the end of the driver's set-up


def check_modules() -> list:
    """Loaded modules whose top-level name is forbidden in a run."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit], ...]): every number at or under its
    limit; a missing or non-finite number fails."""
    rows, ok = [], True
    for name, spec in limits.items():
        limit = float(spec["limit"])
        value = numbers.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        rows.append([name, value, limit])
    for name in numbers:
        if name not in limits:
            raise KeyError(f"the check compares {name!r}, which the "
                           "cell's limits file does not bound")
    return ok, rows


def execute(cell: Cell, device, seed: int, seconds: float, trace: bool,
            workdir: Path, t_start: float) -> dict:
    """Set up, measure and check one run of ``cell``; returns the result
    line's fields (the caller prints them). ``t_start`` is the host clock
    at the process's start, from which set-up is counted."""
    run = Run(cell, device, seed, seconds, trace, workdir)
    drv = load_module(
        HERE / "drivers" / f"{cell.traffic['driver']}.py").Driver(run)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    drv.setup()
    setup_end = time.perf_counter()
    drv.window()
    # a driver whose window opens inside its first call (a fit's first
    # epoch is set-up) says where
    setup_s = (run.window_t0 or setup_end) - t_start
    memory_peak = (torch.cuda.max_memory_allocated(run.device)
                   if run.device.type == "cuda" else 0)
    drv.release()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    correct, rows = judge(drv.check(), cell.limits)
    check_s = time.perf_counter() - t0

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            value = (setup_s if m["name"] == "setup_s"
                     else run.end_to_end.get(m["name"]))
            if value is None:
                raise RuntimeError(f"the run measured no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": bool(correct),
        "attempted": int(run.counts.get("attempted", 0)),
        "failed": int(run.counts.get("failed", 0)),
        "metrics": metrics,
        "device": device_info(run, memory_peak),
        "setup_parts": dict(run.setup_parts, total=setup_s),
        "check_s": check_s,
    }
    if trace and run.trace.busy_s is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
        out["trace_parse_s"] = run.trace.parse_s
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in rows}
    return out


def device_info(run: Run, memory_peak: int) -> dict:
    if run.device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(run.device),
                "count": run.cell.chips, "memory_peak_bytes": int(memory_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
