"""Readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control 1,2,3] [--fault NAME --faulted 1,2,3]

For each seed of ``--seeds`` the cell's set-up and one pass of its traffic
without a window, then the numbers its check compares (``readings``); for
each seed of ``--control`` the control's numbers: the plain reference
computed in the precision below the configuration's, put in the program's
place; for each seed of ``--faulted`` the numbers with the fault ``--fault``
(``faults.py``) planted in the program's timed path. One JSON line per seed
and side. The lower reading of a number is the largest the program gives
over its seeds; the upper the smallest the control gives where that is three
times the lower or more, or a fault gives where that is ten times.
"""

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default=None, choices=sorted(faults.FAULTS))
    ap.add_argument("--faulted", default="")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = harness.resolve(harness.load_manifest(ROOT), args.workload, ROOT)
    Driver = harness.load_module(
        harness.HERE / "drivers" / f"{cell.traffic['driver']}.py").Driver
    sides = (("program", args.seeds), ("control", args.control),
             (f"fault:{args.fault}", args.faulted))
    for side, seeds in sides:
        for seed in (int(s) for s in seeds.split(",") if s):
            t0 = time.perf_counter()
            fault = (faults.planted(args.fault) if side.startswith("fault")
                     else contextlib.nullcontext())
            with tempfile.TemporaryDirectory() as tmp, fault:
                run = harness.Run(cell, args.device, seed, 0.0, False,
                                  Path(tmp))
                drv = Driver(run)
                drv.setup()
                numbers = (drv.control() if side == "control"
                           else drv.readings())
            print(json.dumps({"workload": args.workload, "side": side,
                              "seed": seed, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            del drv, run
    return 0


if __name__ == "__main__":
    sys.exit(main())
