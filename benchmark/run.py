"""Run one cell of the benchmark of ``subcort_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics come from ``BENCHMARK.json`` and the files named after
them (``benchmark/harness.py``). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics), ``device``
and, traced, ``breakdown``; the numbers the correctness check compared come
last, under ``checks``, and again as the last lines of standard error.

Without a CUDA card, with fewer cards than the cell asks for, without the
program beside the benchmark, or with a module of JAX or of the JAX package
loaded once the window has closed, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "subcort_tpu_torch"
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".bench_cache"
# the host's thread pools at a fixed size, whatever the environment says:
# half of a one-card machine's 8 cores, the rest left to the process's own
# threads and the CUDA driver's
HOST_THREADS = "4"


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / PROGRAM / "__init__.py").is_file():
        fail(f"no {PROGRAM}/ beside the benchmark in {ROOT}")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = HOST_THREADS
    sys.path.insert(0, str(ROOT))

    from benchmark import harness
    cell = harness.resolve(harness.load_manifest(ROOT), args.workload, ROOT)

    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} card(s), torch sees "
             f"{torch.cuda.device_count()}")
    import subcort_tpu_torch
    if Path(subcort_tpu_torch.__file__).resolve().parents[1] != ROOT:
        fail(f"{PROGRAM} was imported from {subcort_tpu_torch.__file__}, "
             f"not from the checkout {ROOT}")
    torch.cuda.init()
    import_s = time.perf_counter() - T_START
    print(f"card: {power_limit()}", file=sys.stderr, flush=True)

    workdir = Path(tempfile.mkdtemp(prefix="subcort_bench_"))
    try:
        out = harness.execute(cell, torch.device("cuda", 0), args.seed,
                              args.seconds, bool(args.trace), workdir,
                              T_START)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["setup_parts"]["import"] = import_s

    found = harness.check_modules()
    if found:
        fail(f"modules of JAX or of the JAX package were loaded: {found}")
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
