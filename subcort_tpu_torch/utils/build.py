"""Build the port's CUDA kernels at first use.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` into a shared library that :mod:`ctypes` loads; nothing includes
PyTorch's headers, so a build takes seconds. Libraries go to
``subcort_tpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.

A missing ``nvcc`` or a failed compile raises, with the compiler's output.
There is no stub and no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin/nvcc`` (CUDA_HOME defaults
    to /usr/local/cuda); raises if neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or at $CUDA_HOME/bin/nvcc (CUDA_HOME="
        f"{home!r}); the CUDA kernels of subcort_tpu_torch cannot be built")


def build_library(name: str, sources: Sequence[os.PathLike | str],
                  build_dir: os.PathLike | str = BUILD_DIR,
                  verbose: bool = False) -> Path:
    """Compile ``sources`` into ``<build_dir>/<name>-<hash>.so`` unless that
    file exists; return its path. ``verbose`` prints the compiler's output
    (``-Xptxas=-v``: registers, shared memory and spills per kernel)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    out = Path(build_dir) / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(" ".join(cmd))
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, out)
    return out


def load_library(name: str,
                 sources: Sequence[os.PathLike | str]) -> ctypes.CDLL:
    """Build (if needed) and load a kernel library."""
    return ctypes.CDLL(str(build_library(name, sources)))
