#!/usr/bin/env python3
"""Time the PyTorch port's tri-planar gather kernel on one NVIDIA card.

    python3 scripts/torch_gather_bench.py [--repo PATH] [--sweep]

Times the gather kernel of the checkout at PATH (default: this one) at
N = 8,192 in the three uses that chip_smoke.py times, on the same seeded
inputs: random centers in the MNI-sized volume (181x217x181, padded), the
MNI scan's first 8,192 candidates in raster order in situ on its
normalized volume, and random centers in a 3-subject stack. CUDA events,
50 launches after 5 of warm-up. A checkout whose wrapper still takes the
padded volume itself (before ``prepare_gather_volume``) is timed that way,
so that two checkouts can be compared on one card in one call, in turns
(parent, change, change, parent).

``--sweep`` also builds variants of this checkout's kernel source with
other ring depths and blocks per SM (the ``kStages`` and ``kBlocksPerSm``
constants), checks each bit-equal to the plain version, and times it.

Prints one JSON line per timing, with the bound (bytes the uses must move
over 3.35 TB/s) where the checkout can count it, and the time of one
``zero_()`` of the outputs' 100 MB as the card's practical write rate.
Needs a CUDA device and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
N = 8192
SHAPE = (181, 217, 181)
SUBJECTS = 3
HBM_BYTES_PER_S = 3.35e12
# H100: 228 KB of shared memory per SM, 1 KB of it reserved per block
SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = 233_472, 1024


def _make_scan():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.make_scan(np.random.default_rng(0))


def _time_ms(torch, fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _inputs(torch, device):
    """The three uses' (name, padded, centers, plain gather), made as
    chip_smoke.py makes them."""
    from subcort_tpu_torch import Options
    from subcort_tpu_torch.engine.infer import (_normalized_padded, _wire,
                                                candidate_centers)
    from subcort_tpu_torch.ops.normalize import normalize_stats
    from subcort_tpu_torch.ops.patches import (gather_triplanar,
                                               gather_triplanar_subjects,
                                               pad_volume)

    gen = torch.Generator(device=device).manual_seed(0)
    padded = pad_volume(torch.randn(SHAPE, generator=gen, device=device))
    rand = torch.stack([torch.randint(0, s, (N,), generator=gen,
                                      device=device) for s in SHAPE], 1)
    rand = rand.to(torch.int32).contiguous()
    stack = torch.randn((SUBJECTS,) + tuple(padded.shape), generator=gen,
                        device=device)
    subj = torch.cat([torch.randint(0, SUBJECTS, (N, 1), generator=gen,
                                    device=device, dtype=torch.int32),
                      rand], 1).contiguous()
    image, _, roi = _make_scan()
    insitu = torch.from_numpy(candidate_centers(
        image, Options(), roi.astype(np.uint8))[:N]).to(device)
    return [("random", padded, rand, gather_triplanar),
            ("insitu", _normalized_padded(
                torch.from_numpy(_wire(image)).to(device),
                normalize_stats(image)), insitu,
             gather_triplanar),
            ("subjects", stack, subj, gather_triplanar_subjects)]


def _variant_source(text: str, stages: int, blocks: int) -> str:
    for name, value in (("kStages", stages), ("kBlocksPerSm", blocks)):
        text, count = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        if count != 1:
            raise RuntimeError(f"{name} not found once in the kernel source")
    return text


def _fits(stages: int, blocks: int) -> bool:
    smem = 128 + stages * 3 * 32 * 36 * 4 + 256 * 16 + stages * 8
    return blocks * (smem + SMEM_PER_BLOCK_RESERVED) <= SMEM_PER_SM


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", type=Path, default=HERE,
                        help="checkout whose kernel is timed")
    parser.add_argument("--sweep", action="store_true",
                        help="also time ring-depth and blocks-per-SM "
                             "variants of this checkout's kernel")
    args = parser.parse_args()
    repo = args.repo.resolve()
    sys.path.insert(0, str(repo))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_gather_bench: needs a CUDA device")
    from subcort_tpu_torch.ops import gather_kernel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    prepare = getattr(gather_kernel, "prepare_gather_volume", None)
    count = getattr(gather_kernel, "gather_roofline_bytes", None)
    uses = []
    for name, padded, centers, plain in _inputs(torch, device):
        volume = prepare(padded) if prepare else padded
        nbytes = count(centers, padded.shape) if count else None
        uses.append((name, padded, volume, centers, plain, nbytes))

    def emit(variant: str) -> None:
        for name, padded, volume, centers, plain, nbytes in uses:
            got = gather_kernel.gather_triplanar_cuda(volume, centers)
            for g, w in zip(got, plain(padded, centers)):
                if not torch.equal(g, w):
                    raise RuntimeError(f"{variant}: kernel != plain ({name})")
            ms = _time_ms(torch, lambda: gather_kernel.gather_triplanar_cuda(
                volume, centers))
            row = {"checkout": str(repo), "variant": variant, "use": name,
                   "n": int(centers.shape[0]), "ms": ms, "card": card}
            if nbytes is not None:
                row["bytes"] = nbytes
                row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                row["share_of_bound"] = row["bound_ms"] / ms
            print(json.dumps(row), flush=True)

    emit("source")
    # the card's practical write rate: one fill of the outputs' bytes
    outs = torch.empty((3, N, 32, 32), device=device)
    print(json.dumps({"checkout": str(repo), "variant": "zero_ of the "
                      "outputs' bytes (write floor)", "n": N,
                      "bytes": outs.numel() * 4, "ms": _time_ms(
                          torch, outs.zero_), "card": card}), flush=True)
    if not args.sweep:
        return
    from subcort_tpu_torch.utils.build import BUILD_DIR, build_library

    text = gather_kernel.SOURCE.read_text()
    sweep_dir = BUILD_DIR / "sweep"
    sweep_dir.mkdir(parents=True, exist_ok=True)
    grid = [(s, b) for s in (3, 4, 5, 6, 8) for b in (1, 2, 3, 4)
            if _fits(s, b)]
    paths = []
    for stages, blocks in grid:
        path = sweep_dir / f"gather_triplanar_s{stages}_b{blocks}.cu"
        path.write_text(_variant_source(text, stages, blocks))
        paths.append(path)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        libs = list(pool.map(
            lambda p: build_library(p.stem, [p], build_dir=sweep_dir), paths))
    import ctypes

    for (stages, blocks), lib in zip(grid, libs):
        bound = gather_kernel.bind(ctypes.CDLL(str(lib)))
        gather_kernel._library = lambda bound=bound: bound
        emit(f"stages={stages},blocks_per_sm={blocks}")


if __name__ == "__main__":
    main()
