"""Device lists and row splits (port of subcort_tpu/parallel/mesh.py).

The workload is data-parallel only: the global batch (training) or the
candidate-voxel axis (inference) is split over devices, and the 883k
parameters are replicated. Where the JAX package builds a 1D ``('data',)``
``Mesh`` and lets XLA insert the collectives, the port keeps a plain list
of ``torch.device``s: inference fans out from one process over the list
(:class:`DeviceWorkers`, one host thread per entry, which
``engine.infer.segment_volume`` deals its work over), and training runs
one process per device (:mod:`~subcort_tpu_torch.parallel.distributed`).
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Sequence

import torch

from subcort_tpu_torch.config import Options, exact_float32, select_device


def available_devices(mode: str = "cuda0") -> List[torch.device]:
    """The devices of the kind ``mode`` names, from its index on: ``cudaK``
    gives ``cuda:K .. cuda:<count-1>``; ``cpu`` has one device. Raises
    what ``select_device`` raises for an absent card."""
    first = select_device(Options(mode=mode))
    if first.type != "cuda":
        return [first]
    return [torch.device("cuda", i)
            for i in range(first.index, torch.cuda.device_count())]


def make_devices(n_devices: int, mode: str = "cuda0") -> List[torch.device]:
    """The first ``n_devices`` of :func:`available_devices`; raises
    :class:`ValueError` when fewer exist, as the JAX package's
    ``make_mesh`` does."""
    have = available_devices(mode)
    if n_devices > len(have):
        raise ValueError(f"requested {n_devices} devices, have {len(have)}")
    return have[:max(1, n_devices)]


def shard_rows(n: int, parts: int, align: int = 1) -> List[slice]:
    """``parts`` contiguous slices covering ``range(n)`` in order, their
    sizes as equal as whole multiples of ``align`` allow (the last slice
    takes the remainder; trailing slices may be empty)."""
    blocks = -(-n // align)
    per = -(-blocks // parts) if parts else 0
    out = []
    for d in range(parts):
        start = min(n, d * per * align)
        out.append(slice(start, min(n, (d + 1) * per * align)))
    return out


def replicate(net: torch.nn.Module,
              devices: Sequence[torch.device]) -> Dict[torch.device,
                                                      torch.nn.Module]:
    """``net`` on every distinct device of ``devices``: itself where it
    lies, a copy elsewhere."""
    home = next(net.parameters()).device
    out = {}
    for d in devices:
        d = torch.device(d)
        if d not in out:
            out[d] = net if d == home else copy.deepcopy(net).to(d)
    return out


class DeviceWorkers:
    """One host thread per entry of a device list (an entry may repeat):
    the port is bound by the host launching its kernels, so two devices
    driven from one thread would take turns. A task runs with TF32 off
    (:func:`~subcort_tpu_torch.config.exact_float32`, which counts the
    threads inside it) and with its device current. Use as a context
    manager; leaving it waits for every task, and an error cancels the
    tasks not yet started."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        self._pools = [ThreadPoolExecutor(1, thread_name_prefix=f"device{i}")
                       for i in range(len(self.devices))]

    def submit(self, i: int, fn, *args) -> Future:
        """``fn(*args)`` on entry ``i``'s thread."""
        dev = self.devices[i]

        def run():
            on_card = (torch.cuda.device(dev) if dev.type == "cuda"
                       else contextlib.nullcontext())
            with exact_float32(), on_card:
                return fn(*args)

        return self._pools[i].submit(run)

    def __enter__(self) -> "DeviceWorkers":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        for pool in self._pools:
            pool.shutdown(wait=True, cancel_futures=exc_type is not None)
