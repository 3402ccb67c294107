"""Several processes: the multi-host folder sweep and the trainer's ranks
(port of subcort_tpu/parallel/distributed.py).

Multi-host, as the JAX package has it: every host runs the same command,
joins one process group (:func:`initialize`, gloo: what crosses hosts is a
few host scalars) and segments its strided slice of the subject list
(:func:`host_shard`; ``SegmentationEngine.segment_folder`` takes it when
the world is larger than 1), with no traffic between hosts on the hot path:

    from subcort_tpu_torch.parallel.distributed import initialize, host_shard
    initialize()                     # SUBCORT_NUM_PROCESSES, or explicit
    for path in host_shard(all_scan_paths):
        engine.segment_scan(path)

The trainer's ranks (:func:`launch`): ``Trainer.fit`` over more than one
device starts one process per device with ``torch.multiprocessing``'s
spawn start method, each in a process group of its own making (NCCL over
distinct CUDA devices, gloo otherwise), and joins them. The launcher hosts
the group's store on a port the OS picks as it binds, so no rank meets a
port that another process took, nor joins another launch's group. A rank
that fails exits at once and fails the launch, and the others are
stopped; a rank that hangs in an eager collective times out there
(``COLLECTIVE_TIMEOUT_S``). A rank whose group runs NCCL replays one
captured train step, as one process does (:func:`step_capturable`).
"""

from __future__ import annotations

import atexit
import datetime
import os
import sys
import time
import traceback
from multiprocessing.connection import wait
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from subcort_tpu_torch.parallel import sync_bn

# how long a collective or the group's rendezvous may wait for a rank
COLLECTIVE_TIMEOUT_S = 600
# how long the other ranks get to exit after one has failed
FAILED_GRACE_S = 5
# the longest one wait of the join sleeps before it reads the exit codes
# again
POLL_S = 0.5
# how long a data-parallel Trainer.fit waits for its ranks; None waits
# as long as the fit runs (a rank that hangs in a collective still fails
# after COLLECTIVE_TIMEOUT_S)
FIT_TIMEOUT_S: Optional[float] = None


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the multi-host process group (gloo), with environment
    fallbacks: ``num_processes`` from ``SUBCORT_NUM_PROCESSES``,
    ``process_id`` from ``SUBCORT_PROCESS_ID`` or ``RANK``, the
    coordinator's ``host:port`` from ``SUBCORT_COORDINATOR_ADDRESS`` or
    ``MASTER_ADDR`` / ``MASTER_PORT``. A no-op for one process or when a
    group exists already."""
    if num_processes is None:
        num_processes = int(os.environ.get("SUBCORT_NUM_PROCESSES", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return
    env = os.environ
    if process_id is None:
        pid = env.get("SUBCORT_PROCESS_ID", env.get("RANK"))
        if pid is None:
            raise ValueError("initialize: no process_id, and neither "
                             "SUBCORT_PROCESS_ID nor RANK is set")
        process_id = int(pid)
    if coordinator_address is None:
        coordinator_address = env.get("SUBCORT_COORDINATOR_ADDRESS")
        if coordinator_address is None and "MASTER_ADDR" in env:
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
        if coordinator_address is None:
            raise ValueError("initialize: no coordinator_address, and "
                             "neither SUBCORT_COORDINATOR_ADDRESS nor "
                             "MASTER_ADDR is set")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=_timeout())
    atexit.register(_leave)


def _leave() -> None:
    """Leave the group before the interpreter's teardown: a process that
    exits with its gloo group up aborts there now and then (``terminate
    called without an active exception``, after its work is done)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _group_place() -> tuple:
    # the parameters of host_shard hide the functions' names
    return process_index(), process_count()


def host_shard(items: Sequence, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> list:
    """The slice of ``items`` this process owns (strided, deterministic),
    by default by its place in the group (the JAX package's signature)."""
    pi, pc = _group_place()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    return [it for i, it in enumerate(items) if i % pc == pi]


def all_hosts_mean(value: float) -> float:
    """Mean of a process-local scalar over the group (an all-reduce of a
    CPU tensor); ``value`` itself without a group."""
    if not dist.is_initialized():
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t)
    return float(t[0]) / dist.get_world_size()


# ----------------------------------------------------------------- the ranks
def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL over distinct CUDA devices; gloo otherwise (the CPU, or ranks
    sharing a card, which NCCL refuses as a duplicate GPU)."""
    devices = [torch.device(d) for d in devices]
    if (all(d.type == "cuda" for d in devices)
            and len({d.index for d in devices}) == len(devices)):
        return "nccl"
    return "gloo"


def step_capturable(device: torch.device) -> bool:
    """Whether a data-parallel rank on ``device`` can capture its train
    step in a CUDA graph: the device is a card and the default group's
    backend is NCCL, whose collectives a capture records. Gloo's cannot be
    captured, so its ranks (the CPU, or ranks sharing a card:
    :func:`backend_for`) run the plain loop."""
    return (torch.device(device).type == "cuda" and dist.is_initialized()
            and dist.get_backend() == "nccl")


def _exit(code: int) -> None:
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _rendezvous_store(world: int) -> dist.TCPStore:
    """The group's store, hosted in the launcher's process on a port that
    the OS picks as it binds (port 0): no other process can take the port
    between the pick and the bind."""
    return dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                         wait_for_workers=False, timeout=_timeout())


def _rank_entry(target, rank: int, world: int, rendezvous: tuple,
                backend: str, device: str, threads: int, cudnn_flags,
                args) -> None:
    """A rank's process: its device, threads and cuDNN flags, the group
    on the launcher's store (``rendezvous``: its host, its port and the
    launcher's timeout), then ``target(rank, world, device, *args)``
    inside :func:`~subcort_tpu_torch.parallel.sync_bn.data_parallel`.

    A target that raises ends the process at once with code 1, its
    traceback printed, without leaving the group: leaving waits for the
    rank's collectives, which a peer that no longer joins them (a replayed
    NCCL collective is not timed out) would hold for ever. The launcher's
    join sees the code and stops the other ranks."""
    torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cudnn = torch.backends.cudnn
    cudnn.enabled, cudnn.deterministic, cudnn.benchmark = cudnn_flags
    host, port, timeout = rendezvous
    store = dist.TCPStore(host, port, world, is_master=False, timeout=timeout)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=timeout)
    try:
        with sync_bn.data_parallel(rank, world):
            target(rank, world, dev, *args)
    except BaseException:
        traceback.print_exc()
        _exit(1)
    dist.destroy_process_group()
    # the rank's work is done and in its files: exit now, not after the
    # interpreter's teardown of torch (0.7 s on an idle CPU, seconds under
    # load), which the launcher's join would wait out
    _exit(0)


def join(procs: Sequence, timeout: Optional[float] = None) -> None:
    """Wait until every process of ``procs`` (``multiprocessing``
    processes) has exited with code 0. Once one exits non-zero, the others
    get ``FAILED_GRACE_S`` to exit on their own and :class:`RuntimeError`
    names every process that failed, as a rank: its place in ``procs``; a
    ``timeout`` (seconds) that runs out raises too. The caller stops what
    is still running.

    The processes still running are taken from the same reading of the
    exit codes that found one running, and every wait is bounded by
    ``POLL_S``: ``wait`` on an empty list sleeps out its whole timeout
    (forever without one), which a list read again after the last process
    exited would be. So this returns within ``POLL_S`` of the last
    exit."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        codes = [p.exitcode for p in procs]
        live = [p.sentinel for p, c in zip(procs, codes) if c is None]
        if any(c not in (None, 0) for c in codes):
            grace = time.monotonic() + FAILED_GRACE_S
            while live and time.monotonic() < grace:
                wait(live, timeout=POLL_S)
                live = [p.sentinel for p in procs if p.exitcode is None]
            failed = {r: p.exitcode for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)}
            raise RuntimeError(f"ranks {sorted(failed)} of {len(procs)} "
                               f"exited with codes {list(failed.values())}")
        if not live:
            return
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            raise RuntimeError(f"ranks still running after {timeout} s")
        wait(live, timeout=POLL_S if left is None else min(left, POLL_S))


def launch(target, devices: Sequence[torch.device], args: tuple = (),
           timeout: Optional[float] = None) -> str:
    """Run ``target(rank, world, device, *args)`` in one spawned process
    per entry of ``devices`` (an entry may repeat), joined in a process
    group over :func:`backend_for`'s backend, which it returns.
    ``target`` must be importable by name. The group's store lives in this
    process (:func:`_rendezvous_store`) from before the first rank starts
    until the ranks are stopped; a rank that cannot reach it fails.
    Every rank gets the caller's cuDNN flags and an equal share of its
    threads. The ranks are joined by :func:`join`: once one exits
    non-zero the others get ``FAILED_GRACE_S`` to exit on their own (a
    peer's failure usually breaks their collectives), are then
    terminated, and :class:`RuntimeError` names every rank that failed; a
    ``timeout`` (seconds) that runs out raises too."""
    import torch.multiprocessing as mp

    world = len(devices)
    backend = backend_for(devices)
    threads = max(1, torch.get_num_threads() // world)
    cudnn = torch.backends.cudnn
    flags = cudnn.enabled, cudnn.deterministic, cudnn.benchmark
    store = _rendezvous_store(world)
    rendezvous = store.host, store.port, _timeout()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(
        target, rank, world, rendezvous, backend, str(dev), threads, flags,
        args)) for rank, dev in enumerate(devices)]
    for p in procs:
        p.start()
    try:
        join(procs, timeout)
        return backend
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
        for p in procs:
            p.join()
