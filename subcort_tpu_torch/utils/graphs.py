"""One step of a device program captured in a CUDA graph and replayed.

The port's counterpart of a jitted ``lax.scan`` over steps, shared by
registration's optimiser levels (``registration/torch_backend.py::
run_level``) and the train multistep (``engine/train.py::
make_train_multistep``).

On the card a :class:`GraphedStep` runs its step on a capture stream of
the calling thread: :data:`WARMUP` eager calls first (the first creates
cuBLAS's workspace for that stream and grows the caching allocator, which
a capture must not have to do, and autograd's backward wants eager
iterations on the stream before a capture), then one call captured in a
CUDA graph with ``capture_error_mode="thread_local"``, replayed for every
later call, so the step runs exactly as often as asked (a capture itself
runs nothing). Each run is ordered after the caller's stream by an event
and the caller after it again at its end: no device-wide synchronize, so
another thread may keep the card busy meanwhile (the pipelined folder
sweep registers on its loader thread while the main thread segments). A
failed capture or replay raises; nothing falls back to eager calls.
:meth:`GraphedStep.close` waits for the replays, releases the graph and
empties its memory pool. Each capture allocates from a pool of its own (a
``torch.cuda.MemPool``), which goes with the graph: the caching allocator
cannot hand a released graph's private blocks to the next capture, so
without that every level of every registration kept its pool reserved
(about 14 GB a ``register_masks`` call on the MNI-sized scan), and the
fifth call in a process ran out of the card's memory.

A step may hold NCCL collectives (a data-parallel rank's train step): the
capture records them on the NCCL stream it forks from the capture stream,
and each replay runs them. Their communicator must exist before the
capture, which the warm-up calls' collectives ensure at the latest, and
every rank must capture at the same call, which the fixed warm-up count
gives ranks that run the same calls.

A kernel wrapper counts its launches through :func:`count_launch`, so a
launch recorded by a capture counts once per replay, not at the capture.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from subcort_tpu_torch.utils.runtime import span

# eager calls of a step on its capture stream before one is captured
WARMUP = 2

_THREAD = threading.local()


class SpanTimer:
    """Times a span of calls: CUDA events on the current stream around it
    (on the card), and the host's time to enqueue it. A no-op unless
    ``on``."""

    def __init__(self, device: torch.device, on: bool = True):
        self.on = on
        self.events = None
        if not on:
            return
        if device.type == "cuda":
            self.events = [torch.cuda.Event(enable_timing=True)]
            self.events[0].record()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.on:
            return
        self.host_ms = (time.perf_counter() - self.t0) * 1e3
        if self.events is not None:
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[1].record()

    def per_call(self, n: int) -> Tuple[Optional[float], float]:
        """(device ms, host enqueue ms) per each of the span's ``n`` calls;
        waits for the span's end on the device."""
        device_ms = None
        if self.events is not None:
            self.events[1].synchronize()
            device_ms = self.events[0].elapsed_time(self.events[1]) / max(n, 1)
        return device_ms, self.host_ms / max(n, 1)


def timed(fn: Callable[[], object], n: int, device: torch.device,
          on: bool = True) -> SpanTimer:
    """``n`` calls of ``fn``; their :class:`SpanTimer`."""
    timer = SpanTimer(device, on)
    for _ in range(n):
        fn()
    timer.stop()
    return timer


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """This thread's stream for captures on ``device``: one per thread and
    card, so the caching allocator reuses one graph's freed blocks in the
    next (it reuses them only on their own stream)."""
    streams = _THREAD.__dict__.setdefault("capture_streams", {})
    if device.index not in streams:
        streams[device.index] = torch.cuda.Stream(device)
    return streams[device.index]


def count_launch(add: Callable[[int], None]) -> None:
    """Count one launch of a kernel by calling ``add(n)``: ``add(1)`` now,
    or, while this thread captures a :class:`GraphedStep`, at every replay
    of the graph and not at the capture."""
    recorded = getattr(_THREAD, "launches", None)
    if recorded is None:
        add(1)
    else:
        recorded.append(add)


class GraphedStep:
    """``step`` (a function of no arguments that takes no host input and
    reads nothing back) run on the card as the module docstring says.
    ``generators``: the CUDA generators the step draws from, registered
    with the graph so that each replay draws anew and leaves each
    generator where as many eager calls would. After a run,
    ``warmup_calls``, ``replays`` and ``capture_ms`` (host ms to capture
    and instantiate the graph; None before a capture) say what ran."""

    def __init__(self, step: Callable[[], object], device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        self.step = step
        self.device = device
        self.generators = tuple(generators)
        self.side = capture_stream(device)
        self.graph = None
        self.pool = None
        self.warmup_calls = 0
        self.replays = 0
        self.capture_ms = None
        self._launches = []

    def run(self, n: int, on: bool = False):
        """``n`` more calls of the step. Returns the :class:`SpanTimer`
        (live when ``on``) of the eager calls among them and that of the
        replays, None when none was replayed."""
        caller = torch.cuda.current_stream(self.device)
        self.side.wait_stream(caller)
        with torch.cuda.stream(self.side):
            n_eager = (0 if self.graph is not None
                       else min(n, WARMUP - self.warmup_calls))
            eager = timed(self.step, n_eager, self.device, on)
            self.warmup_calls += n_eager
            rest = None
            if n > n_eager:
                if self.graph is None:
                    self._capture()
                rest = timed(self._replay, n - n_eager, self.device, on)
        caller.wait_stream(self.side)
        return eager, rest

    def _capture(self) -> None:
        """Capture and instantiate the graph: one ``graph.capture`` span,
        ``capture_ms`` read off the spans' clock."""
        with span("graph.capture"):
            graph = torch.cuda.CUDAGraph()
            for generator in self.generators:
                graph.register_generator_state(generator)
            t0 = time.time_ns()
            _THREAD.launches = []
            with torch.cuda.device(self.device):
                self.pool = torch.cuda.MemPool()
            graph.capture_begin(pool=self.pool.id,
                                capture_error_mode="thread_local")
            try:
                self.step()
            finally:
                self._launches = _THREAD.__dict__.pop("launches")
                graph.capture_end()
            self.capture_ms = (time.time_ns() - t0) * 1e-6
        self.graph = graph

    def _replay(self) -> None:
        self.graph.replay()
        for add in self._launches:
            add(1)
        self.replays += 1

    def close(self) -> None:
        """Wait for the replays, then release the graph and empty its pool
        (the pool's destructor returns its blocks to the device)."""
        if self.graph is not None:
            self.side.synchronize()
            self.graph.reset()
            self.graph = None
        self.pool = None

    def __enter__(self) -> "GraphedStep":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
