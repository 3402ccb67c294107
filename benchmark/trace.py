"""Host-clock spans and the device trace of a run.

Spans are the benchmark's own: a host-clock interval around each call into
a layer of the program, kept in memory by name. In a traced run every span
is also a ``torch.profiler`` annotation, so that an idle gap on the device
can be put down to the span the host had open.

The device trace comes from ``torch.profiler`` (CUPTI) over a window that
the driver opens and closes; :class:`Trace` reduces it to the seconds in
which some operation ran on the device (the union of kernel, copy and set
intervals), time and launches by kernel name, and the idle gaps split over
the spans the host had open across them.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    """Named host-clock intervals; annotations in the trace while one is
    recorded."""

    def __init__(self):
        self.seconds = defaultdict(list)
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)

    def mean(self, name: str):
        xs = self.seconds.get(name)
        return sum(xs) / len(xs) if xs else None


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


def innermost(marks, outside: str):
    """Nested (start, end, name) spans as consecutive (start, end, name)
    pieces, each named by the innermost span open over it; time under no
    span is ``outside``'s."""
    edges = sorted({t for m in marks for t in m[:2]})
    marks = sorted(marks, key=lambda m: (m[0], -m[1]))
    pieces, stack, i = [], [], 0
    for a, b in zip(edges, edges[1:]):
        while i < len(marks) and marks[i][0] <= a:
            stack.append(marks[i])
            i += 1
        stack = [m for m in stack if m[1] > a]
        pieces.append((a, b, stack[-1][2] if stack else outside))
    return pieces


def idle_by_span(gaps, marks, outside: str) -> dict:
    """Seconds of each idle gap of the device, split over the spans the host
    had open across it (the innermost at each moment)."""
    pieces = innermost(marks, outside)
    out, j = defaultdict(float), 0
    for a, b in gaps:
        covered = 0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] += (hi - lo) * 1e-9
                covered += hi - lo
            k += 1
        if b - a > covered:
            out[outside] += (b - a - covered) * 1e-9
    return dict(out)


class Trace:
    """What a run's device trace says; ``None`` fields until :meth:`stop`."""

    def __init__(self, on: bool, device, spans: Spans):
        self.on = on and torch.device(device).type == "cuda"
        self.device = device
        self.spans = spans
        self.prof = None
        self.window_s = self.busy_s = None
        self.kernels = {}        # name -> device seconds
        self.launches = {}       # name -> count
        self.gaps = {}           # span -> idle seconds
        self.parse_s = None
        # what a gap under no benchmark span is put down to: the driver
        # names the program call it spends the window in, where one call
        # holds the whole window
        self.outside = "harness"

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.spans.annotate = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None:
            return
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.spans.annotate = False
        t0 = time.perf_counter()
        self.prof.stop()
        self._reduce(self.prof.profiler.kineto_results.events())
        self.prof = None
        self.parse_s = time.perf_counter() - t0

    def _reduce(self, events) -> None:
        names = set(self.spans.seconds)
        device, marks = [], []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation() or e.name() in names:
                    continue
                start = _ns(e, "start")
                dur = _ns(e, "duration")
                device.append((start, start + dur))
                name = e.name()
                self.kernels[name] = self.kernels.get(name, 0.0) + dur * 1e-9
                self.launches[name] = self.launches.get(name, 0) + 1
            elif e.is_user_annotation() and e.name() in names:
                start = _ns(e, "start")
                marks.append((start, start + _ns(e, "duration"), e.name()))
        device.sort()
        busy, gaps, end = 0, [], None
        for a, b in device:
            if end is None or a > end:
                if end is not None:
                    gaps.append((end, a))
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        self.busy_s = busy * 1e-9
        self.gaps = idle_by_span(gaps, marks, self.outside)

    def device_ops(self, n: int = 10):
        return [[k, v] for k, v in sorted(self.kernels.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        return [[k, v] for k, v in sorted(self.gaps.items(),
                                          key=lambda kv: -kv[1])[:n]]
