"""Runtime utilities: profiling, the program's spans, NaN checks (port of
subcort_tpu/utils/runtime.py).

``enable_compilation_cache`` has no counterpart: torch runs eagerly and
the port's kernels build once per source hash (``utils/build.py``). The
JAX package's ``timer`` has none either: :func:`span` records what it
timed.

**Spans.** Every layer boundary of a request opens a :func:`span` named
``<layer>.<stage>`` (``infer.upload``, ``train.call``, ``register.level``;
PERF.md §3 lists them). A span records while a ``torch.profiler`` records
in this process (``cli --profile``, the benchmark's traced window) or
inside :func:`recording`, and then also opens
``torch.profiler.record_function(name)`` whenever a profiler records, so
that it sits in the device trace beside the kernels. Otherwise entering
one is one check and nothing else: no clock read, no record, no
annotation. A record holds its name; its start and end in Unix-epoch
nanoseconds (``time.time_ns()``, the clock the profiler writes its events
in); the id of the span open on the same thread when it opened (its
parent); a request id shared by every span of one request (inherited from
the parent, else given, else fresh); its thread; and numeric attributes.
Records go to one bounded buffer shared by every thread (:func:`records`),
oldest dropped first and counted (:func:`dropped`).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque

import torch

# set by enable_nan_checks; read where the port reads a loss, logits or
# probabilities back from the device
NAN_CHECKS = False


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``torch.profiler`` over the block: CPU activity, and CUDA activity
    when a card is present. Writes a Chrome trace (view it in Perfetto or
    ``chrome://tracing``) into ``log_dir``. No-op when ``log_dir`` is
    falsy, so call sites can pass the CLI flag through."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        # the block's last kernels finish inside the trace, and the trace
        # is written even when the block raises, as jax.profiler.trace's
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
    print(f"[profile] trace written to {log_dir}")


def enable_nan_checks() -> None:
    """Debug-mode NaN detection, the counterpart of ``jax_debug_nans``:
    autograd's anomaly mode, and a check of every loss ``Trainer`` reads
    back and of the logits and probabilities inference reads back; the
    first NaN raises :class:`FloatingPointError`. Each check reads a flag
    back from the device: a debug setting, not a production default."""
    global NAN_CHECKS
    torch.autograd.set_detect_anomaly(True)
    NAN_CHECKS = True


def check_nans(what: str, value) -> None:
    """With :func:`enable_nan_checks` on, raise :class:`FloatingPointError`
    if ``value`` (a tensor or a float) holds a NaN; otherwise nothing, and
    no device sync."""
    if NAN_CHECKS and bool(torch.isnan(torch.as_tensor(value)).any()):
        raise FloatingPointError(f"NaN in {what} (debug_nans)")


# ------------------------------------------------------------------ spans
# records kept at most; about 200 bytes each
SPAN_CAPACITY = 1 << 16

_LOCK = threading.Lock()
_LOCAL = threading.local()
_RECORDS: deque = deque(maxlen=SPAN_CAPACITY)
_DROPPED = 0
_RECORDING = 0
_IDS = itertools.count()
_REQUESTS = itertools.count()
_profiler_on = torch._C._autograd._profiler_enabled


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class Span:
    """One span's record (the module docstring says what it holds); the
    context manager :func:`span` returns while spans record."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "request",
                 "thread", "attrs", "_annotation")

    def __init__(self, name: str, request, attrs: dict):
        self.name, self.request, self.attrs = name, request, attrs
        self.id = self.parent = self.thread = None
        self.start_ns = self.end_ns = self._annotation = None

    def set(self, **attrs) -> None:
        """Add attributes before the span closes."""
        self.attrs.update(attrs)

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = None if top is None else top.id
        if self.request is None:
            self.request = (next(_REQUESTS) if top is None
                            else top.request)
        self.thread = threading.get_ident()
        if _profiler_on():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _DROPPED
        self.end_ns = time.time_ns()
        _stack().pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        with _LOCK:
            if len(_RECORDS) == _RECORDS.maxlen:
                _DROPPED += 1
            _RECORDS.append(self)
        return False


class _Off:
    """What :func:`span` returns while nothing records: takes attributes
    and keeps none, and is false, so that a caller can skip work that only
    an attribute needs."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, request=None, **attrs):
    """A context manager around one stage, yielding its record (a
    :class:`Span`, or a false stand-in while nothing records). ``request``
    names the request on a thread that has no span of it open (a worker
    thread); ``attrs`` are numeric attributes, more of which
    ``record.set`` adds before the span closes."""
    if not (_RECORDING or _profiler_on()):
        return _OFF
    return Span(name, request, attrs)


def current_request():
    """The request of the span open on this thread, None if there is none
    or nothing records: what a task handed to another thread passes as
    :func:`span`'s ``request``."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1].request if stack else None


@contextlib.contextmanager
def recording():
    """Spans record inside the block, with or without a profiler."""
    global _RECORDING
    with _LOCK:
        _RECORDING += 1
    try:
        yield
    finally:
        with _LOCK:
            _RECORDING -= 1


def records() -> list:
    """The buffer's records, oldest first (each added when it closed)."""
    with _LOCK:
        return list(_RECORDS)


def dropped() -> int:
    """How many records the bounded buffer has dropped."""
    return _DROPPED


def clear_records() -> None:
    """Empty the buffer and its count of dropped records."""
    global _DROPPED
    with _LOCK:
        _RECORDS.clear()
        _DROPPED = 0


def self_seconds(recs) -> dict:
    """Seconds of self time by span name over ``recs``: each span's
    duration less the union of its children's intervals among ``recs``."""
    kids = defaultdict(list)
    for r in recs:
        if r.parent is not None:
            kids[r.parent].append((r.start_ns, r.end_ns))
    out = defaultdict(float)
    for r in recs:
        covered, end = 0, r.start_ns
        for a, b in sorted(kids.get(r.id, ())):
            a, b = max(a, end), min(b, r.end_ns)
            if b > a:
                covered += b - a
                end = b
        out[r.name] += (r.duration_ns - covered) * 1e-9
    return dict(out)
