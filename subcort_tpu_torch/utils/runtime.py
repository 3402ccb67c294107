"""Runtime utilities: profiling, NaN checks, timers (port of
subcort_tpu/utils/runtime.py).

``enable_compilation_cache`` has no counterpart: torch runs eagerly and
the port's kernels build once per source hash (``utils/build.py``).
"""

from __future__ import annotations

import contextlib
import os
import time

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


@contextlib.contextmanager
def timer(label: str, sink=None):
    """Wall-clock timer context; appends (label, seconds) to sink if given."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.append((label, dt))
    else:
        print(f"[timer] {label}: {dt:.3f}s")
