"""Build helpers for the CUDA kernels, and runtime utilities (profiling,
NaN checks, timers)."""

from subcort_tpu_torch.utils.build import build_library, load_library  # noqa: F401
from subcort_tpu_torch.utils.runtime import (  # noqa: F401
    check_nans,
    enable_nan_checks,
    profile_trace,
    timer,
)
