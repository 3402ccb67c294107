"""Build helpers for the CUDA kernels."""

from subcort_tpu_torch.utils.build import build_library, load_library  # noqa: F401
