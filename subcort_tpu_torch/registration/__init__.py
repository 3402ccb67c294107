"""Registration: so far only the synthetic phantom cohort (numpy), which
training runs on without the JAX package. On-device registration is
ROADMAP.md queue A item 7."""

from subcort_tpu_torch.registration.atlas import (  # noqa: F401
    make_synthetic_atlas,
    make_synthetic_cohort,
)
