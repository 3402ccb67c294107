"""Registration (layer L2): the orchestrator ``register_masks`` with its
on-device (``"torch"``, the default) and native (C++ tools) backends, the
resamplers, and the atlas assets with their synthetic generators."""

from subcort_tpu_torch.registration.atlas import (  # noqa: F401
    make_synthetic_atlas,
    make_synthetic_cohort,
)
from subcort_tpu_torch.registration.driver import (  # noqa: F401
    RegistrationError,
    register_masks,
)
from subcort_tpu_torch.registration.torch_backend import (  # noqa: F401
    load_cpp_grid,
    resample_through_affine,
    resample_through_cpp,
)
