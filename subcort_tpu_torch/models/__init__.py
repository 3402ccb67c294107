"""The tri-planar CNN and its checkpoint importers."""

from subcort_tpu_torch.models.importer import (  # noqa: F401
    load_theano_checkpoint,
    params_from_jax,
)
from subcort_tpu_torch.models.triplanar import (  # noqa: F401
    DEFAULT_SPEC,
    TriPlanarNet,
    TriPlanarSpec,
    init_params,
    num_params,
)
