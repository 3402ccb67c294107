"""The tri-planar CNN, its dense (à-trous) evaluator and its checkpoint
importers; FastSurferCNN's view networks; SynthSeg's 3D U-Net;
SwinUNETR."""

from subcort_tpu_torch.models.fastsurfer import (  # noqa: F401
    FastSurferCNN,
    FastSurferSpec,
    FastSurferViews,
)
from subcort_tpu_torch.models.fcn import (  # noqa: F401
    dense_branch_features,
    fcn_forward_bbox,
    fcn_forward_slab,
    slab_flops,
)
from subcort_tpu_torch.models.importer import (  # noqa: F401
    load_theano_checkpoint,
    params_from_jax,
    save_theano_checkpoint,
)
from subcort_tpu_torch.models.swinunetr import (  # noqa: F401
    SwinUNETR,
    SwinUNETRSpec,
)
from subcort_tpu_torch.models.synthseg import (  # noqa: F401
    SynthSegSpec,
    SynthSegUNet,
)
from subcort_tpu_torch.models.triplanar import (  # noqa: F401
    DEFAULT_SPEC,
    TriPlanarNet,
    TriPlanarSpec,
    init_params,
    num_params,
    predict,
    predict_proba,
    predict_proba_chunked,
    update_bn_ema,
)
