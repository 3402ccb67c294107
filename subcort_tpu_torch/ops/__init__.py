"""Data-path ops: normalization, voxel sampling, the tri-planar gather
(plain version, numpy twin and CUDA kernel), the prior-vector gather and
connected components."""

from subcort_tpu_torch.ops.connected import (  # noqa: F401
    label_components_device,
    label_components_np,
)
from subcort_tpu_torch.ops.gather_kernel import (  # noqa: F401
    GatherVolume,
    gather_roofline_bytes,
    gather_triplanar_cuda,
    prepare_gather_volume,
)
from subcort_tpu_torch.ops.normalize import (normalize_nonzero,  # noqa: F401
                                             normalize_stats)
from subcort_tpu_torch.ops.patches import (  # noqa: F401
    HALF,
    PATCH,
    gather_atlas_vectors,
    gather_triplanar,
    gather_triplanar_np,
    gather_triplanar_subjects,
    pad_volume,
)
from subcort_tpu_torch.ops.sampling import (  # noqa: F401
    balanced_negative_sample,
    get_mask_voxels,
    shuffle_consistent,
)
