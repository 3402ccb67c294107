"""Data-path ops: normalization, voxel enumeration and the tri-planar
gather (plain version and CUDA kernel)."""

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
    gather_triplanar,
    gather_triplanar_subjects,
    pad_volume,
)
from subcort_tpu_torch.ops.sampling import get_mask_voxels  # noqa: F401
