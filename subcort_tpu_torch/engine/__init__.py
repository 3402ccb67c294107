"""Workload layer: inference by the dense evaluator or the patch engine."""

from subcort_tpu_torch.engine.forward import forward_centers  # noqa: F401
from subcort_tpu_torch.engine.infer import (  # noqa: F401
    SegmentationEngine,
    candidate_centers,
    load_test_names,
    net_in_dtype,
    segment_volume,
    test_scan,
)
from subcort_tpu_torch.engine.metrics import (  # noqa: F401
    ScanStats,
    dice_per_class,
    mean_dice,
)
from subcort_tpu_torch.engine.postprocess import (  # noqa: F401
    post_process_segmentation,
)
