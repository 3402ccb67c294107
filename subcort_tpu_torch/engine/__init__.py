"""Workload layer: inference by the dense evaluator or the patch engine,
by FastSurferCNN's three views, by SynthSeg's 3D U-Net or by SwinUNETR's
sliding windows, training, and the leave-one-out driver."""

from subcort_tpu_torch.engine.data import (  # noqa: F401
    Subject,
    TrainingIndex,
    build_training_index,
    generate_training_set,
    leave_one_out,
    list_training_subjects,
    load_data,
)
from subcort_tpu_torch.engine.forward import forward_centers  # noqa: F401
from subcort_tpu_torch.engine.infer import (  # noqa: F401
    SegmentationEngine,
    candidate_centers,
    load_test_names,
    net_in_dtype,
    segment_volume,
    test_scan,
)
from subcort_tpu_torch.engine.loo import (  # noqa: F401
    evaluate_fold,
    fold_view,
    run_loo,
)
from subcort_tpu_torch.engine.metrics import (  # noqa: F401
    ScanStats,
    dice_per_class,
    mean_dice,
)
from subcort_tpu_torch.engine.postprocess import (  # noqa: F401
    post_process_segmentation,
)
from subcort_tpu_torch.engine.swinunetr import segment_swinunetr  # noqa
from subcort_tpu_torch.engine.synthseg import segment_synthseg  # noqa: F401
from subcort_tpu_torch.engine.views import segment_views  # noqa: F401
from subcort_tpu_torch.engine.train import (  # noqa: F401
    Trainer,
    train_split_stratified,
)
