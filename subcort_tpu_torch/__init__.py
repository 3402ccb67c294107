"""subcort_tpu_torch — the PyTorch / CUDA port of subcort_tpu.

Laid out module for module like ``subcort_tpu/``, which stays the
reference. This package imports torch, and nothing of jax or of the JAX
package: where it needs a jax-free module of that package (``config``'s
``Options`` contract, ``io``'s NIfTI), it keeps its own copy, which the
tests hold to the original.

Ported: the inference path, training, registration, the command line
and data parallelism; no option raises ``NotImplementedError``. Inference:
``SegmentationEngine`` / ``test_scan`` -> ``segment_volume`` -> the dense
à-trous evaluator (``engine="fcn"``, what ``"auto"`` picks for a dense
candidate set) or the patch engine (chunked tri-planar gather -> CNN ->
argmax, the gather a hand-written CUDA kernel for Hopper,
``ops/csrc/gather_triplanar.cu``), in float32 or bfloat16. Training:
``build_training_index`` -> ``Trainer.fit`` (Adam, batch-statistics BN with
Lasagne's EMA, dropout, best-only Theano-format checkpoints through
``save_theano_checkpoint``), every step gathering its patches with the same
kernel in subject-stack mode, in float32 or ``train_dtype = bfloat16``.
Registration: a scan without its ``tmp/`` priors goes through
``registration.register_masks`` first: on the card by default
(``reg_backend = torch``: 12-dof affine, B-spline FFD, one-pass prior warp),
or by the C++ tools on the CPU where the caller asks for them
(``reg_backend = native``).
The command line is ``python -m subcort_tpu_torch.cli`` (train, infer,
run, evaluate, loo, import-atlas), as the JAX package's; leave-one-out is
``engine.loo.run_loo``; ``folder_pipeline = True`` pipelines the folder
sweep and ``cc_backend = device`` labels connected components on the card.
``data_parallel > 1`` runs over several devices (``parallel/``):
inference from one process, one host thread per device; training one
process per device, each step the one-process step on the global batch;
a multi-host folder sweep as one process group, each process taking its
share of the subjects. Entry points run on the card unless
``Options.mode`` asks for the CPU.
"""

__version__ = "0.1.0"

# what the JAX package's __init__ exports, less ``apply`` / ``apply_branch``
# (its functional forward: here ``TriPlanarNet``) and
# ``enable_compilation_cache`` (torch compiles nothing ahead of a run)
from subcort_tpu_torch.config import (Options, load_options,  # noqa: F401
                                      print_options, select_device)
from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii  # noqa: F401
from subcort_tpu_torch.engine import (  # noqa: F401
    SegmentationEngine,
    Subject,
    Trainer,
    TrainingIndex,
    build_training_index,
    evaluate_fold,
    fold_view,
    generate_training_set,
    leave_one_out,
    list_training_subjects,
    load_data,
    load_test_names,
    post_process_segmentation,
    run_loo,
    segment_volume,
    test_scan,
    train_split_stratified,
)
from subcort_tpu_torch.models import (  # noqa: F401
    TriPlanarNet,
    TriPlanarSpec,
    init_params,
    load_theano_checkpoint,
    num_params,
    params_from_jax,
    predict,
    predict_proba,
    predict_proba_chunked,
    save_theano_checkpoint,
    update_bn_ema,
)
from subcort_tpu_torch.ops import (  # noqa: F401
    HALF,
    PATCH,
    balanced_negative_sample,
    gather_atlas_vectors,
    gather_triplanar,
    get_mask_voxels,
    normalize_nonzero,
    normalize_stats,
    pad_volume,
    shuffle_consistent,
)
from subcort_tpu_torch.utils.runtime import (  # noqa: F401
    enable_nan_checks,
    profile_trace,
)
