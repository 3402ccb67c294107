"""Configuration and device selection for the PyTorch port.

:class:`Options` and :func:`load_options` are the port's own copy of
subcort_tpu/config.py (its ``Options``, ``load_options`` and
``print_options``): the reference's ``configuration.cfg`` contract with the
same sections, key names and defaults (cnn_cort/load_options.py:11-59,
configuration.cfg:1-23). tests/test_torch_config.py holds the two to the
same options, apart from two defaults: ``reg_backend`` is ``"torch"`` here
(registration on the device ``mode`` names) where the JAX package's is
``"native"`` (the C++ tools on the CPU), because the port's entry points run
on the card unless the caller asks for the CPU; and ``cc_backend`` is
``"auto"`` (the post-process's component filter on the card where the
engine runs on one, else scipy) where the JAX package's is ``"scipy"``. Booleans arrive as the strings ``'True'``/``'False'`` and are
read with the same tolerance; a dict-style ``options['patch_size']`` view
sits beside the typed fields.

What differs is the backend mapping of the reference's ``mode`` key
(load_options.py:54-57): the JAX package maps it onto ``JAX_PLATFORMS``
(``select_platform``, which has no counterpart here); the port turns it
into an explicit ``torch.device`` (:func:`select_device`) that callers pass
down. ``mode`` still defaults to ``"tpu"``, which selects ``cuda:0``.
"""

from __future__ import annotations

import configparser
import contextlib
import dataclasses
import os
import re
import threading
from typing import Any, Iterator, Mapping

import torch


def _as_bool(v: Any) -> bool:
    """String-boolean tolerance: the reference keeps booleans as 'True'/'False'."""
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes", "on")
    return bool(v)


@dataclasses.dataclass
class Options(Mapping[str, Any]):
    """Typed options with the reference's flat-dict key contract.

    Key names follow cnn_cort/load_options.py:24-51 exactly so that code
    written against the reference's ``options`` dict ports over unchanged.
    """

    # [database]
    experiment: str = "experiment"
    train_folder: str = ""
    test_folder: str = ""           # reference key: inference_folder in the cfg
    output_folder: str = ""
    current_scan: str = ""
    t1_name: str = "T1.nii.gz"
    roi_name: str = "gt_15_classes.nii.gz"
    out_name: str = "out_seg.nii.gz"
    save_tmp: bool = True

    # [model]
    mode: str = "tpu"               # cpu | cudaN | gpuN | tpu: see select_device
    patch_size: tuple = (32, 32)
    weight_paths: str | None = None
    train_split: float = 0.25
    max_epochs: int = 100
    patience: int = 20
    batch_size: int = 256
    test_batch_size: int = 100000
    net_verbose: int = 1
    load_weights: bool = True
    randomize_train: bool = True
    debug: bool = True
    out_probabilities: bool = False
    post_process: bool = True
    crop: bool = True               # reference cfg key: speedup_segmentation

    # --- TPU-native extensions (no reference analogue; defaults preserve
    #     reference behavior) -------------------------------------------------
    seed: int = 42                  # replaces the reference's unseeded RNG (base.py:322-328)
    compute_dtype: str = "float32"  # float32 | bfloat16 for the forward pass
    data_parallel: int = 1          # devices of data parallelism (parallel/): inference fans out over them, training runs a rank on each
    use_fcn: bool = True            # à-trous fully-convolutional fast path
    bugcompat_postprocess_argmax: bool = False  # reproduce base.py:474 quirk (§2.3-7)
    dilate_crop_iters: int = 10     # base.py:369 binary_dilation(iterations=10)
    prior_dtype: str = "uint16"     # host->device prior wire: uint16 (fixed-point, most accurate+fastest) | float16 | uint8 | float32
    probs_dtype: str = "uint8"      # device->host probability readback wire: uint8 (1/255-step fixed-point, half the bytes — labels are computed on device and unaffected) | float16 | float32 for full-precision prob maps
    cc_backend: str = "auto"        # post-process component filter: auto (device where the engine's device is a card, else scipy; the default, and a default that differs from the JAX package's "scipy") | scipy (host, per class) | device (every class at once: the CUDA kernel on a card, min-label propagation on the CPU)
    folder_pipeline: bool = False   # pipelined folder sweep: one loader thread prefetches the next scan's host prep, one writer thread post-processes and writes the last (identical files; pays only where the host has spare cores)
    fcn_max_bbox_voxels: int = 6_000_000  # dense-evaluator sub-slab budget
    fcn_spmd: bool = True           # multi-device dense engine: one equal sub-slab of the candidate bbox per device (False: sub-bboxes of at most bbox/devices voxels dealt round-robin)
    debug_nans: bool = False        # raise FloatingPointError on the first NaN in a loss, logits or probabilities read back (debug only; utils.runtime.enable_nan_checks)
    reg_backend: str = "torch"      # registration: torch (on the device ``mode`` names; the default, and a default that differs from the JAX package's "native") | native (the C++ tools on the CPU, opt-in); the JAX package's "jax" raises here
    reg_similarity: str = "nmi"     # deformable-stage cost: nmi (default — the reference's reg_f3d is NiftyReg's NMI-driven FFD, base.py:516-521) | ssd (opt-in; wins on same-protocol pairs)
    train_dtype: str = "float32"    # training forward/backward: float32 | bfloat16 (f32 master)
    intensity_augment: float = 0.0  # train-time intensity-robustness augmentation strength S (0 = off = reference-exact; 2.0 = validated sweet spot, see ROBUSTQUAL_AUG_r05.json); per-sample gain/shift shared across views + per-voxel noise — hardens the CNN against bias-field/remap/Rician covariate shift (see engine/train.py::_augment_intensity)

    # ------------------------------------------------------------------ dict view
    def __getitem__(self, key: str) -> Any:
        if not hasattr(self, key):
            raise KeyError(key)
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> None:
        if not hasattr(self, key):
            raise KeyError(key)
        setattr(self, key, value)

    def __iter__(self) -> Iterator[str]:
        return iter(f.name for f in dataclasses.fields(self))

    def __len__(self) -> int:
        return len(dataclasses.fields(self))

    # ------------------------------------------------------------- typed helpers
    def bool(self, key: str) -> bool:
        return _as_bool(self[key])

    def asdict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def load_options(user_config: configparser.RawConfigParser | str | os.PathLike) -> Options:
    """Map a ``configuration.cfg`` into :class:`Options`.

    Mirrors cnn_cort/load_options.py:11-59 (same keys, same sections, same
    defaults), minus its side effect of mutating ``THEANO_FLAGS`` — device
    selection is explicit here via :func:`select_device`.

    Deliberate deviation (pinned in tests/test_config.py for the JAX package): the reference
    raises ``NoOptionError`` on any missing cfg key (bare ``get``,
    load_options.py:24-51); here missing keys fall back to the documented
    defaults so partial configs work. Present keys are read with identical
    semantics.

    Accepts either an already-read RawConfigParser (reference calling
    convention, train_model.py:23-26) or a path to the cfg file.
    """
    if not isinstance(user_config, configparser.RawConfigParser):
        path = os.fspath(user_config)
        cfg = configparser.RawConfigParser()
        with open(path) as fh:
            cfg.read_file(fh)
        user_config = cfg

    g = user_config.get
    gi = user_config.getint
    gf = user_config.getfloat

    def opt(section: str, key: str, default: Any, conv=None) -> Any:
        if user_config.has_option(section, key):
            raw = g(section, key)
            return conv(raw) if conv else raw
        return default

    ps = int(opt("model", "patch_size", 32, int))
    o = Options(
        experiment=opt("model", "name", "experiment").strip(),
        train_folder=opt("database", "train_folder", ""),
        test_folder=opt("database", "inference_folder", ""),
        t1_name=opt("database", "t1_name", "T1.nii.gz"),
        roi_name=opt("database", "roi_name", "gt_15_classes.nii.gz"),
        save_tmp=_as_bool(opt("database", "save_tmp", True)),
        mode=opt("model", "mode", "tpu").strip(),
        patch_size=(ps, ps),
        train_split=float(opt("model", "train_split", 0.25, float)),
        max_epochs=int(opt("model", "max_epochs", 100, int)),
        patience=int(opt("model", "patience", 20, int)),
        batch_size=int(opt("model", "batch_size", 256, int)),
        test_batch_size=int(opt("model", "test_batch_size", 100000, int)),
        net_verbose=int(opt("model", "net_verbose", 1, int)),
        load_weights=_as_bool(opt("model", "load_weights", True)),
        debug=_as_bool(opt("model", "debug", True)),
        out_probabilities=_as_bool(opt("model", "out_probabilities", False)),
        post_process=_as_bool(opt("model", "post_process", True)),
        crop=_as_bool(opt("model", "speedup_segmentation", True)),
        # TPU-native extensions (optional keys in a [tpu] section)
        seed=int(opt("tpu", "seed", 42, int)),
        compute_dtype=opt("tpu", "compute_dtype", "float32").strip(),
        data_parallel=int(opt("tpu", "data_parallel", 1, int)),
        use_fcn=_as_bool(opt("tpu", "use_fcn", True)),
        bugcompat_postprocess_argmax=_as_bool(
            opt("tpu", "bugcompat_postprocess_argmax", False)),
        dilate_crop_iters=int(opt("tpu", "dilate_crop_iters", 10, int)),
        prior_dtype=opt("tpu", "prior_dtype", "uint16").strip(),
        probs_dtype=opt("tpu", "probs_dtype", "uint8").strip(),
        cc_backend=opt("tpu", "cc_backend", "auto").strip(),
        folder_pipeline=_as_bool(opt("tpu", "folder_pipeline", False)),
        fcn_max_bbox_voxels=int(opt("tpu", "fcn_max_bbox_voxels",
                                    6_000_000, int)),
        fcn_spmd=_as_bool(opt("tpu", "fcn_spmd", True)),
        debug_nans=_as_bool(opt("tpu", "debug_nans", False)),
        reg_backend=opt("tpu", "reg_backend", "torch").strip(),
        reg_similarity=opt("tpu", "reg_similarity", "nmi").strip(),
        train_dtype=opt("tpu", "train_dtype", "float32").strip(),
        intensity_augment=float(opt("tpu", "intensity_augment", 0.0, float)),
    )
    return o


def print_options(options: Options) -> None:
    """Reference-compatible options dump (load_options.py:62-72)."""
    print("-" * 50)
    print(" ")
    for k in options:
        print(k, ":", options[k])
    print("-" * 50)


def select_device(options: Options) -> torch.device:
    """Map ``mode`` to a ``torch.device``.

    ``cpu*`` -> CPU; ``cudaN`` / ``gpuN`` -> ``cuda:N``; ``gpu``, ``tpu`` and
    anything else -> ``cuda:0``. A CUDA device that is asked for and absent
    raises: the port never falls back to the CPU. The TF32 flags are left
    alone: ``segment_volume`` turns TF32 off for its own device work
    (:func:`exact_float32`).
    """
    mode = str(options.mode).strip().lower()
    if mode.startswith("cpu"):
        return torch.device("cpu")
    m = re.fullmatch(r"(?:cuda|gpu)(\d*)", mode)
    index = int(m.group(1)) if m and m.group(1) else 0
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"mode={options.mode!r} asks for a CUDA device, but torch sees "
            "none (set mode = cpu to run on the CPU)")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"mode={options.mode!r} asks for cuda:{index}, but only "
            f"{torch.cuda.device_count()} CUDA device(s) are present")
    return torch.device("cuda", index)


def resolve_device(device) -> torch.device:
    """The ``device`` argument of the port's functions: ``None`` is the
    default card, ``select_device(Options())``, which raises without one;
    anything else is the device the caller named."""
    if device is None:
        return select_device(Options())
    return torch.device(device)


# exact_float32's state: the flags are process-global, so the threads
# inside share one save and one restore
_FLOAT32_LOCK = threading.Lock()
_FLOAT32_DEPTH = 0
_FLOAT32_SAVED = (True, False)


@contextlib.contextmanager
def exact_float32():
    """Full float32 convolutions and matmuls (TF32 off) inside the block;
    the caller's flags come back afterwards.

    cuDNN runs float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32 = True``), a 10-bit mantissa, while
    the reference's exact path is full float32
    (subcort_tpu/models/triplanar.py ``Precision.HIGHEST``).

    The two flags are global to the process, and threads enter this block
    at once (the pipelined folder sweep registers a scan on its prefetch
    thread while the main thread segments): one lock and one count of the
    threads inside. The first in saves the flags and turns TF32 off, the
    last out restores them, and a thread in between touches nothing, so
    no thread's float32 work runs with TF32 back on.
    """
    global _FLOAT32_DEPTH, _FLOAT32_SAVED
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _FLOAT32_LOCK:
        if _FLOAT32_DEPTH == 0:
            _FLOAT32_SAVED = cudnn.allow_tf32, matmul.allow_tf32
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        _FLOAT32_DEPTH += 1
    try:
        yield
    finally:
        with _FLOAT32_LOCK:
            _FLOAT32_DEPTH -= 1
            if _FLOAT32_DEPTH == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _FLOAT32_SAVED
