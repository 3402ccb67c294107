"""PyTorch port: the command line (``python -m subcort_tpu_torch.cli``)
against the JAX package's (``subcort_tpu.cli``), on the CPU (``mode = cpu``).

- The parser: the same subcommands, and per flag the same dest, default,
  choices and type.
- ``evaluate``: the same JSON lines as the JAX CLI on tests/test_cli.py's
  two fixtures.
- ``infer`` on two copies of one phantom folder, from one checkpoint that
  the JAX package's ``save_theano_checkpoint`` wrote from seeded params:
  ``out_subcortical_seg_prec.nii.gz`` array-equal, float32, with the dense
  evaluator (``use_fcn = True``) and the patch engine (``use_fcn = False``).
- ``run`` writes the checkpoint, the history and the segmentations.
- ``import-atlas``: the JAX CLI's return codes and installed arrays; 1 on
  an invalid atlas, 2 without its paths.
- ``--profile`` writes a trace; ``debug_nans`` with a NaN planted in one
  weight raises ``FloatingPointError`` from ``train``; a mode that asks
  for the card raises without one; the module runs with ``python -m``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from subcort_tpu.cli import _build_parser as jax_build_parser
from subcort_tpu.cli import main as jax_main
from subcort_tpu.io import NiftiImage, load_nii, save_nii
from subcort_tpu.models import init_params as jax_init_params
from subcort_tpu.models.importer import \
    save_theano_checkpoint as jax_save_checkpoint
from subcort_tpu_torch.cli import _build_parser, main
from subcort_tpu_torch.utils import runtime

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

CFG = """\
[database]
train_folder = {root}
inference_folder = {root}
t1_name = T1.nii.gz
roi_name = gt_15_classes.nii.gz
save_tmp = True

[model]
name = {name}
mode = {mode}
patch_size = 32
batch_size = 128
patience = 5
net_verbose = 0
max_epochs = 1
train_split = 0.25
test_batch_size = 256
load_weights = {load_weights}
out_probabilities = False
speedup_segmentation = True
post_process = {post_process}
debug = False

[tpu]
use_fcn = {use_fcn}
dilate_crop_iters = 2
debug_nans = {debug_nans}
seed = 3
"""


def _cfg(path, root, name="cli_v1", mode="cpu", load_weights=False,
         post_process=True, use_fcn=True, debug_nans=False):
    path.write_text(CFG.format(root=root, name=name, mode=mode,
                               load_weights=load_weights,
                               post_process=post_process, use_fcn=use_fcn,
                               debug_nans=debug_nans))
    return str(path)


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """The JAX CLI turns on JAX's persistent compilation cache: keep it
    inside the test session's temporary directory."""
    return str(tmp_path_factory.mktemp("jax_compile_cache"))


def _json_lines(out: str):
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


# ------------------------------------------------------------------ parser
def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     a.type, a.const, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_parser_contract_matches_jax_cli():
    got, want = _flags(_build_parser()), _flags(jax_build_parser())
    assert got == want
    assert got["command"][2] == ["train", "infer", "run", "evaluate", "loo",
                                 "import-atlas"]
    a = _build_parser().parse_args(["run", "--config", "x.cfg", "--augment",
                                    "--intensity-augment", "2"])
    assert (a.command, a.config, a.augment, a.intensity_augment) == \
        ("run", "x.cfg", True, 2.0)
    with pytest.raises(SystemExit):
        _build_parser().parse_args(["bogus"])


# ---------------------------------------------------------------- evaluate
def _evaluate_fixture(root, variant):
    """tests/test_cli.py's two fixtures: a perfect class-3 subject with a
    class-15 ring (seg_prec), or a 2/3 Dice subject and a subject without
    a segmentation (rawseg)."""
    one = np.ones((16, 16, 16), np.float32)
    gt = np.zeros((16, 16, 16), np.uint8)
    if variant == "seg_prec":
        (root / "s01").mkdir(parents=True)
        gt[4:9, 4:9, 4:9] = 3
        gt[10:12, 10:12, 10:12] = 15
        seg = np.zeros_like(gt)
        seg[4:9, 4:9, 4:9] = 3
        save_nii(NiftiImage(one), str(root / "s01" / "T1.nii.gz"))
        save_nii(NiftiImage(gt), str(root / "s01" / "gt_15_classes.nii.gz"))
        save_nii(NiftiImage(seg),
                 str(root / "s01" / "out_subcortical_seg_prec.nii.gz"))
        return
    gt[4:8, 4:8, 4:8] = 2
    for name in ("s01", "s02"):
        (root / name).mkdir(parents=True)
        save_nii(NiftiImage(one), str(root / name / "T1.nii.gz"))
        save_nii(NiftiImage(gt), str(root / name / "gt_15_classes.nii.gz"))
    seg = np.zeros_like(gt)
    seg[4:8, 4:8, 4:6] = 2
    save_nii(NiftiImage(seg),
             str(root / "s01" / "out_subcortical_rawseg.nii.gz"))


@pytest.mark.parametrize("variant", ["seg_prec", "rawseg"])
def test_evaluate_prints_the_jax_cli_lines(tmp_path, capsys, jax_cache,
                                           monkeypatch, variant):
    monkeypatch.setenv("SUBCORT_COMPILE_CACHE", jax_cache)
    _evaluate_fixture(tmp_path / "data", variant)
    cfg = _cfg(tmp_path / "configuration.cfg", tmp_path / "data",
               post_process=variant == "seg_prec")
    assert jax_main(["evaluate", "--config", cfg]) == 0
    want = capsys.readouterr().out
    assert main(["evaluate", "--config", cfg]) == 0
    got = capsys.readouterr().out
    assert _json_lines(got) == _json_lines(want)
    lines = _json_lines(got)
    assert lines[-1]["n_subjects"] == 1
    if variant == "rawseg":
        assert {"subject": "s02", "skipped": True} in lines
        assert lines[0]["mean_dice"] == pytest.approx(2 / 3, abs=1e-3)


# ------------------------------------------------------------------- infer
def _phantom_folder(root, seed=1234):
    """tests/test_torch_engine.py's phantom (a few hundred candidates after
    the dilation), as two subjects with their own scans."""
    rng = np.random.default_rng(seed)
    image = (rng.random((36, 40, 32)) * 800 + 100).astype(np.int16)
    image[:4] = 0
    atlas = rng.random((36, 40, 32, 15)).astype(np.float32)
    atlas /= atlas.sum(axis=-1, keepdims=True)
    mask = np.zeros((36, 40, 32), np.uint8)
    mask[16:20, 18:22, 14:18] = 1
    for i, s in enumerate(("s1", "s2")):
        (root / s / "tmp").mkdir(parents=True)
        save_nii(NiftiImage(np.roll(image, 2 * i, axis=1)),
                 str(root / s / "T1.nii.gz"))
        save_nii(NiftiImage(atlas),
                 str(root / s / "tmp" / "MNI_sub_probabilities.nii.gz"))
        save_nii(NiftiImage(mask),
                 str(root / s / "tmp" / "MNI_subcortical_mask.nii.gz"))


@pytest.mark.parametrize("use_fcn", [True, False])
def test_infer_matches_jax_cli_from_one_checkpoint(tmp_path, capsys,
                                                   jax_cache, monkeypatch,
                                                   use_fcn):
    monkeypatch.setenv("SUBCORT_COMPILE_CACHE", jax_cache)
    weights = tmp_path / "nets"
    (weights / "cli_v1").mkdir(parents=True)
    jax_save_checkpoint(jax_init_params(jax.random.key(7)),
                        str(weights / "cli_v1" / "cli_v1.pkl"))
    outs = {}
    for side, run in (("jax", jax_main), ("port", main)):
        _phantom_folder(tmp_path / side)
        cfg = _cfg(tmp_path / f"{side}.cfg", tmp_path / side,
                   use_fcn=use_fcn)
        assert run(["infer", "--config", cfg,
                    "--weights-path", str(weights)]) == 0
        outs[side] = capsys.readouterr().out
    assert "--> loading weights from" in outs["port"]
    assert "--> scan s1 segmented in" in outs["port"]
    for s in ("s1", "s2"):
        got = load_nii(str(tmp_path / "port" / s /
                           "out_subcortical_seg_prec.nii.gz"))
        want = load_nii(str(tmp_path / "jax" / s /
                            "out_subcortical_seg_prec.nii.gz"))
        assert got.data.dtype == want.data.dtype
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.affine, want.affine)
        assert (got.data != 0).any()


# --------------------------------------------------------------------- run
@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    from subcort_tpu_torch.registration import make_synthetic_cohort

    root = tmp_path_factory.mktemp("cli_cohort") / "cohort"
    make_synthetic_cohort(str(root), n_subjects=2, shape=(32, 36, 30),
                          seed=2, noise=4.0, prior_error=0)
    return root


def test_run_writes_checkpoint_history_and_segmentations(cohort, tmp_path,
                                                         capsys):
    cfg = _cfg(tmp_path / "configuration.cfg", cohort)
    weights = tmp_path / "nets"
    assert main(["run", "--config", cfg, "--weights-path", str(weights)]) == 0
    out = capsys.readouterr().out
    for line in ("--> loading training data", "--> training",
                 "--> scan s00 segmented in", "--> scan s01 segmented in"):
        assert line in out
    exp = weights / "cli_v1"
    for f in ("cli_v1.pkl", "cli_v1_history.jsonl", "cli_v1_history.pkl",
              "cli_v1_state.pkl"):
        assert (exp / f).exists(), f
    history = [json.loads(l) for l in
               (exp / "cli_v1_history.jsonl").read_text().splitlines()]
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    for s in ("s00", "s01"):
        seg = load_nii(str(cohort / s / "out_subcortical_seg_prec.nii.gz"))
        assert seg.data.shape == (32, 36, 30)
    # the Dice of what run wrote, through evaluate: one line per subject
    assert main(["evaluate", "--config", cfg]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert [l["subject"] for l in lines[:2]] == ["s00", "s01"]
    assert lines[-1]["n_subjects"] == 2


def test_debug_nans_raises_from_train(cohort, tmp_path):
    """A NaN planted in one weight of the warm-start checkpoint: with
    ``debug_nans = True`` the first train step raises FloatingPointError
    instead of training on NaN."""
    from subcort_tpu_torch.models import init_params, save_theano_checkpoint

    params = init_params(generator=torch.Generator().manual_seed(0))
    params["fc1.weight"][0, 0] = float("nan")
    (tmp_path / "nets" / "nan_exp").mkdir(parents=True)
    save_theano_checkpoint(params, str(tmp_path / "nets" / "nan_exp" /
                                       "nan_exp.pkl"))
    cfg = _cfg(tmp_path / "configuration.cfg", cohort, name="nan_exp",
               load_weights=True, debug_nans=True)
    try:
        with pytest.raises(FloatingPointError, match="NaN in the train loss"):
            main(["train", "--config", cfg,
                  "--weights-path", str(tmp_path / "nets")])
        assert runtime.NAN_CHECKS and torch.is_anomaly_enabled()
    finally:
        runtime.NAN_CHECKS = False
        torch.autograd.set_detect_anomaly(False)


@pytest.mark.parametrize("engine", ["fcn", "patch"])
def test_nan_checks_cover_inference(engine):
    """With the checks on, a NaN weight raises FloatingPointError from
    segment_volume in either engine (the dense evaluator's logits, the
    patch engine's probabilities); with them off it returns labels."""
    from subcort_tpu_torch.engine import segment_volume
    from subcort_tpu_torch.models import TriPlanarNet, init_params

    rng = np.random.default_rng(5)
    image = (rng.random((24, 26, 22)) * 800 + 100).astype(np.int16)
    atlas = rng.random((24, 26, 22, 15)).astype(np.float32)
    centers = np.array([[10, 12, 11], [11, 12, 11]], np.int32)
    params = init_params(generator=torch.Generator().manual_seed(0))
    params["fc1.weight"][0, 0] = float("nan")
    net = TriPlanarNet.from_params(params, device="cpu")
    segment_volume(net, image, atlas, centers, engine=engine)
    runtime.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError, match="NaN in the"):
            segment_volume(net, image, atlas, centers, engine=engine)
    finally:
        runtime.NAN_CHECKS = False
        torch.autograd.set_detect_anomaly(False)


def test_nan_checks_are_off_by_default(cohort, tmp_path):
    """Without debug_nans nothing checks (no device read back per step)."""
    assert not runtime.NAN_CHECKS
    runtime.check_nans("anything", torch.tensor([float("nan")]))


# ----------------------------------------------------------- import-atlas
def test_import_atlas_matches_jax_cli(tmp_path, capsys, jax_cache,
                                      monkeypatch):
    from subcort_tpu_torch.registration import make_synthetic_atlas

    monkeypatch.setenv("SUBCORT_COMPILE_CACHE", jax_cache)
    make_synthetic_atlas(str(tmp_path / "src"), shape=(24, 28, 22))
    tmpl = str(tmp_path / "src" / "T1_template.nii.gz")
    atlas = str(tmp_path / "src" / "atlas_subcortical_MNI.nii.gz")
    for side, run in (("jax", jax_main), ("port", main)):
        rc = run(["import-atlas", "--template", tmpl, "--atlas", atlas,
                  "--atlas-dir", str(tmp_path / side)])
        assert rc == 0
        assert f"--> atlas assets installed into {tmp_path / side}" in \
            capsys.readouterr().out
    for name in ("T1_template.nii.gz", "atlas_subcortical_MNI.nii.gz"):
        got = load_nii(str(tmp_path / "port" / name))
        want = load_nii(str(tmp_path / "jax" / name))
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.affine, want.affine)

    # an atlas with 14 channels is refused by both, with return code 1
    bad = str(tmp_path / "bad_atlas.nii.gz")
    save_nii(NiftiImage(load_nii(atlas).data[..., :14]), bad)
    for side, run in (("jax", jax_main), ("port", main)):
        assert run(["import-atlas", "--template", tmpl, "--atlas", bad,
                    "--atlas-dir", str(tmp_path / (side + "_bad"))]) == 1
        assert "atlas validation failed" in capsys.readouterr().err
    assert main(["import-atlas", "--template", tmpl]) == 2


# -------------------------------------------------------- profile, device
def test_profile_writes_a_trace(tmp_path, capsys):
    weights = tmp_path / "nets"
    (weights / "cli_v1").mkdir(parents=True)
    from subcort_tpu_torch.models import init_params, save_theano_checkpoint
    save_theano_checkpoint(init_params(
        generator=torch.Generator().manual_seed(1)),
        str(weights / "cli_v1" / "cli_v1.pkl"))
    _phantom_folder(tmp_path / "data")
    cfg = _cfg(tmp_path / "configuration.cfg", tmp_path / "data")
    trace_dir = tmp_path / "trace"
    assert main(["infer", "--config", cfg, "--weights-path", str(weights),
                 "--profile", str(trace_dir)]) == 0
    assert f"[profile] trace written to {trace_dir}" in \
        capsys.readouterr().out
    traces = list(trace_dir.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


def test_a_mode_that_asks_for_the_card_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = _cfg(tmp_path / "configuration.cfg", tmp_path, mode="cuda0")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["infer", "--config", cfg])


def test_module_entry_point_runs(tmp_path):
    """``python -m subcort_tpu_torch.cli``: the parser's help, and an
    evaluate over a folder with nothing to score."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "subcort_tpu_torch.cli",
                           "--help"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "import-atlas" in proc.stdout
    (tmp_path / "s01").mkdir()
    cfg = _cfg(tmp_path / "configuration.cfg", tmp_path)
    proc = subprocess.run([sys.executable, "-m", "subcort_tpu_torch.cli",
                           "evaluate", "--config", cfg], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert _json_lines(proc.stdout) == [{"subject": "s01", "skipped": True}]
