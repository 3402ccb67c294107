"""PyTorch port: the benchmarks (``subcort_tpu_torch/bench/``) held to the
originals at the repo root (``bench_reg.py``, ``bench_train.py``,
``bench_trainqual.py``, ``bench_robust.py``, and ``bench.py`` for
``bench/scan.py``, whose runs tests/test_torch_bench_scan.py holds), on the
CPU at small sizes.

Tolerances: the phantoms and the synthetic index are array-equal (the
same numpy and scipy calls on the same seeds); the JSON keys and the
floors are equal; ``structure_dice`` on one control grid and
``evaluate_holdout`` from the same params each equal to 1e-12 (the warped
masks and the float32 labels are the same in both packages, so the Dice
is the same number).
"""

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from subcort_tpu_torch.bench import reg, robust, scan, train, trainqual
from subcort_tpu_torch.config import Options

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # the originals live at the repo root

import bench_reg  # noqa: E402
import chip_smoke  # noqa: E402
import bench_robust  # noqa: E402
import bench_trainqual  # noqa: E402

SMALL = (24, 28, 22)
CPU = torch.device("cpu")
NARROW = dict(conv_filters=(8, 8, 8, 8, 8), fc_conv=16, fc_fc=16, fc2=16)


def _dumped_keys(path: Path) -> list:
    """The string keys of every dict literal in ``path`` that is printed
    as a JSON line (``json.dumps(<dict>)``, or ``json.dumps(name)`` of a
    name assigned a dict literal in the same function), one sorted list
    per printed dict, ``**`` branches included."""
    def keys(d: ast.Dict) -> set:
        out = set()
        for k, v in zip(d.keys, d.values):
            if k is None:  # **(... if ... else {}) or **name
                for sub in ast.walk(v):
                    if isinstance(sub, ast.Dict):
                        out |= keys(sub)
            elif isinstance(k, ast.Constant):
                out.add(k.value)
        return out

    found = []
    for fn in ast.walk(ast.parse(path.read_text())):
        if not isinstance(fn, ast.FunctionDef):
            continue
        named = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Dict)):
                named[node.targets[0].id] = node.value
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "dumps"):
                arg = node.args[0]
                d = named.get(arg.id) if isinstance(arg, ast.Name) else arg
                if isinstance(d, ast.Dict):
                    found.append(sorted(keys(d)))
    return sorted(found)


BENCHMARKS = ["reg", "train", "trainqual", "robust", "scan"]


def _original(name: str) -> Path:
    """The original of ``bench/<name>.py`` at the repo root."""
    return REPO / ("bench.py" if name == "scan" else f"bench_{name}.py")


@pytest.mark.parametrize("name", BENCHMARKS)
def test_json_lines_carry_the_original_keys(name):
    """Every JSON line a benchmark prints has the keys of the original's
    line (both sources, parsed)."""
    port = REPO / "subcort_tpu_torch" / "bench" / f"{name}.py"
    original = _original(name)
    want = _dumped_keys(original)
    assert want, f"no JSON line found in {original.name}"
    assert _dumped_keys(port) == want


@pytest.mark.parametrize("name", BENCHMARKS)
def test_chip_smoke_key_copies_equal_the_originals(name):
    """chip_smoke.py's BENCH_KEYS (copies, since the originals import jax)
    hold the keys of each line the original prints: ``<name>`` and
    ``<name>_<line>`` entries."""
    copies = sorted(keys for which, keys in chip_smoke.BENCH_KEYS.items()
                    if which == name or which.startswith(name + "_"))
    assert copies == _dumped_keys(_original(name))


def test_floors_and_constants_equal_the_originals():
    assert (reg.DICE_FLOOR, reg.MIN_JAC_FLOOR) == (
        bench_reg.DICE_FLOOR, bench_reg.MIN_JAC_FLOOR)
    assert (trainqual.DICE_FLOOR, trainqual.VALID_ACC_FLOOR,
            trainqual.REFERENCE_VALID_ACC) == (
        bench_trainqual.DICE_FLOOR, bench_trainqual.VALID_ACC_FLOOR,
        bench_trainqual.REFERENCE_VALID_ACC)
    assert robust.FLOORS == bench_robust.FLOORS
    # bench_train.py sets up the JAX cache when imported: read its constant
    tree = ast.parse((REPO / "bench_train.py").read_text())
    consts = {n.targets[0].id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.targets[0],
                                                          ast.Name)
              and isinstance(n.value, ast.Constant)}
    assert train.REFERENCE_EPOCH_SECONDS == consts["REFERENCE_EPOCH_SECONDS"]


# ------------------------------------------------------------ bench/reg.py
def test_reg_phantoms_array_equal_to_the_originals():
    for got, want in zip(reg.make_phantom(shape=SMALL, seed=3),
                         bench_reg.make_phantom(shape=SMALL, seed=3)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for got, want in zip(reg.make_affine_phantom(shape=SMALL, seed=3),
                         bench_reg.make_affine_phantom(shape=SMALL, seed=3)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_structure_dice_equals_the_original_on_one_grid():
    """The port's ``structure_dice`` (14 channels in one pass) against the
    original's (a channel at a time, through the JAX resampler) on the
    phantom's known warp, sampled as a seeded smooth control grid, and on
    the identity grid."""
    from subcort_tpu.registration.jax_backend import CppGrid as JaxGrid
    from subcort_tpu_torch.registration.torch_backend import CppGrid

    template, subject, _, atlas, gt = bench_reg.make_phantom(shape=SMALL)
    nc = tuple(int(np.ceil((d - 1) / 6.0)) + 4 for d in SMALL)
    rng = np.random.default_rng(0)
    for disp in (np.zeros(nc + (3,), np.float32),
                 (rng.standard_normal(nc + (3,)) * 1.5).astype(np.float32)):
        want = bench_reg.structure_dice(JaxGrid(disp, 6.0, np.eye(4)), atlas,
                                        gt)
        got = reg.structure_dice(CppGrid(disp, 6.0, np.eye(4)), atlas, gt,
                                 CPU)
        assert 0.0 < want < 1.0
        assert abs(got - want) <= 1e-12, (got, want)


# ---------------------------------------------------------- bench/train.py
def test_make_index_array_equal_to_the_original():
    import bench_train

    got = train.make_index(512, n_subjects=2, shape=(20, 22, 18))
    want = bench_train.make_index(512, n_subjects=2, shape=(20, 22, 18))
    for field in ("volumes", "centers", "labels", "atlas"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and np.array_equal(g, w), field
    assert list(got.subject_names) == list(want.subject_names)


def test_train_main_prints_one_line_of_the_original_keys(capsys):
    """``bench/train.py`` at tests/test_aux.py's toy scale (which runs
    the original so), on the CPU: one JSON line with the original's
    keys."""
    rec = train.main(["--samples", "512", "--epochs", "2", "--batch", "64",
                      "--mode", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines == [rec]
    assert sorted(rec) == _dumped_keys(REPO / "bench_train.py")[0]
    assert rec["metric"] == "train_epoch_wallclock"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["epochs"] == 2 and rec["batch_size"] == 64
    assert rec["device"] == "cpu"


# ------------------------------------------------------ bench/trainqual.py
def test_evaluate_holdout_equals_the_original(tmp_path):
    """One 48x54x44 cohort subject (tests/test_trainqual.py's phantom)
    through both ``evaluate_holdout``s from the same full-width params."""
    import jax

    from subcort_tpu.config import Options as JaxOptions
    from subcort_tpu.models import init_params as jax_init_params
    from subcort_tpu_torch.models import (DEFAULT_SPEC, TriPlanarNet,
                                          params_from_jax)
    from subcort_tpu_torch.registration.atlas import make_synthetic_cohort

    make_synthetic_cohort(str(tmp_path), n_subjects=1, shape=(48, 54, 44),
                          seed=1, noise=4.0, prior_error=0)
    sub = str(next(p for p in tmp_path.iterdir() if p.is_dir()))
    jparams = jax_init_params(jax.random.key(0))
    want = bench_trainqual.evaluate_holdout(jparams, sub, JaxOptions())
    net = TriPlanarNet.from_params(params_from_jax(jparams, DEFAULT_SPEC),
                                   DEFAULT_SPEC, CPU)
    got = trainqual.evaluate_holdout(net, sub, Options(mode="cpu"))
    assert want > 0.0  # the labels hold structures, not background only
    assert abs(got - want) <= 1e-12, (got, want)


# --------------------------------------------------------- bench/robust.py
def test_robust_run_registers_on_the_cpu_and_scores(tmp_path, monkeypatch,
                                                    capsys):
    """One ``run`` with one kind, ``combined`` (bias field, Rician noise,
    gamma remap, oblique sform and int16/scl storage at once), at a
    32x36x30 phantom with a narrow seeded net given as ``train_params``:
    the default pipeline registers the scan with the torch backend on the
    CPU (the six ``tmp/`` files), segments, post-processes and scores. The
    registered priors' argmax labels reach a Dice of at least 0.80 against
    the GT (0.87 measured; the unregistered atlas scores lower), and the
    printed lines carry the original's keys."""
    from subcort_tpu_torch.engine.metrics import mean_dice
    from subcort_tpu_torch.io import load_nii
    from subcort_tpu_torch.models import TriPlanarNet, TriPlanarSpec, \
        init_params

    # run() points SUBCORT_ATLAS_DIR at its own atlas: restore it after
    monkeypatch.setenv("SUBCORT_ATLAS_DIR", str(tmp_path))
    spec = TriPlanarSpec(**NARROW)
    net = TriPlanarNet.from_params(
        init_params(spec, torch.Generator().manual_seed(0)), spec, CPU)
    records, summary = robust.run(
        shape=(32, 36, 30), seed=1, root=str(tmp_path), kinds=["combined"],
        sample_floors={"combined": 0.0}, train_params=net, mode="cpu")
    sub = tmp_path / "degraded" / "deg_combined"
    assert sorted(p.name for p in (sub / "tmp").iterdir()) == [
        "MNI_sub_probabilities.nii.gz", "MNI_subcortical_mask.nii.gz",
        "rT1_template.nii.gz", "rT1d_template.nii.gz", "transf.txt",
        "transform.nii"]
    gt = np.asarray(load_nii(str(sub / "gt_15_classes.nii.gz")).data)
    gt = np.where(gt == 15, 0, gt).astype(np.uint8)

    def prior_labels(priors):
        top = np.argmax(priors, -1)
        return np.where(top < 14, top + 1, 0).astype(np.uint8)

    registered = mean_dice(prior_labels(np.asarray(load_nii(str(
        sub / "tmp" / "MNI_sub_probabilities.nii.gz")).data)), gt)
    unregistered = mean_dice(prior_labels(np.asarray(load_nii(str(
        tmp_path / "atlases" / "atlas_subcortical_MNI.nii.gz")).data)), gt)
    assert registered >= 0.80 and registered > unregistered, (
        registered, unregistered)
    seg = np.asarray(load_nii(str(
        sub / "out_subcortical_seg_prec.nii.gz")).data)
    assert records[0]["value"] == round(mean_dice(seg, gt), 4)
    assert summary["per_degradation"] == {"combined": records[0]["value"]}
    printed = [sorted(json.loads(line)) for line in
               capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert sorted(printed) == _dumped_keys(REPO / "bench_robust.py")


# ------------------------------------------------------------ the refusals
@pytest.mark.parametrize("name", BENCHMARKS)
def test_each_benchmark_asks_for_the_card_by_default(name):
    """Without ``--mode cpu`` a benchmark runs on the card, and on a box
    without one it raises from ``select_device`` before any work: nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    module = {"reg": reg, "train": train, "trainqual": trainqual,
              "robust": robust, "scan": scan}[name]
    with pytest.raises(RuntimeError, match="CUDA device"):
        module.main([])
