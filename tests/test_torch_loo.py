"""PyTorch port: the leave-one-out driver (``engine/loo.py``) against the
JAX package's, on the CPU.

``fold_view`` is array-equal to the JAX package's on one cohort indexed by
each package; ``sample_cap`` draws the JAX package's rows (the same
``default_rng([seed, rows])`` permutation); ``run_loo`` over two real folds
keeps tests/test_loo.py's summary contract (keys, per-fold artifacts,
``epochs``, ``mean_dice`` the mean), with a Dice floor set from what the
port measures; unknown folds raise; ``cli loo`` reaches ``run_loo`` and
prints one JSON line per fold and a summary.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import subcort_tpu.engine.loo as jax_loo
import subcort_tpu.engine.train as jax_train
from subcort_tpu.config import Options as JaxOptions
from subcort_tpu.engine.data import \
    build_training_index as jax_build_training_index
from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine import loo
from subcort_tpu_torch.engine.data import build_training_index
from subcort_tpu_torch.registration import make_synthetic_cohort

torch.set_num_threads(1)

# run_loo's two folds, 2 epochs on 1,536 rows of the 32x36x30 phantom each,
# on the CPU: the held-out Dice measured 0.7291 (s00) and 0.5923 (s01),
# mean 0.6607; the seeded untrained net scores 0.0145 and 0.0194 there
DICE_FLOOR = 0.45


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loo") / "cohort")
    make_synthetic_cohort(root, n_subjects=3, shape=(32, 36, 30), seed=2,
                          noise=4.0, prior_error=0)
    return root


def _kw(cohort):
    return dict(experiment="looexp", train_folder=cohort, max_epochs=2,
                patience=8, batch_size=128, train_split=0.25, net_verbose=0,
                load_weights=False, debug=False, seed=3)


def _options(cohort, **kw):
    return Options(mode="cpu", **dict(_kw(cohort), **kw))


def test_fold_view_matches_jax_package(cohort):
    index = build_training_index(_options(cohort))
    jax_index = jax_build_training_index(JaxOptions(**_kw(cohort)))
    for held in index.subject_names:
        got = loo.fold_view(index, held)
        want = jax_loo.fold_view(jax_index, held)
        assert got.volumes is index.volumes  # shared, not copied
        assert 0 < len(got) < len(index)
        si = index.subject_names.index(held)
        assert (got.centers[:, 0] != si).all()
        for f in ("volumes", "centers", "labels", "atlas"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)))
    with pytest.raises(ValueError, match="no subject named"):
        loo.fold_view(index, "nope")


class _RecordingTrainer:
    """Stands in for both packages' Trainer: records the rows each fold
    trains on, trains nothing."""
    seen = {}

    def __init__(self, options, spec=None, weights_path="nets",
                 augment=False, **kw):
        self.name = options["experiment"]
        self.weights_file = f"{weights_path}/{self.name}.pkl"

    def fit(self, index):
        self.seen[self.name] = (index.centers.copy(), index.labels.copy(),
                                np.asarray(index.atlas).copy())
        return [{"valid_loss": 0.5, "valid_accuracy": 0.75}]


def test_sample_cap_draws_the_jax_package_rows(cohort, monkeypatch):
    """Both run_loo's with their Trainer and checkpoint reload stubbed: each
    fold's capped rows are array-equal."""
    rows = {}
    for side in ("jax", "port"):
        trainer = type(side, (_RecordingTrainer,), {"seen": {}})
        if side == "jax":
            import subcort_tpu.models.importer as jax_importer
            monkeypatch.setattr(jax_train, "Trainer", trainer)
            monkeypatch.setattr(jax_importer, "load_theano_checkpoint",
                                lambda *a, **k: {})
            monkeypatch.setattr(jax_loo, "evaluate_fold",
                                lambda *a, **k: 0.5)
            summary = jax_loo.run_loo(JaxOptions(**_kw(cohort)),
                                      folds=["s00", "s02"], sample_cap=700)
        else:
            monkeypatch.setattr(loo, "Trainer", trainer)
            monkeypatch.setattr(loo, "load_theano_checkpoint",
                                lambda *a, **k: None)
            monkeypatch.setattr(loo.TriPlanarNet, "from_params",
                                lambda *a, **k: None)
            monkeypatch.setattr(loo, "evaluate_fold", lambda *a, **k: 0.5)
            summary = loo.run_loo(_options(cohort), folds=["s00", "s02"],
                                  sample_cap=700)
        assert summary["mean_dice"] == 0.5
        rows[side] = trainer.seen
    assert set(rows["port"]) == {"looexp_fold_s00", "looexp_fold_s02"}
    for name, got in rows["port"].items():
        assert len(got[0]) == 700
        for g, w in zip(got, rows["jax"][name]):
            np.testing.assert_array_equal(g, w)


def test_run_loo_two_folds(cohort, tmp_path):
    summary = loo.run_loo(_options(cohort),
                          weights_path=str(tmp_path / "nets"),
                          folds=["s00", "s01"], sample_cap=1536)
    assert set(summary) == {"folds", "mean_dice"}
    assert set(summary["folds"]) == {"s00", "s01"}
    for name, rec in summary["folds"].items():
        assert set(rec) == {"dice", "valid_accuracy", "valid_loss", "epochs"}
        exp = tmp_path / "nets" / f"looexp_fold_{name}"
        assert (exp / f"looexp_fold_{name}.pkl").exists()
        assert (exp / f"looexp_fold_{name}_history.jsonl").exists()
        assert rec["epochs"] == 2
        assert rec["dice"] > DICE_FLOOR, summary
    assert summary["mean_dice"] == pytest.approx(
        np.mean([r["dice"] for r in summary["folds"].values()]), abs=1e-3)


def test_run_loo_rejects_unknown_fold(cohort, tmp_path):
    with pytest.raises(ValueError, match="unknown fold"):
        loo.run_loo(_options(cohort), weights_path=str(tmp_path / "nets"),
                    folds=["does-not-exist"])


def test_run_loo_takes_the_device_from_mode(cohort, tmp_path):
    """The default mode asks for the card: without one, run_loo raises
    before it loads anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    opts = dataclasses.replace(_options(cohort), mode="tpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        loo.run_loo(opts, weights_path=str(tmp_path / "nets"))


def test_cli_loo_plumbing(cohort, tmp_path, capsys, monkeypatch):
    """``loo --folds a,b`` parses, reaches run_loo with the configured
    options, and prints one JSON line per fold and a summary line."""
    from subcort_tpu_torch.cli import main

    seen = {}

    def fake_run_loo(options, weights_path="nets", folds=None, augment=False,
                     **kw):
        seen.update(folder=options["train_folder"], folds=folds,
                    weights_path=weights_path, augment=augment,
                    mode=options["mode"])
        return {"folds": {f: {"dice": 0.5, "valid_accuracy": 0.9,
                              "valid_loss": 0.3, "epochs": 1}
                          for f in folds},
                "mean_dice": 0.5}

    monkeypatch.setattr(loo, "run_loo", fake_run_loo)
    cfg = tmp_path / "configuration.cfg"
    cfg.write_text(f"""\
[database]
train_folder = {cohort}
inference_folder = {cohort}

[model]
name = looexp
mode = cpu
net_verbose = 0
debug = False
""")
    rc = main(["loo", "--config", str(cfg), "--folds", "s00, s01",
               "--weights-path", str(tmp_path / "nets"), "--augment"])
    assert rc == 0
    assert seen == {"folder": cohort, "folds": ["s00", "s01"],
                    "weights_path": str(tmp_path / "nets"), "augment": True,
                    "mode": "cpu"}
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert lines == [
        {"fold": "s00", "dice": 0.5, "valid_accuracy": 0.9,
         "valid_loss": 0.3, "epochs": 1},
        {"fold": "s01", "dice": 0.5, "valid_accuracy": 0.9,
         "valid_loss": 0.3, "epochs": 1},
        {"loo_mean_dice": 0.5, "n_folds": 2}]
