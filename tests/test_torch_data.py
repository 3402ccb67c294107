"""PyTorch port: the training data engine against the JAX package's.

The port's ``engine/data.py``, ``ops/sampling.py``, the numpy gather and
the phantom cohort generator are copies that draw from the same
``numpy.random.Generator`` calls in the same order, so one seed gives both
packages the same arrays: every comparison here is exact.
"""

import numpy as np
import pytest
import torch

from subcort_tpu.config import Options as JaxOptions
from subcort_tpu.engine import data as jax_data
from subcort_tpu.io import load_nii as jax_load_nii
from subcort_tpu.ops import sampling as jax_sampling
from subcort_tpu.ops.patches import gather_triplanar_np as jax_gather_np
from subcort_tpu.registration.atlas import \
    make_synthetic_cohort as jax_make_cohort
from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine import data
from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii
from subcort_tpu_torch.ops import sampling
from subcort_tpu_torch.ops.patches import gather_triplanar_np
from subcort_tpu_torch.registration import make_synthetic_cohort

torch.set_num_threads(1)

SHAPE = (24, 26, 22)


def _make_dataset(tmp_path, n_subjects=2, prior=True):
    """tests/test_train.py's phantom folder: structures, a boundary-
    background slab and random normalized priors, seed 11."""
    rng = np.random.default_rng(11)
    for i in range(n_subjects):
        sub = tmp_path / f"s{i:02d}"
        (sub / "tmp").mkdir(parents=True)
        img = (rng.random(SHAPE) * 500 + 50).astype(np.float32)
        gt = np.zeros(SHAPE, np.uint8)
        gt[8:14, 9:15, 8:13] = rng.integers(1, 15, (6, 6, 5))
        gt[2:22, 2:24, 2:6] = 15
        atlas = rng.random(SHAPE + (15,)).astype(np.float32)
        atlas /= atlas.sum(-1, keepdims=True)
        save_nii(NiftiImage(img), str(sub / "T1.nii.gz"))
        save_nii(NiftiImage(gt), str(sub / "gt_15_classes.nii.gz"))
        if prior:
            save_nii(NiftiImage(atlas),
                     str(sub / "tmp" / "MNI_sub_probabilities.nii.gz"))
    return (Options(train_folder=str(tmp_path), debug=False, seed=11),
            JaxOptions(train_folder=str(tmp_path), debug=False, seed=11))


def _assert_index_equal(got, want):
    for name in ("volumes", "centers", "labels", "atlas"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.subject_names == want.subject_names


@pytest.mark.parametrize("kw", [{}, {"randomize": False},
                                {"exclude_subject": "s01"}],
                         ids=["default", "ordered", "loo"])
def test_build_training_index_matches_jax(tmp_path, kw):
    opts, jopts = _make_dataset(tmp_path)
    got = data.build_training_index(opts, **kw)
    want = jax_data.build_training_index(jopts, **kw)
    _assert_index_equal(got, want)
    assert len(got) > 0 and got.labels.max() <= 14
    assert (got.labels > 0).sum() == (got.labels == 0).sum()


def test_generate_training_set_and_load_data_match_jax(tmp_path):
    opts, jopts = _make_dataset(tmp_path)
    index = data.build_training_index(opts)
    got = data.generate_training_set(index)
    want = jax_data.generate_training_set(
        jax_data.build_training_index(jopts))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    *arrays, names = data.load_data(opts)
    *jarrays, jnames = jax_data.load_data(jopts)
    assert names == jnames == ["s00", "s01"]
    assert arrays[0].shape == (len(index), 1, 32, 32)
    for g, w in zip(arrays, jarrays):
        np.testing.assert_array_equal(g, w)


def test_leave_one_out_and_subjects_match_jax(tmp_path):
    opts, jopts = _make_dataset(tmp_path, n_subjects=3)
    subs = data.list_training_subjects(opts)
    jsubs = jax_data.list_training_subjects(jopts)
    assert [vars(s) for s in subs] == [vars(s) for s in jsubs]
    train, held = data.leave_one_out(subs, "s01")
    assert held.name == "s01" and [s.name for s in train] == ["s00", "s02"]
    with pytest.raises(ValueError):
        data.leave_one_out(subs, "nope")


def test_sampling_matches_jax():
    """The sampler copies draw the same numbers from one seeded Generator."""
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 16, (20, 18, 16))
    for size in (None, 7, 10_000):
        np.testing.assert_array_equal(
            sampling.get_mask_voxels(labels > 8, size, np.random.default_rng(5)),
            jax_sampling.get_mask_voxels(labels > 8, size,
                                         np.random.default_rng(5)))
    np.testing.assert_array_equal(
        sampling.balanced_negative_sample(labels, 40,
                                          rng=np.random.default_rng(6)),
        jax_sampling.balanced_negative_sample(labels, 40,
                                              rng=np.random.default_rng(6)))
    arrays = [np.arange(30), rng.random((30, 4))]
    for g, w in zip(sampling.shuffle_consistent(arrays,
                                                np.random.default_rng(7)),
                    jax_sampling.shuffle_consistent(arrays,
                                                    np.random.default_rng(7))):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        sampling.shuffle_consistent([np.arange(3), np.arange(4)],
                                    np.random.default_rng(0))


def test_gather_triplanar_np_matches_jax():
    rng = np.random.default_rng(4)
    vol = rng.standard_normal((21, 19, 23)).astype(np.float32)
    centers = np.stack([rng.integers(0, s, 50) for s in vol.shape], 1)
    for patch in (32, 24):
        for g, w in zip(gather_triplanar_np(vol, centers, patch),
                        jax_gather_np(vol, centers, patch)):
            np.testing.assert_array_equal(g, w)


def test_synthetic_cohort_matches_jax(tmp_path):
    """One seed writes the same cohort in both packages: T1, GT, prior and
    mask of every subject, and the atlas assets beside the cohort."""
    kw = dict(n_subjects=2, shape=(20, 22, 18), seed=3, noise=4.0)
    subs = make_synthetic_cohort(str(tmp_path / "port"), **kw)
    jsubs = jax_make_cohort(str(tmp_path / "jax"), **kw)
    files = ["T1.nii.gz", "gt_15_classes.nii.gz",
             "tmp/MNI_sub_probabilities.nii.gz",
             "tmp/MNI_subcortical_mask.nii.gz"]
    pairs = [(f"{s}/{f}", f"{j}/{f}") for s, j in zip(subs, jsubs)
             for f in files]
    pairs += [(f"{tmp_path}/port_atlases/{f}", f"{tmp_path}/jax_atlases/{f}")
              for f in ("T1_template.nii.gz", "atlas_subcortical_MNI.nii.gz")]
    for mine, theirs in pairs:
        got, want = load_nii(mine).data, jax_load_nii(theirs).data
        assert got.dtype == want.dtype, mine
        np.testing.assert_array_equal(got, want, err_msg=mine)


def test_missing_prior_without_register_fn_raises_not_ported(tmp_path):
    """Without a ``register_fn`` a missing prior goes to ``register_masks``
    under the configured backend. The JAX package's ``jax`` backend is not
    the port's: it raises naming ``torch``, before any subject is read; and
    ``torch`` without a card raises from ``select_device``."""
    opts, _ = _make_dataset(tmp_path, prior=False)
    opts["reg_backend"] = "jax"
    with pytest.raises(ValueError, match="'torch'"):
        data.build_training_index(opts)
    opts["reg_backend"] = "native"
    opts["reg_similarity"] = "ncc"
    with pytest.raises(ValueError, match="reg_similarity"):
        data.build_training_index(opts)
    if not torch.cuda.is_available():
        opts["reg_backend"], opts["reg_similarity"] = "torch", "nmi"
        with pytest.raises(RuntimeError, match="CUDA"):
            data.build_training_index(opts)


def test_missing_prior_without_register_fn_registers(tmp_path, monkeypatch):
    """With no ``register_fn``, ``build_training_index`` binds
    ``register_masks`` to the configured backend, cost and device, as the
    JAX package does (data.py:147-150)."""
    import subcort_tpu_torch.registration as registration

    opts, _ = _make_dataset(tmp_path, prior=False)
    opts["mode"], opts["reg_backend"] = "cpu", "torch"
    calls = []

    def register(t1_path, **kw):
        calls.append(kw)
        prior = np.full(SHAPE + (15,), 1.0 / 15, np.float32)
        save_nii(NiftiImage(prior), t1_path.replace(
            "T1.nii.gz", "tmp/MNI_sub_probabilities.nii.gz"))

    monkeypatch.setattr(registration, "register_masks", register)
    index = data.build_training_index(opts)
    assert calls == [dict(backend="torch", similarity="nmi",
                          device=torch.device("cpu"))] * 2
    np.testing.assert_allclose(index.atlas, 1.0 / 15)


def test_missing_prior_calls_register_fn(tmp_path):
    """A given ``register_fn`` writes the missing prior, as in the JAX
    package; the index then equals one built from the written priors."""
    opts, _ = _make_dataset(tmp_path, prior=False)
    called = []

    def register(t1_path):
        called.append(t1_path)
        prior = np.full(SHAPE + (15,), 1.0 / 15, np.float32)
        save_nii(NiftiImage(prior), t1_path.replace(
            "T1.nii.gz", "tmp/MNI_sub_probabilities.nii.gz"))

    index = data.build_training_index(opts, register_fn=register)
    assert len(called) == 2
    np.testing.assert_allclose(index.atlas, 1.0 / 15)
