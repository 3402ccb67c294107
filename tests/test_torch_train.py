"""PyTorch port: training against the JAX package's, on the CPU.

A narrow net (patch 32, 8 filters, 16-wide dense layers) keeps the CPU
cheap while running the full-width code path. Params come from the JAX
package's ``init_params`` and cross over through ``params_from_jax``;
inputs are numpy from a seed. Where a step is compared, dropout is 0 and
augmentation off, since torch's and JAX's random streams differ.

Tolerances: both sides run float32 on the CPU and differ in summation
order only. Loss and batch statistics within 1e-5; gradients within rtol
1e-4, atol 1e-6; BN EMA and post-step parameters within 1e-6, except where
a gradient is below 1e-5: Adam's first step moves a parameter by about
lr * sign(g), so there a reassociated near-zero gradient may flip the sign
of the move, which stays within 2 * lr. The bfloat16 step is held to the
JAX package's op-by-op bfloat16 step (its test says why).
"""

import functools
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from subcort_tpu.config import Options as JaxOptions
from subcort_tpu.engine.data import TrainingIndex as JaxTrainingIndex
from subcort_tpu.engine.train import Trainer as JaxTrainer
from subcort_tpu.engine.train import _augment_intensity as jax_intensity
from subcort_tpu.engine.train import _augment_views as jax_augment_views
from subcort_tpu.engine.train import \
    gather_triplanar_subjects as jax_gather_subjects
from subcort_tpu.engine.train import make_train_step
from subcort_tpu.engine.train import \
    train_split_stratified as jax_train_split
from subcort_tpu.models import apply as jax_apply
from subcort_tpu.models import init_params as jax_init_params
from subcort_tpu.models.importer import \
    load_theano_checkpoint as jax_load_checkpoint
from subcort_tpu.models.importer import \
    save_theano_checkpoint as jax_save_checkpoint
from subcort_tpu.models.triplanar import TriPlanarSpec as JaxSpec
from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine import (Trainer, TrainingIndex,
                                      build_training_index,
                                      list_training_subjects,
                                      train_split_stratified)
from subcort_tpu_torch.engine.infer import candidate_centers, segment_volume
from subcort_tpu_torch.engine.metrics import mean_dice
from subcort_tpu_torch.engine.train import (ADAM, augment_intensity,
                                            augment_views,
                                            draw_intensity_augment,
                                            draw_view_augment, train_step)
from subcort_tpu_torch.io import load_nii
from subcort_tpu_torch.models import (TriPlanarNet, TriPlanarSpec,
                                      load_theano_checkpoint, params_from_jax,
                                      save_theano_checkpoint)
from subcort_tpu_torch.models.triplanar import VIEWS, dropout
from subcort_tpu_torch.ops.gather_kernel import (gather_triplanar_cuda,
                                                 prepare_gather_volume)
from subcort_tpu_torch.registration import make_synthetic_cohort

torch.set_num_threads(1)

NARROW = dict(conv_filters=(8, 8, 8, 8, 8), fc_conv=16, fc_fc=16, fc2=16)
SPEC = TriPlanarSpec(**NARROW, dropout_conv=0.0, dropout_fc=0.0)
JAX_SPEC = JaxSpec(**NARROW, dropout_conv=0.0, dropout_fc=0.0)
EXTENT = (20, 22, 18)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax.random.key(7), JAX_SPEC)


def _batch(seed=0, b=64, subjects=2):
    """A padded subject stack and one batch of (subject, x, y, z) rows."""
    rng = np.random.default_rng(seed)
    vols = rng.standard_normal(
        (subjects,) + tuple(e + 32 for e in EXTENT)).astype(np.float32)
    centers = np.stack([rng.integers(0, subjects, b)]
                       + [rng.integers(0, e, b) for e in EXTENT],
                       1).astype(np.int32)
    labels = rng.integers(0, 15, b).astype(np.int32)
    atlas = rng.random((b, 15)).astype(np.float32)
    return vols, centers, labels, atlas


def _gather(vols, centers, patch=32):
    """The train step's gather, on the CPU: the wrapper's plain version on
    the kernel's layouts of the stack."""
    return gather_triplanar_cuda(prepare_gather_volume(torch.from_numpy(vols)),
                                 torch.from_numpy(centers), patch)


def _port_inputs(vols, centers, labels, atlas, spec=SPEC):
    views = _gather(vols, centers, spec.patch_size)
    return (views, torch.from_numpy(labels.astype(np.int64)),
            torch.from_numpy(atlas))


def _trainable(params, spec=SPEC):
    net = TriPlanarNet.from_params(params, spec, CPU, trainable=True)
    return net, torch.optim.Adam(net.parameters(), **ADAM)


@functools.cache
def _jax_step():
    """The JAX package's float32 step, one jit for every test here."""
    opt = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    return make_train_step(opt, JAX_SPEC), opt


def test_train_mode_forward_and_batch_stats_match_jax(jax_params):
    vols, centers, labels, atlas = _batch()
    views, _, atlas_t = _port_inputs(vols, centers, labels, atlas)
    stats = {}
    want = jax_apply(jax_params, {"axial": np.asarray(views[0]),
                                  "coronal": np.asarray(views[1]),
                                  "sagittal": np.asarray(views[2]),
                                  "atlas": atlas},
                     spec=JAX_SPEC, train=True, rng=jax.random.key(0),
                     return_logits=True, batch_stats_out=stats)
    net, _ = _trainable(params_from_jax(jax_params, SPEC))
    got = net(*views, atlas_t, return_logits=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for view in VIEWS:
        for i in range(1, 6):
            mean, inv_std = getattr(getattr(net, view), f"bn{i}").batch_stats
            jm, js = stats[view][f"bn{i}"]
            np.testing.assert_allclose(mean.numpy(), np.asarray(jm),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(inv_std.numpy(), np.asarray(js),
                                       rtol=1e-5, atol=1e-5)


def test_train_step_matches_jax(jax_params):
    """Loss, gradients (JAX: Adam's first moment / (1 - b1)), BN EMA and the
    parameters after one Adam step."""
    vols, centers, labels, atlas = _batch()
    step, opt = _jax_step()
    jp, jstate, jloss = step(jax_params, opt.init(jax_params),
                             jnp.asarray(vols), jnp.asarray(centers),
                             jnp.asarray(labels), jnp.asarray(atlas),
                             jax.random.key(1))
    net, optimizer = _trainable(params_from_jax(jax_params, SPEC))
    loss = train_step(net, optimizer, *_port_inputs(vols, centers, labels,
                                                    atlas))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    jgrads = params_from_jax(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, jstate[0].mu), SPEC)
    after = params_from_jax(jp, SPEC)
    state = net.state_dict()
    for name, p in net.named_parameters():
        g, want_g = p.grad.numpy(), jgrads[name].numpy()
        np.testing.assert_allclose(g, want_g, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        diff = np.abs(state[name].numpy() - after[name].numpy())
        big = np.abs(want_g) > 1e-5
        assert (diff[big] <= 1e-6).all(), name
        assert (diff <= 2 * ADAM["lr"]).all(), name
    for name in state:
        if name.endswith((".mean", ".inv_std")):
            np.testing.assert_allclose(state[name].numpy(),
                                       after[name].numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)


def test_three_steps_match_jax(jax_params):
    vols, centers, labels, atlas = _batch()
    step, opt = _jax_step()
    jp, jstate = jax_params, opt.init(jax_params)
    net, optimizer = _trainable(params_from_jax(jax_params, SPEC))
    inputs = _port_inputs(vols, centers, labels, atlas)
    for _ in range(3):
        jp, jstate, jloss = step(jp, jstate, jnp.asarray(vols),
                                 jnp.asarray(centers), jnp.asarray(labels),
                                 jnp.asarray(atlas), jax.random.key(1))
        loss = train_step(net, optimizer, *inputs)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)


@pytest.mark.parametrize("labels", [
    np.repeat(np.arange(4), 20),
    np.random.default_rng(0).integers(0, 15, 333),
    np.array([3, 3, 3, 1]),
    np.zeros(0, np.int64),
], ids=["balanced", "random", "tiny", "empty"])
@pytest.mark.parametrize("eval_size", [0.25, 0.1, 0.0])
def test_train_split_stratified_matches_jax(labels, eval_size):
    got = train_split_stratified(labels, eval_size)
    want = jax_train_split(labels, eval_size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _reference_transform_stack(x):
    """tests/test_train.py's verbatim copy of nets.py:60-72 on an
    (N, 1, h, w) batch."""
    rotate_90 = x[:, :, ::-1, :].transpose(0, 1, 3, 2)
    rotate_180 = rotate_90[:, :, ::-1, :].transpose(0, 1, 3, 2)
    rotate_0_flipped = x[:, :, :, ::-1]
    rotate_180_flipped = rotate_180[:, :, :, ::-1]
    return np.stack([rotate_180, rotate_0_flipped, rotate_180_flipped],
                    axis=1)


def test_augment_views_apply_matches_reference_transform():
    """The apply, fed the draws the JAX package derives from its key,
    equals the reference transform and the JAX function's output."""
    rng = np.random.default_rng(1234)
    b, p = 64, 8
    views = [rng.standard_normal((b, p, p)).astype(np.float32)
             for _ in range(3)]
    key = jax.random.key(123)
    k_sel, *k_views = jax.random.split(key, 4)
    selected = np.array(jax.random.permutation(k_sel, jnp.arange(b))
                          < b // 2)
    rs = np.stack([np.array(jax.random.randint(k, (b,), 0, 3))
                   for k in k_views])
    got = augment_views(tuple(torch.from_numpy(v) for v in views),
                        torch.from_numpy(selected), torch.from_numpy(rs))
    jgot = jax_augment_views(key, *(jnp.asarray(v) for v in views))
    idx = np.flatnonzero(selected)
    for view, out, jout, r in zip(views, got, jgot, rs):
        x = view[:, None]
        augmented = _reference_transform_stack(x)
        expect = x.copy()
        expect[idx] = np.stack([augmented[i, r[i]] for i in idx])
        np.testing.assert_array_equal(out.numpy(), expect[:, 0])
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(out.numpy()[~selected],
                                      view[~selected])


def test_draw_view_augment_law():
    """Exactly b // 2 rows without replacement, r in {0, 1, 2} drawn per
    view, the same draws from the same generator seed."""
    b = 64
    selected, r = draw_view_augment(b, torch.Generator().manual_seed(5))
    assert selected.dtype == torch.bool and selected.shape == (b,)
    assert int(selected.sum()) == b // 2
    assert r.shape == (3, b) and set(r.unique().tolist()) == {0, 1, 2}
    assert not (torch.equal(r[0], r[1]) and torch.equal(r[1], r[2]))
    again = draw_view_augment(b, torch.Generator().manual_seed(5))
    assert torch.equal(selected, again[0]) and torch.equal(r, again[1])
    assert int(draw_view_augment(7, torch.Generator())[0].sum()) == 3


def _intensity(views, strength, seed=9):
    draws = draw_intensity_augment(views[0].shape, strength,
                                   torch.Generator().manual_seed(seed))
    return [v.numpy() for v in augment_intensity(views, *draws)]


def test_intensity_augmentation_semantics():
    """tests/test_train.py's pins of the intensity augmentation on the
    port's draw + apply: strength 0 is the identity; deterministic under a
    seed; a per-sample gain shared by the views, inside U(0.75, 1.25); a
    shared shift; noise drawn per view."""
    rng = np.random.default_rng(1234)
    b, p = 32, 8
    views = tuple(torch.from_numpy(rng.standard_normal((b, p, p))
                                   .astype(np.float32)) for _ in range(3))
    for o, v in zip(_intensity(views, 0.0), views):
        np.testing.assert_array_equal(o, v.numpy())
    got = _intensity(views, 1.0)
    for a, b_ in zip(got, _intensity(views, 1.0)):
        np.testing.assert_array_equal(a, b_)

    got_p1 = _intensity(tuple(v + 1.0 for v in views), 1.0)
    gains = []
    for o1, o2 in zip(got, got_p1):
        g = o2 - o1
        gm = g.mean(axis=(1, 2), keepdims=True)
        np.testing.assert_allclose(g, np.broadcast_to(gm, g.shape),
                                   rtol=0, atol=1e-5)
        gains.append(gm[:, 0, 0])
    np.testing.assert_allclose(gains[0], gains[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(gains[0], gains[2], rtol=0, atol=1e-6)
    assert gains[0].min() >= 0.75 - 1e-5 and gains[0].max() <= 1.25 + 1e-5
    assert gains[0].std() > 0.01

    zeros = (torch.zeros((b, p, p)),) * 3
    res = _intensity(zeros, 1.0)
    means = [r.mean(axis=(1, 2)) for r in res]
    np.testing.assert_allclose(means[0], means[1], rtol=0, atol=0.08)
    assert np.abs(means[0]).max() <= 0.2 + 0.08
    assert not np.array_equal(res[0], res[1])
    assert max(r.std() for r in res) > 0.0


def test_intensity_apply_matches_jax_on_its_draws():
    """The apply, fed the draws the JAX package makes from its key, equals
    the JAX function."""
    rng = np.random.default_rng(2)
    b, p, s = 16, 8, 1.5
    views = [rng.standard_normal((b, p, p)).astype(np.float32)
             for _ in range(3)]
    key = jax.random.key(9)
    k_gain, k_shift, k_sigma, *k_noise = jax.random.split(key, 6)
    gain = 1.0 + jax.random.uniform(k_gain, (b, 1, 1), jnp.float32,
                                    -0.25, 0.25) * s
    shift = jax.random.uniform(k_shift, (b, 1, 1), jnp.float32, -0.2, 0.2) * s
    sigma = jax.random.uniform(k_sigma, (b, 1, 1), jnp.float32, 0.0, 0.15) * s
    noise = np.stack([np.asarray(jax.random.normal(k, (b, p, p)))
                      for k in k_noise])
    got = augment_intensity(
        tuple(torch.from_numpy(v) for v in views),
        *(torch.from_numpy(np.array(a)) for a in (gain, shift, sigma,
                                                   noise)))
    want = jax_intensity(key, *(jnp.asarray(v) for v in views), s)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_dropout_law_and_global_rng():
    """Keep fraction 0.5 +- 0.02, kept values doubled, the identity at
    inference; a train step draws nothing from torch's global generator."""
    x = torch.ones((512, 128))
    y = dropout(x, 0.5, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) <= 0.02
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    assert torch.equal(dropout(x, 0.0, None), x)

    spec = TriPlanarSpec(**NARROW)
    vols, centers, labels, atlas = _batch()
    params = params_from_jax(jax_init_params(jax.random.key(1),
                                             JaxSpec(**NARROW)), spec)
    views, labels_t, atlas_t = _port_inputs(vols, centers, labels, atlas,
                                            spec)
    net, optimizer = _trainable(params, spec)
    torch.manual_seed(4)
    before = torch.random.get_rng_state()
    loss = train_step(net, optimizer, views, labels_t, atlas_t,
                      torch.Generator().manual_seed(1), augment=True,
                      intensity_augment=1.0)
    assert torch.isfinite(loss)
    assert torch.equal(torch.random.get_rng_state(), before)
    net.eval()
    with torch.no_grad():
        a = net(*views, atlas_t)
        b = net(*views, atlas_t, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(jax_params, tmp_path, writer):
    """Port save -> JAX load -> params_from_jax equals the port's params
    exactly, and JAX save -> port load; the pickles' keys are the same, in
    the same order."""
    params = params_from_jax(jax_params, SPEC)
    mine, theirs = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    save_theano_checkpoint(params, str(mine))
    jax_save_checkpoint(jax_params, str(theirs), JAX_SPEC)
    with open(mine, "rb") as fh, open(theirs, "rb") as gh:
        raw, jraw = pickle.load(fh), pickle.load(gh)
    assert list(raw) == list(jraw)
    for k in raw:
        assert len(raw[k]) == len(jraw[k])
        for a, b in zip(raw[k], jraw[k]):
            np.testing.assert_array_equal(a, b)
    if writer == "port":
        got = params_from_jax(jax_load_checkpoint(str(mine), JAX_SPEC), SPEC)
    else:
        got = load_theano_checkpoint(str(theirs))
    assert got.keys() == params.keys()
    for k in params:
        assert torch.equal(got[k], params[k]), k


def _tiny_index(seed=0, n=96, subjects=2, labels=None):
    vols, centers, lab, atlas = _batch(seed, n, subjects)
    return TrainingIndex(vols, centers, lab if labels is None else labels,
                         atlas, [f"s{i}" for i in range(subjects)])


def _options(name, **kw):
    base = dict(experiment=name, batch_size=16, max_epochs=3, patience=10,
                train_split=0.25, net_verbose=0, load_weights=False, seed=3,
                mode="cpu")
    return Options(**{**base, **kw})


def test_trainer_protocol(tmp_path):
    """Epoch count, history keys, the JSONL and _history.pkl, the state
    and best-only files."""
    spec = TriPlanarSpec(**NARROW)
    tr = Trainer(_options("exp1"), spec=spec,
                 weights_path=str(tmp_path / "nets"))
    hist = tr.fit(_tiny_index())
    assert len(hist) == 3 and tr.epoch == 3
    keys = ["epoch", "train_loss", "valid_loss", "valid_accuracy",
            "train_loss_best", "valid_loss_best", "valid_accuracy_best",
            "dur"]
    assert all(list(h) == keys for h in hist)
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    d = tmp_path / "nets" / "exp1"
    lines = (d / "exp1_history.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == hist
    with open(d / "exp1_history.pkl", "rb") as fh:
        assert pickle.load(fh) == hist
    assert (d / "exp1_state.pkl").exists()
    best = load_theano_checkpoint(str(d / "exp1.pkl"))
    assert best.keys() == tr.params.keys()
    if tr.best_epoch == 3:
        assert all(torch.equal(best[k], tr.params[k]) for k in best)


def test_trainer_early_stopping(tmp_path):
    tr = Trainer(_options("exp3", max_epochs=50, patience=2, seed=5),
                 spec=TriPlanarSpec(**NARROW),
                 weights_path=str(tmp_path / "nets"))
    hist = tr.fit(_tiny_index(seed=2))  # random labels: no lasting progress
    assert len(hist) < 50
    assert hist[-1]["epoch"] == tr.best_epoch + 2


def test_trainer_resume_matches_uninterrupted(tmp_path):
    """Stopping after epoch 1 and resuming from the state file gives the
    epoch-2 history of an uninterrupted run: params, Adam state and both
    generators come back (dropout, augmentation and a per-epoch shuffle
    all draw)."""
    spec = TriPlanarSpec(**NARROW)
    index = _tiny_index(seed=4)
    kw = dict(spec=spec, augment=True, shuffle_each_epoch=True)

    def strip(h):
        return {k: v for k, v in h.items() if k != "dur"}

    whole = Trainer(_options("whole", max_epochs=2), **kw,
                    weights_path=str(tmp_path / "a")).fit(index)
    Trainer(_options("part", max_epochs=1), **kw,
            weights_path=str(tmp_path / "b")).fit(index)
    resumed = Trainer(_options("part", max_epochs=2, load_weights=True),
                      **kw, weights_path=str(tmp_path / "b"))
    assert resumed.epoch == 1
    hist = resumed.fit(index)
    assert [strip(h) for h in hist] == [strip(h) for h in whole]


def test_trainer_epoch_matches_jax_trainer(tmp_path):
    """One epoch of three steps (batch 16, shuffle and augmentation off,
    dropout 0) from the same index and params."""
    jparams = jax_init_params(jax.random.key(5), JAX_SPEC)
    index = _tiny_index(seed=6, n=80)
    common = dict(experiment="e", batch_size=16, max_epochs=1, patience=5,
                  train_split=0.25, net_verbose=0, load_weights=False,
                  seed=1)
    mine = Trainer(Options(**common, mode="cpu"), spec=SPEC,
                   params=params_from_jax(jparams, SPEC),
                   weights_path=str(tmp_path / "port")).fit(index)
    theirs = JaxTrainer(JaxOptions(**common), spec=JAX_SPEC, params=jparams,
                        weights_path=str(tmp_path / "jax")).fit(
        JaxTrainingIndex(index.volumes, index.centers, index.labels,
                         index.atlas, index.subject_names))
    np.testing.assert_allclose(mine[0]["train_loss"],
                               theirs[0]["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(mine[0]["valid_loss"],
                               theirs[0]["valid_loss"], rtol=1e-3)
    assert mine[0]["valid_accuracy"] == theirs[0]["valid_accuracy"]


@pytest.mark.parametrize("patch", [32, 24])
def test_gather_views_matches_jax(patch):
    """The CPU gather of the train step on a stack padded by 16, at the
    kernel's patch 32 and at 24, where the windows start 4 voxels in
    (train.py:55-79)."""
    vols, centers, _, _ = _batch(seed=3, b=40)
    got = _gather(vols, centers, patch)
    want = jax_gather_subjects(jnp.asarray(vols), jnp.asarray(centers),
                               patch=patch)
    for g, w in zip(got, want):
        assert g.shape == (40, patch, patch)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lr_schedule_matches_jax(tmp_path):
    common = dict(experiment="lr", max_epochs=7, load_weights=False,
                  net_verbose=0)
    mine = Trainer(Options(**common, mode="cpu"), spec=SPEC,
                   lr_schedule=(1e-3, 1e-5), weights_path=str(tmp_path / "a"))
    theirs = JaxTrainer(JaxOptions(**common), spec=JAX_SPEC,
                        lr_schedule=(1e-3, 1e-5),
                        weights_path=str(tmp_path / "b"))
    np.testing.assert_allclose(mine._lr_per_epoch, theirs._lr_per_epoch,
                               rtol=1e-6)


def test_bfloat16_step_matches_jax(jax_params):
    """train_dtype=bfloat16 against the JAX package's
    make_train_step(compute_dtype=bfloat16) from the same params and batch:
    the loss within rtol 2e-5 and the BN EMA within 1e-6, both well below
    the JAX package's own bfloat16 vs float32 gap on this batch (about 6e-4
    and 1e-4, asserted), so a port that ran the step in float32 fails.
    Master parameters, their gradients and the buffers stay float32.

    The JAX step is compiled with XLA's excess precision off: each
    operation then rounds to bfloat16 as its dtype says, as the port's
    eager ops do. With it on, XLA's default, a fusion keeps some
    intermediates in float32, and the loss lies a third of the bfloat16 vs
    float32 gap away on this batch."""
    vols, centers, labels, atlas = _batch()
    step, opt = _jax_step()
    args = (jax_params, opt.init(jax_params), jnp.asarray(vols),
            jnp.asarray(centers), jnp.asarray(labels), jnp.asarray(atlas),
            jax.random.key(1))
    jp32, _, jloss32 = step(*args)
    jp16, _, jloss16 = make_train_step(
        opt, JAX_SPEC, compute_dtype=jnp.bfloat16).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    net, optimizer = _trainable(params_from_jax(jax_params, SPEC))
    loss = float(train_step(net, optimizer, *_port_inputs(
        vols, centers, labels, atlas), compute_dtype=torch.bfloat16))
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in net.parameters())
    assert all(b.dtype == torch.float32 for b in net.buffers())
    assert np.isfinite(loss)

    rtol, atol = 2e-5, 1e-6
    loss_gap = abs(float(jloss16) - float(jloss32)) / float(jloss32)
    assert loss_gap > 10 * rtol
    np.testing.assert_allclose(loss, float(jloss16), rtol=rtol)
    want16, want32 = params_from_jax(jp16, SPEC), params_from_jax(jp32, SPEC)
    state = net.state_dict()
    ema = [k for k in state if k.endswith((".mean", ".inv_std"))]
    assert max(float((want16[k] - want32[k]).abs().max())
               for k in ema) > 10 * atol
    for k in ema:
        np.testing.assert_allclose(state[k].numpy(), want16[k].numpy(),
                                   rtol=0, atol=atol, err_msg=k)


def test_trainer_refuses_what_is_not_ported(tmp_path):
    # data_parallel = 2 trains over two devices; the CPU is one, so it
    # raises as the JAX package's make_mesh does, and two named devices
    # (a device may repeat) train one epoch over two ranks
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        Trainer(_options("dp", data_parallel=2), spec=SPEC,
                weights_path=str(tmp_path))
    dp = Trainer(_options("dp", max_epochs=1), spec=SPEC,
                 weights_path=str(tmp_path), devices=[CPU, CPU])
    assert dp.devices == [CPU, CPU]
    hist = dp.fit(_tiny_index())
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    # the kernel takes 32x32 windows only: another size takes the plain
    # gather on the card, as the JAX package's does (ROADMAP.md §C 6), and
    # a device with neither raises, whatever the size
    from subcort_tpu_torch.ops.gather_kernel import takes_kernel

    assert not takes_kernel(torch.device("cuda", 0), 24)
    vols, centers = _batch()[:2]
    meta = torch.device("meta")
    for patch in (24, 32):
        with pytest.raises(ValueError, match="no gather for device meta"):
            gather_triplanar_cuda(
                prepare_gather_volume(torch.from_numpy(vols).to(meta)),
                torch.from_numpy(centers).to(meta), patch)
    if not torch.cuda.is_available():
        # the default mode asks for the card, and never falls back
        with pytest.raises(RuntimeError, match="(?i)cuda"):
            Trainer(_options("card", mode="tpu"), spec=SPEC,
                    weights_path=str(tmp_path))


def test_training_converges_to_segmenting_model(tmp_path):
    """tests/test_trainqual.py's recipe with the port's Trainer and
    segment_volume, to the same floors: best valid_accuracy >= 0.90 and
    held-out Dice >= 0.85 (0.915 and 0.89 measured)."""
    cohort = str(tmp_path / "cohort")
    make_synthetic_cohort(cohort, n_subjects=3, shape=(48, 54, 44), seed=1,
                          noise=4.0, prior_error=0)
    options = Options(experiment="trainqual", train_folder=cohort,
                      max_epochs=6, patience=8, batch_size=128,
                      train_split=0.25, net_verbose=0, load_weights=False,
                      debug=False, seed=1, mode="cpu")
    subjects = list_training_subjects(options)
    index = build_training_index(options, subjects=subjects[:2])
    cap = 4096
    index = TrainingIndex(index.volumes, index.centers[:cap],
                          index.labels[:cap], index.atlas[:cap],
                          index.subject_names)
    # the JAX Trainer's own start for seed 1 (train.py:358-361): the run
    # begins from tests/test_trainqual.py's weights; dropout draws differ
    _, sub = jax.random.split(jax.random.key(1))
    trainer = Trainer(options, params=params_from_jax(jax_init_params(sub)),
                      weights_path=str(tmp_path / "nets"))
    # two threads: the floors were measured so, and one thread takes ~2 min
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        history = trainer.fit(index)
    finally:
        torch.set_num_threads(threads)
    best = min(history, key=lambda h: h["valid_loss"])
    assert best["valid_accuracy"] >= 0.90, history

    held = os.path.dirname(subjects[2].t1_path)
    image = np.asarray(load_nii(os.path.join(held, "T1.nii.gz")).data)
    gt = np.asarray(load_nii(os.path.join(held, "gt_15_classes.nii.gz")).data)
    gt = np.where(gt == 15, 0, gt).astype(np.uint8)
    atlas = np.asarray(load_nii(os.path.join(
        held, "tmp", "MNI_sub_probabilities.nii.gz")).data, np.float32)
    mask = np.asarray(load_nii(os.path.join(
        held, "tmp", "MNI_subcortical_mask.nii.gz")).data)
    net = TriPlanarNet.from_params(
        load_theano_checkpoint(trainer.weights_file), device="cpu")
    label_vol, _ = segment_volume(net, image, atlas,
                                  candidate_centers(image, options, mask))
    dice = mean_dice(label_vol, gt)
    assert dice >= 0.85, f"held-out Dice {dice:.4f} < 0.85"
