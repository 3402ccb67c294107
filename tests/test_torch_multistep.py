"""PyTorch port: K train steps per call (``make_train_multistep``) against
the JAX package's ``make_train_multistep``, and against K calls of the
port's own ``train_step``, on the CPU.

The narrow net and batches of tests/test_torch_train.py. Against JAX,
dropout is 0 and augmentation off (the random streams differ), and the
tolerances are that file's: the losses within rtol 1e-4 (the step's own
three-step test), the BN EMA within 1e-6, and each parameter within 1e-6
where the JAX side's mean gradient exceeds 1e-5 and within 2 lr for each
step elsewhere (Adam moves a parameter by about lr * sign(g), which a
reassociated near-zero gradient may flip). Adam's moments are held as the
gradients are (rtol 1e-4, atol 1e-6 on the gradient scale). The bfloat16
case is held to the JAX package's op-by-op bfloat16 multistep at
test_bfloat16_step_matches_jax's bounds. Against the port's own step the
multistep is equal bit for bit, with dropout and both augmentations on:
it runs the same operations on the same numbers.

On the card the multistep replays one captured step; tests/test_torch_cuda.py
holds that to the plain loop there.
"""

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
from subcort_tpu.engine.train import \
    make_train_multistep as jax_make_train_multistep
from subcort_tpu.models import init_params as jax_init_params
from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine import Trainer, train, train_split_stratified
from subcort_tpu_torch.engine.train import (ADAM, DeviceAdam, _to_numpy,
                                            make_train_multistep, train_step)
from subcort_tpu_torch.models import (TriPlanarNet, TriPlanarSpec,
                                      init_params, params_from_jax)
from subcort_tpu_torch.ops.gather_kernel import (gather_triplanar_cuda,
                                                 prepare_gather_volume)
from subcort_tpu_torch.utils import runtime
from test_torch_ffd import HOST_READS
from test_torch_train import (CPU, JAX_SPEC, NARROW, SPEC, _batch, _options,
                              _tiny_index)

torch.set_num_threads(1)

B = 32
LR = ADAM["lr"]


@pytest.fixture(scope="module")
def jax_params():
    """tests/test_torch_train.py's JAX params (key 7); from others a
    float32 step may meet a near-tie (a max-pool argmax, a PReLU sign)
    that moves one gradient beyond the step test's bounds (PERF.md §7)."""
    return jax_init_params(jax.random.key(7), JAX_SPEC)


def _stacks(k, seed=0):
    """A padded 2-subject stack and K batches of B rows, (K, B, ...)."""
    vols, centers, labels, atlas = _batch(seed, k * B)
    return (vols, centers.reshape(k, B, 4), labels.reshape(k, B),
            atlas.reshape(k, B, 15))


def _port(params, spec=SPEC, seed=None):
    net = TriPlanarNet.from_params(params, spec, CPU, trainable=True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return net, DeviceAdam(net.parameters(), **ADAM), gen


def _multistep(net, opt, gen, vols, k, **kw):
    return make_train_multistep(
        net, opt, prepare_gather_volume(torch.from_numpy(vols)), gen,
        net.spec.patch_size, k, **kw)


def _run(ms, centers, labels, atlas):
    return ms(torch.from_numpy(centers),
              torch.from_numpy(labels.astype(np.int64)),
              torch.from_numpy(atlas))


def _jax_multistep(k, compute_dtype=None):
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    return jax_make_train_multistep(opt, JAX_SPEC,
                                    compute_dtype=compute_dtype), opt


@pytest.mark.parametrize("k", [1, 3])
def test_multistep_matches_jax(jax_params, k):
    """K steps in one call from the same params and (K, B) stacks: the K
    losses, the parameters, the BN EMA, Adam's moments and step count."""
    vols, centers, labels, atlas = _stacks(k)
    step, opt = _jax_multistep(k)
    jp, jstate, jlosses = step(jax_params, opt.init(jax_params),
                               jnp.asarray(vols), jnp.asarray(centers),
                               jnp.asarray(labels), jnp.asarray(atlas),
                               jax.random.key(1))
    net, optimizer, _ = _port(params_from_jax(jax_params, SPEC))
    losses = _run(_multistep(net, optimizer, None, vols, k), centers,
                  labels, atlas)
    assert losses.shape == (k,) and losses.dtype == torch.float32
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    assert_state_matches_jax(
        net.state_dict(),
        {name: optimizer.state[p] for name, p in net.named_parameters()},
        jp, jstate, k)


def assert_state_matches_jax(state, adam, jp, jstate, k):
    """The port's state dict and Adam state by parameter name (``adam``)
    after K steps against the JAX multistep's params ``jp`` and optimizer
    state ``jstate``, at test_multistep_matches_jax's bounds."""
    jadam = jstate[0]
    assert int(jadam.count) == k
    mu = params_from_jax(jax.tree_util.tree_map(np.asarray, jadam.mu), SPEC)
    nu = params_from_jax(jax.tree_util.tree_map(np.asarray, jadam.nu), SPEC)
    after = params_from_jax(jp, SPEC)
    for name, st in adam.items():
        assert float(st["step"]) == k
        # the moments on the gradient's scale: mu / (1 - b1^k) is a mean
        # gradient, sqrt(nu / (1 - b2^k)) a root mean square one
        g_mean = mu[name].numpy() / (1 - 0.9 ** k)
        np.testing.assert_allclose(st["exp_avg"].numpy() / (1 - 0.9 ** k),
                                   g_mean, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(
            np.sqrt(st["exp_avg_sq"].numpy() / (1 - 0.999 ** k)),
            np.sqrt(nu[name].numpy() / (1 - 0.999 ** k)), rtol=1e-4,
            atol=1e-6, err_msg=name)
        diff = np.abs(state[name].numpy() - after[name].numpy())
        big = np.abs(g_mean) > 1e-5
        assert (diff[big] <= 1e-6).all(), name
        assert (diff <= 2 * LR * k).all(), name
    for name in state:
        if name.endswith((".mean", ".inv_std")):
            np.testing.assert_allclose(state[name].numpy(),
                                       after[name].numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)


def test_bfloat16_multistep_matches_jax(jax_params):
    """train_dtype=bfloat16 through the multistep against the JAX
    package's bfloat16 multistep, compiled with XLA's excess precision off
    (test_bfloat16_step_matches_jax says why), on that test's batch at its
    one-step bounds: the loss within rtol 2e-5 and the BN EMA within 1e-6.
    Those bounds were set on that batch for one step; on other batches
    and at a second step the bfloat16 losses differ by more (up to 5.1e-5
    relative seen), as a bfloat16 rounding or Adam's first move of about
    lr * sign(g) flips with a value near a tie."""
    k = 1
    vols, centers, labels, atlas = (a[None] if i else a for i, a in
                                    enumerate(_batch()))
    step, opt = _jax_multistep(k, jnp.bfloat16)
    args = (jax_params, opt.init(jax_params), jnp.asarray(vols),
            jnp.asarray(centers), jnp.asarray(labels), jnp.asarray(atlas),
            jax.random.key(1))
    jp, _, jlosses = step.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    net, optimizer, _ = _port(params_from_jax(jax_params, SPEC))
    losses = _run(_multistep(net, optimizer, None, vols, k,
                             compute_dtype=torch.bfloat16),
                  centers, labels, atlas)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=2e-5)
    want = params_from_jax(jp, SPEC)
    for name, v in net.state_dict().items():
        if name.endswith((".mean", ".inv_std")):
            np.testing.assert_allclose(v.numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)


SPEC_DROPOUT = TriPlanarSpec(**NARROW, dropout_conv=0.5, dropout_fc=0.5)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_multistep_equals_eager_train_steps(dtype):
    """Dropout 0.5, view and intensity augmentation on: one call of 3
    steps equals 3 calls of train_step from the same params and generator
    seed, bit for bit: the losses (each in its own slot), the parameters,
    Adam's state and the generator's state. Each step draws anew, so a
    multistep that repeated one step's draws or reported one loss K times
    fails."""
    k = 3
    vols, centers, labels, atlas = _stacks(k, seed=4)
    params = init_params(SPEC_DROPOUT, torch.Generator().manual_seed(2))
    opts = dict(augment=True, intensity_augment=0.3, compute_dtype=dtype)

    net, optimizer, gen = _port(params, SPEC_DROPOUT, seed=5)
    got = _run(_multistep(net, optimizer, gen, vols, k, **opts), centers,
               labels, atlas)

    ref, ref_opt, ref_gen = _port(params, SPEC_DROPOUT, seed=5)
    volume = prepare_gather_volume(torch.from_numpy(vols))
    want = torch.stack([train_step(
        ref, ref_opt, gather_triplanar_cuda(volume,
                                            torch.from_numpy(centers[i])),
        torch.from_numpy(labels[i].astype(np.int64)),
        torch.from_numpy(atlas[i]), ref_gen, **opts) for i in range(k)])
    assert len(set(want.tolist())) == k
    assert torch.equal(got, want)
    for (name, v), w in zip(net.state_dict().items(),
                            ref.state_dict().values()):
        assert torch.equal(v, w), name
    for p, q in zip(net.parameters(), ref.parameters()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(optimizer.state[p][key],
                               ref_opt.state[q][key]), key
    assert torch.equal(gen.get_state(), ref_gen.get_state())


def test_multistep_refuses_other_shapes():
    """More steps than the multistep was made for, or another batch shape
    than its first call's (a captured step reads the first call's
    buffers), raise ValueError."""
    vols, centers, labels, atlas = _stacks(2)
    net, optimizer, _ = _port(init_params(SPEC,
                                          torch.Generator().manual_seed(0)))
    ms = _multistep(net, optimizer, None, vols, 1)
    with pytest.raises(ValueError, match="between 1 and 1 steps"):
        _run(ms, centers, labels, atlas)
    _run(ms, centers[:1], labels[:1], atlas[:1])
    with pytest.raises(ValueError, match="as at the first call"):
        _run(ms, centers[:1, :16], labels[:1, :16], atlas[:1, :16])


def test_trainer_grouped_epoch_matches_jax_trainer(tmp_path):
    """An epoch of three steps at steps_per_call = 2: the JAX trainer runs
    one grouped call of two steps and one single step, the port two calls
    (two steps, one). test_trainer_epoch_matches_jax_trainer's data and
    bounds."""
    jparams = jax_init_params(jax.random.key(5), JAX_SPEC)
    index = _tiny_index(seed=6, n=80)
    common = dict(experiment="e", batch_size=16, max_epochs=1, patience=5,
                  train_split=0.25, net_verbose=0, load_weights=False,
                  seed=1)
    mine = Trainer(Options(**common, mode="cpu"), spec=SPEC,
                   params=params_from_jax(jparams, SPEC), steps_per_call=2,
                   weights_path=str(tmp_path / "port")).fit(index)
    theirs = JaxTrainer(JaxOptions(**common), spec=JAX_SPEC, params=jparams,
                        steps_per_call=2,
                        weights_path=str(tmp_path / "jax")).fit(
        JaxTrainingIndex(index.volumes, index.centers, index.labels,
                         index.atlas, index.subject_names))
    np.testing.assert_allclose(mine[0]["train_loss"],
                               theirs[0]["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(mine[0]["valid_loss"],
                               theirs[0]["valid_loss"], rtol=1e-3)
    assert mine[0]["valid_accuracy"] == theirs[0]["valid_accuracy"]


def _steps_per_epoch(index):
    """Train steps an epoch of _options' trainer takes on ``index``."""
    return len(train_split_stratified(index.labels, 0.25)[0]) // 16


def _guard_steps(monkeypatch):
    """Wrap every multistep that ``train`` makes so that each call of its
    step runs with the Tensor methods of HOST_READS raising. Returns the
    list that counts those calls."""
    real, calls = train.make_train_multistep, []

    def raiser(name):
        def read(*args, **kwargs):
            raise AssertionError(f"the step read a tensor back: {name}")
        return read

    def make(*args, **kwargs):
        ms = real(*args, **kwargs)
        step = ms.step

        def guarded():
            with pytest.MonkeyPatch.context() as m:
                for name in HOST_READS:
                    m.setattr(torch.Tensor, name, raiser(name))
                with pytest.raises(AssertionError, match="read a tensor"):
                    torch.zeros(()).item()  # the guard is live
                step()
            calls.append(1)

        ms.step = guarded
        return ms

    monkeypatch.setattr(train, "make_train_multistep", make)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_step_reads_nothing_back(tmp_path, monkeypatch, dtype):
    """The step that the card captures (dropout, view and intensity
    augmentation on, a learning-rate schedule) runs inside Trainer.fit
    with every Tensor method that reads a value back raising: it takes no
    host input. The history and parameters equal the unguarded fit's."""
    kw = dict(spec=SPEC_DROPOUT, augment=True, intensity_augment=0.3,
              lr_schedule=(1e-3, 1e-4), steps_per_call=2)
    index = _tiny_index(seed=7)

    def fit(name):
        tr = Trainer(_options(name, max_epochs=2, train_dtype=dtype), **kw,
                     weights_path=str(tmp_path / name))
        hist = tr.fit(index)
        return [{k: v for k, v in h.items() if k != "dur"} for h in hist], \
            tr.params

    want = fit("plain")
    calls = _guard_steps(monkeypatch)
    got = fit("guarded")
    assert len(calls) == 2 * _steps_per_epoch(index)
    assert got[0] == want[0]
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])


def _to_parent_format(state_file, spec):
    """Rewrite a state file's optimizer as the parent format wrote it:
    ``torch.optim.Adam``'s state dict (a CPU step count per parameter, a
    float learning rate), the same moments."""
    with open(state_file, "rb") as fh:
        st = pickle.load(fh)
    net = TriPlanarNet.from_params(
        {k: torch.from_numpy(v) for k, v in st["params"].items()}, spec,
        CPU, trainable=True)
    adam = torch.optim.Adam(net.parameters(), **ADAM)
    for i, p in enumerate(net.parameters()):
        saved = st["optimizer"]["state"][i]
        adam.state[p] = {"step": torch.tensor(float(saved["step"])),
                         "exp_avg": torch.from_numpy(saved["exp_avg"]),
                         "exp_avg_sq": torch.from_numpy(saved["exp_avg_sq"])}
    st["optimizer"] = _to_numpy(adam.state_dict())
    assert st["optimizer"]["param_groups"][0]["capturable"] is False
    with open(state_file, "wb") as fh:
        pickle.dump(st, fh)


@pytest.mark.parametrize("fmt", ["fit", "parent"])
def test_resume_matches_uninterrupted(tmp_path, fmt):
    """test_trainer_resume_matches_uninterrupted's form at steps_per_call
    2: a state file written by fit, and the same file with its optimizer
    in torch.optim.Adam's format, each resume to the uninterrupted
    history."""
    spec = TriPlanarSpec(**NARROW)
    index = _tiny_index(seed=4)
    kw = dict(spec=spec, augment=True, shuffle_each_epoch=True,
              steps_per_call=2)

    def strip(h):
        return {k: v for k, v in h.items() if k != "dur"}

    whole = Trainer(_options("whole", max_epochs=2), **kw,
                    weights_path=str(tmp_path / "a")).fit(index)
    part = Trainer(_options("part", max_epochs=1), **kw,
                   weights_path=str(tmp_path / "b"))
    part.fit(index)
    if fmt == "parent":
        _to_parent_format(part.state_file, spec)
    resumed = Trainer(_options("part", max_epochs=2, load_weights=True),
                      **kw, weights_path=str(tmp_path / "b"))
    assert resumed.epoch == 1
    assert float(resumed.optimizer._count) == _steps_per_epoch(index)
    hist = resumed.fit(index)
    assert [strip(h) for h in hist] == [strip(h) for h in whole]


def test_nan_checks_raise_on_the_fit(tmp_path):
    """With the checks on, a fit from a NaN parameter raises
    FloatingPointError naming the first step whose loss is NaN, after the
    call that ran it."""
    params = init_params(SPEC, torch.Generator().manual_seed(0))
    params["fc1.weight"][0, 0] = float("nan")
    tr = Trainer(_options("nan"), spec=SPEC, params=params,
                 weights_path=str(tmp_path))
    runtime.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError,
                           match="NaN in the train loss of epoch 1, step 1 "):
            tr.fit(_tiny_index())
    finally:
        runtime.NAN_CHECKS = False
        torch.autograd.set_detect_anomaly(False)
