"""PyTorch port: the train multistep in a data-parallel rank, on the CPU
over gloo ranks.

``Trainer.fit`` in a rank runs its steps through ``make_train_multistep``
as one process does: on the card, in a rank whose group runs NCCL, one
captured step replayed, the synced BN's and the gradients' all-reduces
inside the graph; with gloo (the CPU, two ranks on one card) the plain
loop. Here two gloo ranks run the rank multistep against the JAX package's
``make_train_multistep`` over a 2-device mesh (the (K, 2B) inputs sharded
``P(None, "data")``, as its ``Trainer.fit`` puts them), at
tests/test_torch_multistep.py's bounds: losses rtol 1e-4, Adam's moments
rtol 1e-4 / atol 1e-6 on the gradient's scale, parameters within 1e-6
where the mean gradient exceeds 1e-5, BN EMA within 1e-6. The rank's step
runs with every read-back raising, and the rule that picks the graph is
held on its own. The card's versions (a world-1 NCCL rank's graphed fit
against its eager fit; a capture that fails the launch) are in
tests/test_torch_cuda.py, which imports the rank functions from here.

The rank functions live in this module, so it imports no jax at module
level: a spawned rank imports it.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from subcort_tpu_torch.engine import Trainer, train, train_split_stratified
from subcort_tpu_torch.engine.train import (ADAM, DeviceAdam,
                                            make_train_multistep)
from subcort_tpu_torch.models import TriPlanarNet, TriPlanarSpec
from subcort_tpu_torch.ops.gather_kernel import prepare_gather_volume
from subcort_tpu_torch.parallel import distributed, sync_bn
from test_torch_distributed import NARROW, WAIT_S, _index, _options

torch.set_num_threads(1)

CPU = torch.device("cpu")
K, B = 3, 16    # steps per call; rows per rank
SPEC = TriPlanarSpec(**NARROW, dropout_conv=0.0, dropout_fc=0.0)
SPEC_DROPOUT = TriPlanarSpec(**NARROW, dropout_conv=0.5, dropout_fc=0.5)


@pytest.fixture(autouse=True)
def _bounded_fit(monkeypatch):
    monkeypatch.setattr(distributed, "FIT_TIMEOUT_S", WAIT_S)


def _launch(target, devices, *args):
    return distributed.launch(target, devices, args, timeout=WAIT_S)


# ------------------------------------------------------------ against JAX
def _multistep_rank(rank, world, device, workdir):
    """A rank's K steps in one multistep call on its B rows of each step's
    global batch (``workdir``'s params and stacks): the losses' mean over
    the ranks, the state dict and Adam's state."""
    work = Path(workdir)
    params = torch.load(work / "params.pt")
    data = np.load(work / "stacks.npz")
    net = TriPlanarNet.from_params(params, SPEC, device, trainable=True)
    optimizer = DeviceAdam(net.parameters(), **ADAM)
    volume = prepare_gather_volume(torch.from_numpy(data["vols"]).to(device))
    mine = slice(rank * B, (rank + 1) * B)
    with make_train_multistep(net, optimizer, volume, None, SPEC.patch_size,
                              K) as ms:
        losses = sync_bn.all_reduce_mean(ms(*(
            torch.from_numpy(data[k][:, mine]).to(device)
            for k in ("centers", "labels", "atlas"))))
    torch.save({"losses": losses.cpu(),
                "state": {k: v.cpu() for k, v in net.state_dict().items()},
                "adam": {name: {k: v.cpu() for k, v in
                                optimizer.state[p].items()}
                         for name, p in net.named_parameters()}},
               work / f"rank{rank}.pt")


def test_rank_multistep_matches_jax_over_a_two_device_mesh(tmp_path):
    """Two gloo ranks, K = 3 steps in one call from the same JAX params
    (converted by the importer) on the same (K, 2B) stacks, against the
    JAX package's make_train_multistep over make_mesh(2) with the inputs
    sharded P(None, "data"): the K global losses, each rank's parameters,
    BN EMA and Adam state; the two ranks' states equal bit for bit."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from subcort_tpu.engine.train import \
        make_train_multistep as jax_make_train_multistep
    from subcort_tpu.models import init_params as jax_init_params
    from subcort_tpu.parallel.mesh import make_mesh
    from subcort_tpu_torch.models import params_from_jax
    from test_torch_multistep import assert_state_matches_jax
    from test_torch_train import JAX_SPEC, _batch
    from test_torch_train import SPEC as TRAIN_SPEC

    assert SPEC == TRAIN_SPEC
    # tests/test_torch_multistep.py's params (key 7) and stacks, at 2B rows
    jax_params = jax_init_params(jax.random.key(7), JAX_SPEC)
    vols, centers, labels, atlas = _batch(0, K * 2 * B)
    stacks = dict(vols=vols, centers=centers.reshape(K, 2 * B, 4),
                  labels=labels.astype(np.int64).reshape(K, 2 * B),
                  atlas=atlas.reshape(K, 2 * B, 15))
    np.savez(tmp_path / "stacks.npz", **stacks)
    torch.save(params_from_jax(jax_params, SPEC), tmp_path / "params.pt")
    assert _launch(_multistep_rank, [CPU, CPU], str(tmp_path)) == "gloo"

    mesh = make_mesh(2)
    whole, split = NamedSharding(mesh, P()), NamedSharding(mesh, P(None,
                                                                   "data"))
    opt = optax.adam(ADAM["lr"], b1=0.9, b2=0.999, eps=1e-8)
    params = jax.device_put(jax_params, whole)
    jp, jstate, jlosses = jax_make_train_multistep(opt, JAX_SPEC)(
        params, opt.init(params), jax.device_put(jnp.asarray(vols), whole),
        *(jax.device_put(jnp.asarray(stacks[k]), split)
          for k in ("centers", "labels", "atlas")), jax.random.key(1))
    assert len(jlosses.sharding.device_set) == 2

    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for r in ranks:
        assert r["losses"].shape == (K,)
        np.testing.assert_allclose(r["losses"].numpy(), np.asarray(jlosses),
                                   rtol=1e-4)
        assert_state_matches_jax(r["state"], r["adam"], jp, jstate, K)
    for k, v in ranks[0]["state"].items():
        assert torch.equal(ranks[1]["state"][k], v), k
    for name, st in ranks[0]["adam"].items():
        for k, v in st.items():
            assert torch.equal(ranks[1]["adam"][name][k], v), (name, k)


# ------------------------------------------------------------ no host read
def _guarded_fit_rank(rank, world, device, workdir, host_reads):
    """Inside the rank: a 2-epoch fit (dropout, view and intensity
    augmentation, a learning-rate schedule, 2 steps a call), then the same
    fit with every call of the multistep's step run with the Tensor
    methods ``host_reads`` raising. Saves both histories and parameters
    and the guarded calls' count."""
    index = _index(7, 120)

    def fit(name):
        trainer = Trainer(_options(name, max_epochs=2), spec=SPEC_DROPOUT,
                          augment=True, intensity_augment=0.3,
                          lr_schedule=(1e-3, 1e-4), steps_per_call=2,
                          weights_path=str(Path(workdir) / f"{name}{rank}"))
        history = trainer.fit(index)
        return ([{k: v for k, v in h.items() if k != "dur"}
                 for h in history], trainer.params)

    def raiser(name):
        def read(*args, **kwargs):
            raise AssertionError(f"the step read a tensor back: {name}")
        return read

    real, calls = train.make_train_multistep, []

    def make(*args, **kwargs):
        ms = real(*args, **kwargs)
        step = ms.step

        def guarded():
            with pytest.MonkeyPatch.context() as m:
                for name in host_reads:
                    m.setattr(torch.Tensor, name, raiser(name))
                with pytest.raises(AssertionError, match="read a tensor"):
                    torch.zeros(()).item()  # the guard is live
                step()
            calls.append(1)

        ms.step = guarded
        return ms

    plain = fit("plain")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(train, "make_train_multistep", make)
        guarded = fit("guarded")
    torch.save({"plain": plain, "guarded": guarded, "calls": len(calls)},
               Path(workdir) / f"guard{rank}.pt")


def test_rank_step_reads_nothing_back(tmp_path):
    """The step that an NCCL rank captures (dropout, both augmentations,
    the synced BN's all-reduces forward and backward, the gradients'
    all-reduce) runs inside a 2-rank group's fit with every Tensor method
    that reads a value back raising: it takes no host input. Each rank's
    history and parameters equal its unguarded fit's."""
    from test_torch_ffd import HOST_READS

    _launch(_guarded_fit_rank, [CPU, CPU], str(tmp_path), HOST_READS)
    t_idx, _ = train_split_stratified(_index(7, 120).labels, 0.25)
    for rank in range(2):
        got = torch.load(tmp_path / f"guard{rank}.pt", weights_only=False)
        assert got["calls"] == 2 * (len(t_idx) // (2 * B))
        assert got["guarded"][0] == got["plain"][0]
        assert all(torch.equal(got["guarded"][1][k], v)
                   for k, v in got["plain"][1].items())


# ------------------------------------------------------------ the rule
@pytest.mark.parametrize("backend,device,want", [
    ("nccl", "cuda", True), ("gloo", "cuda", False), ("nccl", "cpu", False),
    ("gloo", "cpu", False)])
def test_step_capturable_rule(monkeypatch, backend, device, want):
    """A rank captures its step where its default group runs NCCL on a
    card, and nowhere else."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    assert distributed.step_capturable(torch.device(device)) is want


def test_step_capturable_needs_a_group():
    assert not dist.is_initialized()
    assert not distributed.step_capturable(torch.device("cuda", 0))


@pytest.fixture()
def rank_of_one():
    """This process as the one rank of a gloo group, inside its
    data-parallel block."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        with sync_bn.data_parallel(0, 1):
            yield
    finally:
        dist.destroy_process_group()


def _eager_passed(monkeypatch, tmp_path, capturable, eager):
    """The ``_eager`` that a 1-epoch fit passes to make_train_multistep,
    with the capture rule answering ``capturable``."""
    monkeypatch.setattr(distributed, "step_capturable",
                        lambda device: capturable)
    real, passed = train.make_train_multistep, []

    def make(*args, **kwargs):
        passed.append(kwargs["_eager"])
        return real(*args, **kwargs)

    monkeypatch.setattr(train, "make_train_multistep", make)
    Trainer(_options("rule"), spec=SPEC,
            weights_path=str(tmp_path)).fit(_index(3, 60), _eager=eager)
    return passed


@pytest.mark.parametrize("capturable,eager,want", [
    (True, False, False), (False, False, True), (True, True, True)],
    ids=["nccl", "gloo", "private_eager"])
def test_fit_in_a_rank_takes_the_rule(monkeypatch, tmp_path, rank_of_one,
                                      capturable, eager, want):
    """In a rank, fit asks for the plain loop where the rule says the step
    cannot be captured, or where the caller asks for it."""
    assert _eager_passed(monkeypatch, tmp_path, capturable, eager) == [want]


def test_fit_in_one_process_ignores_the_rule(monkeypatch, tmp_path):
    """Outside a data-parallel block the rule is not asked: one process
    captures on the card as before."""
    assert _eager_passed(monkeypatch, tmp_path, False, False) == [False]


def test_gloo_ranks_report_eager_steps(tmp_path, capsys):
    """A fit over two gloo ranks: each rank reports the plain loop, and
    the trainer keeps and prints every rank's report."""
    trainer = Trainer(_options("report", net_verbose=1), spec=SPEC,
                      weights_path=str(tmp_path), devices=[CPU, CPU])
    trainer.fit(_index(4, 100))
    eager = {"graphed": False, "warmup_steps": 0, "replays": 0,
             "capture_ms": None}
    assert trainer.rank_steps == [eager, eager]
    out = capsys.readouterr().out
    assert "rank 0's steps" in out and "rank 1's steps" in out


# ------------------------------------------------------------ the card's
def train_ranks(rank, world, device, workdirs):
    """``train.train_rank`` on each handoff of ``workdirs`` in turn,
    in one rank process (tests/test_torch_cuda.py: a graphed and an eager
    fit of one NCCL rank)."""
    for workdir in workdirs:
        train.train_rank(rank, world, device, workdir)


def failing_capture_rank(rank, world, device, workdir):
    """``train.train_rank`` with a step that reads a value back, which
    the eager warm-up steps run and a capture refuses. Each call of the
    step adds one to ``workdir``'s ``calls`` file."""
    calls = Path(workdir) / "calls"
    real = train.TrainMultistep.step

    def step(self):
        calls.write_text(str(int(calls.read_text()) + 1
                             if calls.exists() else 1))
        real(self)
        float(self.losses.sum())

    train.TrainMultistep.step = step
    train.train_rank(rank, world, device, workdir)
