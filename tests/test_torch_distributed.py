"""PyTorch port: several processes (``parallel/distributed.py``) and the
data-parallel train step (``parallel/sync_bn.py``), on the CPU over gloo.

Two ranks run in processes of their own, started by the port's launcher
(``distributed.launch``, the spawn start method, a timeout on every wait,
the group's store hosted by the launcher) or, for the multi-host group, as
two ``python -c`` processes, as tests/test_distributed.py starts the JAX
package's, on a coordinator port that the test holds until both exit.
The rank functions live in this module, so it imports no jax at module
level: a spawned rank imports it, and the test that reads a rank's
modules holds that rank to no ``jax`` and no ``subcort_tpu``. The card's
versions of these tests are in tests/test_torch_cuda.py, which imports
the rank functions from here.

Tolerances: a 2-rank step against the one-process step on the global
batch (the same rows, draws and parameters) differs in summation order
only: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6, BN EMA atol 1e-6
(tests/test_torch_train.py's ``test_train_step_matches_jax``); synced BN
against ``_BatchNorm`` on the concatenated batch within 1e-6 in float32.
In bfloat16 the output equals the one-process output, the statistics are
held to the bfloat16 step's 1e-6, and the backward, which the synced BN
takes in float32 and rounds once per rank, to within twice the
one-process bfloat16 backward's distance from float32. A 2-rank ``fit`` against the JAX package's
``Trainer(data_parallel=2)``: train_loss rtol 1e-4, valid_loss rtol 1e-3,
valid_accuracy equal (``test_trainer_epoch_matches_jax_trainer``).
"""

import contextlib
import errno
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine import Trainer, TrainingIndex
from subcort_tpu_torch.engine.train import ADAM, train_step
from subcort_tpu_torch.models import TriPlanarNet, TriPlanarSpec
from subcort_tpu_torch.models.triplanar import _BatchNorm, init_params
from subcort_tpu_torch.ops.gather_kernel import (gather_triplanar_cuda,
                                                 prepare_gather_volume)
from subcort_tpu_torch.parallel import distributed, sync_bn

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NARROW = dict(conv_filters=(8, 8, 8, 8, 8), fc_conv=16, fc_fc=16, fc2=16)
EXTENT = (20, 22, 18)
CPU = torch.device("cpu")
B = 16          # rows per rank
WAIT_S = 120    # the launcher's timeout


def _jax_modules() -> list:
    return sorted(k for k in sys.modules if k in ("jax", "subcort_tpu")
                  or k.startswith(("jax.", "subcort_tpu.")))


def _launch(target, devices, *args):
    return distributed.launch(target, devices, args, timeout=WAIT_S)


@pytest.fixture(autouse=True)
def _bounded_fit(monkeypatch):
    """A data-parallel ``Trainer.fit`` waits for its ranks no longer than
    the launcher's timeout here, whatever a rank does."""
    monkeypatch.setattr(distributed, "FIT_TIMEOUT_S", WAIT_S)


# ------------------------------------------------------------ the join
JOINS, PROCS = 20, 3
JOIN_SLACK_S = 2.0  # a join returns this soon after the last exit


def _stamp_and_exit(t_exit, path):
    """Spin until ``t_exit``, so that the processes of one join exit
    together, then write the time as the last act."""
    while time.time() < t_exit:
        pass
    fd = os.open(path, os.O_WRONLY | os.O_CREAT)
    os.write(fd, repr(time.time()).encode())
    os.close(fd)


@pytest.mark.filterwarnings("ignore:.*fork")
def test_join_returns_within_a_poll_of_the_last_exit(tmp_path):
    """``distributed.join`` on processes that exit within microseconds of
    each other: it returns within ``JOIN_SLACK_S`` of the last one's final
    stamp in every join. (A join that rebuilt its list of running
    processes after the last one exited waited on an empty list, which
    sleeps out the whole timeout.) The processes are forked, so that they
    start at once and can exit together, and import nothing; each join has
    a timeout of 10 s and stops what still runs, so a miss fails, not
    hangs."""
    import multiprocessing as mp

    ctx = mp.get_context("fork")
    late = []
    for j in range(JOINS):
        t_exit = time.time() + 0.05
        paths = [tmp_path / f"stamp{j}_{i}" for i in range(PROCS)]
        procs = [ctx.Process(target=_stamp_and_exit, args=(t_exit, str(p)),
                             daemon=True) for p in paths]
        for p in procs:
            p.start()
        try:
            distributed.join(procs, timeout=10.0)
            returned = time.time()
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
                p.join()
        last = max(float(p.read_text()) for p in paths)
        late.append(returned - last)
    assert max(late) < JOIN_SLACK_S, [f"{s:.3f}" for s in late]


def _stamp_rank(rank, world, device, workdir):
    sync_bn.all_reduce_sum(torch.ones(1))  # both ranks reach the end
    (Path(workdir) / f"rank{rank}").write_text(repr(time.time()))


def test_launch_returns_soon_after_its_ranks_exit(tmp_path):
    """One real ``launch`` over [cpu, cpu]: it returns within
    ``JOIN_SLACK_S`` of the later rank's last act of its target (the rank
    then leaves the group and its interpreter exits)."""
    assert _launch(_stamp_rank, [CPU, CPU], str(tmp_path)) == "gloo"
    returned = time.time()
    last = max(float((tmp_path / f"rank{r}").read_text()) for r in range(2))
    assert returned - last < JOIN_SLACK_S, returned - last


# ------------------------------------------------------------ synced BN
C, HW, EPS = 8, 6, 1e-4


def _bn_inputs(world: int):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((world * B, C, HW, HW)) * 3 + 1.5).astype(
        np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    gamma = rng.random(C).astype(np.float32) + 0.5
    beta = rng.standard_normal(C).astype(np.float32)
    return x, dy, gamma, beta


def _bn(x, dy, gamma, beta, dtype):
    """``_BatchNorm`` in training mode on ``x`` in ``dtype``, backward of
    sum(y * dy): (y, mean, inv_std, dx, dgamma, dbeta) as float32 numpy."""
    bn = _BatchNorm(C, EPS)
    with torch.no_grad():
        bn.gamma.copy_(torch.from_numpy(gamma))
        bn.beta.copy_(torch.from_numpy(beta))
    bn = bn.to(dtype).train()
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    y = bn(xt)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    mean, inv_std = bn.batch_stats
    return [t.detach().float().numpy() for t in
            (y, mean, inv_std, xt.grad, bn.gamma.grad, bn.beta.grad)]


def _bn_rank(rank, world, device, workdir, dtype_name):
    """A rank's share of :func:`_bn`, and the modules it imported."""
    x, dy, gamma, beta = _bn_inputs(world)
    rows = slice(rank * B, (rank + 1) * B)
    out = _bn(x[rows], dy[rows], gamma, beta, getattr(torch, dtype_name))
    np.savez(Path(workdir) / f"bn{rank}.npz", *out)
    (Path(workdir) / f"modules{rank}.json").write_text(
        json.dumps(_jax_modules()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synced_batch_norm_matches_one_process(tmp_path, dtype):
    """Two ranks' BN forward and backward against the one-process BN on
    the concatenated batch; a spawned rank imports neither jax nor the
    JAX package."""
    assert _launch(_bn_rank, [CPU, CPU], str(tmp_path), dtype) == "gloo"
    x, dy, gamma, beta = _bn_inputs(2)
    y, mean, inv_std, dx, dgamma, dbeta = _bn(x, dy, gamma, beta,
                                              getattr(torch, dtype))
    ranks = [np.load(tmp_path / f"bn{r}.npz") for r in range(2)]
    got = [np.concatenate([r[f"arr_{i}"] for r in ranks]) for i in (0, 3)]
    for r in ranks:  # every rank holds the global statistics
        np.testing.assert_allclose(r["arr_1"], mean, rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["arr_2"], inv_std, rtol=0, atol=1e-6)
    # gamma's and beta's gradients are each rank's sums
    sums = [ranks[0][f"arr_{i}"] + ranks[1][f"arr_{i}"] for i in (4, 5)]
    if dtype == "float32":
        np.testing.assert_allclose(got[0], y, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[1], dx, rtol=0, atol=1e-6)
        np.testing.assert_allclose(sums[0], dgamma, rtol=0, atol=1e-5)
        np.testing.assert_allclose(sums[1], dbeta, rtol=0, atol=1e-5)
    else:
        # the forward rounds where the one-process branch does
        np.testing.assert_array_equal(got[0], y)
        ref = _bn(x, dy, gamma, beta, torch.float32)
        for i, (g, one) in enumerate(((got[1], dx), (sums[0], dgamma),
                                      (sums[1], dbeta))):
            f32 = ref[3 + i]
            assert np.abs(g - f32).max() <= 2 * np.abs(one - f32).max(), i
    for r in range(2):
        assert json.loads((tmp_path / f"modules{r}.json").read_text()) == []


# ------------------------------------------------------------ the step
def _step_inputs(world: int):
    """The global batch of ``world x B`` rows of a 2-subject stack."""
    rng = np.random.default_rng(3)
    vols = rng.standard_normal(
        (2,) + tuple(e + 32 for e in EXTENT)).astype(np.float32)
    n = world * B
    centers = np.stack([rng.integers(0, 2, n)]
                       + [rng.integers(0, e, n) for e in EXTENT],
                       1).astype(np.int32)
    labels = rng.integers(0, 15, n).astype(np.int64)
    atlas = rng.random((n, 15)).astype(np.float32)
    return vols, centers, labels, atlas


def _one_step(rows, device, world, perturb=False, dtype=torch.float32):
    """A train step in ``dtype`` with augmentation, intensity augmentation
    and dropout on, from seeded params and generator, on ``rows`` of the
    global batch. ``perturb`` shifts the params before rank 0's are
    broadcast. Returns (loss, {grad}, {state}) on the CPU."""
    spec = TriPlanarSpec(**NARROW)
    params = init_params(spec, torch.Generator().manual_seed(5))
    if perturb:
        params = {k: v + 1.0 for k, v in params.items()}
    net = TriPlanarNet.from_params(params, spec, device,
                                   trainable=True).to(dtype)
    optimizer = torch.optim.Adam(net.parameters(), **ADAM)
    sync_bn.broadcast_module(net)
    vols, centers, labels, atlas = _step_inputs(world)
    volume = prepare_gather_volume(torch.from_numpy(vols).to(device))
    views = tuple(v.to(dtype) for v in gather_triplanar_cuda(
        volume, torch.from_numpy(centers[rows]).to(device)))
    generator = torch.Generator(device=device).manual_seed(9)
    loss = train_step(net, optimizer, views,
                      torch.from_numpy(labels[rows]).to(device),
                      torch.from_numpy(atlas[rows]).to(device, dtype),
                      generator, augment=True, intensity_augment=0.5)
    grads = {k: p.grad.cpu() for k, p in net.named_parameters()}
    return float(loss), grads, {k: v.cpu()
                                for k, v in net.state_dict().items()}


def _step_rank(rank, world, device, workdir, dtype_name="float32"):
    loss, grads, state = _one_step(slice(rank * B, (rank + 1) * B), device,
                                   world, perturb=rank > 0,
                                   dtype=getattr(torch, dtype_name))
    torch.save({"loss": loss, "grads": grads, "state": state},
               Path(workdir) / f"step{rank}.pt")


def check_step(workdir, one, world: int = 2, atol: float = 1e-6,
               rtol: float = 1e-4, loss_rtol: float = 1e-5) -> None:
    """The ranks' step files against ``one``, the one-process step's
    (loss, grads, state): the ranks' mean loss, each rank's gradients and
    BN EMA; the ranks' parameters equal to each other."""
    ranks = [torch.load(Path(workdir) / f"step{r}.pt") for r in range(world)]
    loss, grads, state = one
    np.testing.assert_allclose(np.mean([r["loss"] for r in ranks]), loss,
                               rtol=loss_rtol)
    for r in ranks:
        for k, g in grads.items():
            np.testing.assert_allclose(r["grads"][k].numpy(), g.numpy(),
                                       rtol=rtol, atol=atol, err_msg=k)
        for k, v in state.items():
            if k.endswith((".mean", ".inv_std")):
                np.testing.assert_allclose(r["state"][k].numpy(), v.numpy(),
                                           rtol=0, atol=atol, err_msg=k)
            # Adam runs identically on every rank
            assert torch.equal(r["state"][k], ranks[0]["state"][k]), k


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_step_over_two_ranks_matches_the_global_batch(tmp_path, dtype):
    """Two ranks of B rows against one process on the 2B rows, with view
    and intensity augmentation and dropout drawn: every rank draws the
    global batch's tensors and keeps its rows. Rank 1 starts from other
    params, which rank 0's broadcast replaces. float64 keeps the
    statistics and the backward in float64: what is left is summation
    order, held to 1e-9 (gradients) and 1e-12 (BN EMA); the loss is a
    float32 mean in every step (the logits are cast for the
    cross-entropy), held to 1e-7."""
    _launch(_step_rank, [CPU, CPU], str(tmp_path), dtype)
    one = _one_step(slice(0, 2 * B), CPU, 2, dtype=getattr(torch, dtype))
    if dtype == "float32":
        check_step(tmp_path, one)
    else:
        check_step(tmp_path, one, atol=1e-12, rtol=1e-9, loss_rtol=1e-7)


def _nccl_rank(rank, world, device, workdir):
    """World 1 (the card's NCCL test): the synced step, and the synced BN
    Function called directly, beside ``_BatchNorm``'s native statistics."""
    _step_rank(rank, world, device, workdir)
    x, dy, gamma, beta = _bn_inputs(1)
    xt = torch.from_numpy(x).to(device)
    g, b = (torch.from_numpy(t).to(device) for t in (gamma, beta))
    synced = sync_bn.sync_batch_norm(xt, g, b, EPS)
    native = torch.native_batch_norm(xt, g, b, None, None, True, 0.0, EPS)
    torch.save({"synced": [t.cpu() for t in synced],
                "native": [t.cpu() for t in native]},
               Path(workdir) / "bn_world1.pt")


def _failing_rank(rank, world, device):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    sync_bn.all_reduce_sum(torch.ones(1))  # waits for rank 1


def test_a_failing_rank_fails_the_launch():
    """A rank that raises fails the launch at once, and the rank left
    waiting in a collective is stopped, not waited for."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] of 2"):
        _launch(_failing_rank, [CPU, CPU])
    assert time.monotonic() - t0 < WAIT_S / 2


# ------------------------------------------------------------ the rendezvous
LAUNCHES = 4    # 2-rank launches started at once


def _sum_rank(rank, world, device, workdir, launch):
    """All-reduce a value unique to ``launch`` and this rank; keep the
    sum."""
    t = torch.tensor([100.0 * (launch + 1) + rank], dtype=torch.float64)
    dist.all_reduce(t)
    (Path(workdir) / f"sum{rank}").write_text(repr(float(t[0])))


def test_concurrent_launches_each_keep_their_own_group(tmp_path):
    """``LAUNCHES`` 2-rank launches started together from as many threads:
    each returns ``gloo`` and each rank's sum is its own launch's, so no
    rank joined another launch's group."""
    works = [tmp_path / f"launch{k}" for k in range(LAUNCHES)]
    for work in works:
        work.mkdir()
    with ThreadPoolExecutor(LAUNCHES) as pool:
        futures = [pool.submit(_launch, _sum_rank, [CPU, CPU], str(work), k)
                   for k, work in enumerate(works)]
        assert [f.result() for f in futures] == ["gloo"] * LAUNCHES
    for k, work in enumerate(works):
        want = 2 * 100.0 * (k + 1) + 1
        assert [float((work / f"sum{r}").read_text())
                for r in range(2)] == [want, want], k


def _bind_errno(port: int) -> int:
    """0 if a plain bind to ``port`` on localhost succeeds, else its
    errno."""
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
        except OSError as e:
            return e.errno
    return 0


def _port_rank(rank, world, device, workdir):
    """Try to bind the launcher's rendezvous port as the rank starts and
    again once both ranks are past a collective; keep both errnos."""
    port = int((Path(workdir) / "port").read_text())
    first = _bind_errno(port)
    sync_bn.all_reduce_sum(torch.ones(1))
    (Path(workdir) / f"bind{rank}").write_text(
        json.dumps([first, _bind_errno(port)]))


def test_launcher_holds_the_rendezvous_port(tmp_path, monkeypatch):
    """The port that the launcher's store was given is bound in the
    launcher's process for the whole launch: inside each rank, at its
    start and at its end, a plain bind to it fails with EADDRINUSE."""
    real = distributed._rendezvous_store

    def recorded(world):
        store = real(world)
        (tmp_path / "port").write_text(str(store.port))
        return store

    monkeypatch.setattr(distributed, "_rendezvous_store", recorded)
    assert _launch(_port_rank, [CPU, CPU], str(tmp_path)) == "gloo"
    assert int((tmp_path / "port").read_text()) > 0
    for r in range(2):
        assert json.loads((tmp_path / f"bind{r}").read_text()) == [
            errno.EADDRINUSE, errno.EADDRINUSE], r


@contextlib.contextmanager
def _reserved_port():
    """A localhost port held by a socket bound under ``SO_REUSEADDR`` and
    not listening: no other process's bind can take it, and a store can
    still listen on it."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        yield s.getsockname()[1]


def _idle_rank(rank, world, device):
    pass


def test_a_rank_that_cannot_reach_the_store_fails_the_launch(monkeypatch):
    """Ranks handed a port where no store listens fail their launch
    through the join (each rank's connection times out after the
    launcher's timeout), well inside ``WAIT_S``: nothing retries on
    another port and nothing hangs."""
    monkeypatch.setattr(distributed, "COLLECTIVE_TIMEOUT_S", 2)
    with _reserved_port() as port:
        monkeypatch.setattr(distributed, "_rendezvous_store",
                            lambda world: types.SimpleNamespace(
                                host="127.0.0.1", port=port))
        t0 = time.monotonic()
        with pytest.raises(RuntimeError,
                           match=r"ranks \[(0|1|0, 1)\] of 2 exited"):
            _launch(_idle_rank, [CPU, CPU])
    assert time.monotonic() - t0 < WAIT_S / 2


# ------------------------------------------------------------ the trainer
def _index(seed, n):
    rng = np.random.default_rng(seed)
    vols = rng.standard_normal(
        (2,) + tuple(e + 32 for e in EXTENT)).astype(np.float32)
    centers = np.stack([rng.integers(0, 2, n)]
                       + [rng.integers(0, e, n) for e in EXTENT],
                       1).astype(np.int32)
    return TrainingIndex(vols, centers, rng.integers(0, 15, n).astype(np.int32),
                         rng.random((n, 15)).astype(np.float32), ["s0", "s1"])


COMMON = dict(batch_size=B, max_epochs=1, patience=5, train_split=0.25,
              net_verbose=0, load_weights=False, seed=1)


def _options(name, **kw):
    return Options(**{**COMMON, "experiment": name, "mode": "cpu", **kw})


def test_trainer_over_two_ranks_matches_jax_trainer(tmp_path):
    """One epoch of ``Trainer(devices=[cpu, cpu])`` against the JAX
    package's ``Trainer(data_parallel=2)`` from the same params and index
    (dropout 0, augmentation and shuffle off): 3 global steps of 32 rows.
    (127 training rows; the remainder is dropped at that granularity).
    Only rank 0 writes: one history line, and the files of one trainer;
    the trainer that started the ranks holds rank 0's final state."""
    import jax

    from subcort_tpu.config import Options as JaxOptions
    from subcort_tpu.engine.data import TrainingIndex as JaxTrainingIndex
    from subcort_tpu.engine.train import Trainer as JaxTrainer
    from subcort_tpu.models import init_params as jax_init_params
    from subcort_tpu.models.triplanar import TriPlanarSpec as JaxSpec
    from subcort_tpu_torch.models import load_theano_checkpoint, \
        params_from_jax

    spec = TriPlanarSpec(**NARROW, dropout_conv=0.0, dropout_fc=0.0)
    jspec = JaxSpec(**NARROW, dropout_conv=0.0, dropout_fc=0.0)
    jparams = jax_init_params(jax.random.key(5), jspec)
    index = _index(6, 170)
    trainer = Trainer(_options("e"), spec=spec,
                      params=params_from_jax(jparams, spec),
                      weights_path=str(tmp_path / "port"), devices=[CPU, CPU])
    mine = trainer.fit(index)
    theirs = JaxTrainer(JaxOptions(**COMMON, experiment="e", data_parallel=2),
                        spec=jspec,
                        params=jparams, weights_path=str(tmp_path / "jax")).fit(
        JaxTrainingIndex(index.volumes, index.centers, index.labels,
                         index.atlas, index.subject_names))
    np.testing.assert_allclose(mine[0]["train_loss"],
                               theirs[0]["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(mine[0]["valid_loss"],
                               theirs[0]["valid_loss"], rtol=1e-3)
    assert mine[0]["valid_accuracy"] == theirs[0]["valid_accuracy"]
    d = tmp_path / "port" / "e"
    assert sorted(p.name for p in d.iterdir()) == [
        "e.pkl", "e_history.jsonl", "e_history.pkl", "e_state.pkl"]
    assert len((d / "e_history.jsonl").read_text().splitlines()) == 1
    assert trainer.epoch == 1 and len(trainer.rank_launches) == 2
    best = load_theano_checkpoint(str(d / "e.pkl"))
    assert all(torch.equal(best[k], v) for k, v in trainer.params.items())


def test_trainer_resume_over_two_ranks_matches_uninterrupted(tmp_path):
    """Two epochs over two ranks, against one epoch, then a resume from the
    state file for the second (augmentation, dropout and a per-epoch
    shuffle all draw): the same history."""
    spec = TriPlanarSpec(**NARROW)
    index = _index(4, 100)
    kw = dict(spec=spec, augment=True, shuffle_each_epoch=True,
              devices=[CPU, CPU])

    def strip(h):
        return [{k: v for k, v in e.items() if k != "dur"} for e in h]

    whole = Trainer(_options("whole", max_epochs=2), **kw,
                    weights_path=str(tmp_path / "a")).fit(index)
    Trainer(_options("part"), **kw, weights_path=str(tmp_path / "b")).fit(
        index)
    resumed = Trainer(_options("part", max_epochs=2, load_weights=True),
                      **kw, weights_path=str(tmp_path / "b"))
    assert resumed.epoch == 1
    assert strip(resumed.fit(index)) == strip(whole)


# ------------------------------------------------------------ several hosts
_WORKER = textwrap.dedent("""
    import os, sys
    import torch
    pid, coord = int(sys.argv[1]), sys.argv[2]
    os.environ["SUBCORT_NUM_PROCESSES"] = "2"  # the environment fallback
    from subcort_tpu_torch.parallel.distributed import (
        all_hosts_mean, host_shard, initialize, process_count,
        process_index)
    initialize(coordinator_address=coord, process_id=pid)
    assert process_count() == 2 and process_index() == pid
    items = [f"scan{i}" for i in range(10)]
    assert host_shard(items) == items[pid::2]
    m = all_hosts_mean(float(10 + pid))
    assert abs(m - 10.5) < 1e-12, m
    initialize(coordinator_address=coord, process_id=pid)  # idempotent
    bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "subcort_tpu")]
    assert not bad, bad
    print("DISTRIBUTED_OK", pid, flush=True)
""")


# exit hooks run last in, first out: the one registered before initialize
# reports after initialize's own hook has run
_LEAVER = textwrap.dedent("""
    import atexit, sys
    import torch.distributed as dist
    atexit.register(lambda: print("GROUP_LEFT", not dist.is_initialized(),
                                  flush=True))
    from subcort_tpu_torch.parallel.distributed import (all_hosts_mean,
                                                        initialize)
    initialize(coordinator_address=sys.argv[2], num_processes=2,
               process_id=int(sys.argv[1]))
    assert all_hosts_mean(1.0) == 1.0
""")


def _two_processes(script: str) -> list:
    """``script`` in two processes (argv: the process id and a coordinator
    address on a port held until both have exited); their outputs, each
    asserted to have exited with 0."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with _reserved_port() as port:
        coord = f"127.0.0.1:{port}"
        procs = [subprocess.Popen([sys.executable, "-c", script, str(i),
                                   coord], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env)
                 for i in range(2)]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=WAIT_S)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-2000:]}"
    return outs


def test_two_process_initialize_shard_and_reduce():
    """tests/test_distributed.py's two processes, on the port's group."""
    for i, out in enumerate(_two_processes(_WORKER)):
        assert f"DISTRIBUTED_OK {i}" in out


def test_initialize_leaves_the_group_at_exit():
    """A process that joined the multi-host group and exits without
    leaving it has left it before the interpreter's teardown (a gloo
    group still up there aborts the process now and then, after its work
    is done)."""
    for out in _two_processes(_LEAVER):
        assert "GROUP_LEFT True" in out, out[-2000:]


def test_initialize_single_process_is_noop(monkeypatch):
    monkeypatch.delenv("SUBCORT_NUM_PROCESSES", raising=False)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.process_count() == 1
    assert distributed.host_shard([1, 2, 3]) == [1, 2, 3]
    assert distributed.all_hosts_mean(2.5) == 2.5


def test_segment_folder_shards_subjects_per_host(tmp_path, monkeypatch):
    """Under a multi-process launch each process segments its strided
    slice of the subject list (the JAX package's
    ``test_segment_folder_shards_subjects_per_host``)."""
    from subcort_tpu_torch.engine import SegmentationEngine
    from subcort_tpu_torch.io import NiftiImage, save_nii

    for i in range(5):
        d = tmp_path / f"s{i:02d}"
        d.mkdir()
        save_nii(NiftiImage(np.ones((4, 4, 4), np.float32)),
                 str(d / "T1.nii.gz"))
    spec = TriPlanarSpec(**NARROW)
    engine = SegmentationEngine(init_params(spec), Options(
        mode="cpu", test_folder=str(tmp_path), debug=False), spec)
    seen = []
    monkeypatch.setattr(engine, "segment_scan",
                        lambda p: seen.append(p) or 0.0)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    assert sorted(engine.segment_folder()) == ["s01", "s03"]
    assert all("T1.nii.gz" in p for p in seen) and len(seen) == 2


def test_cli_initializes_the_group_first(tmp_path, monkeypatch):
    """``cli.main`` joins the process group before any work, as the JAX
    package's CLI does."""
    from subcort_tpu_torch import cli, config

    calls = []
    monkeypatch.setattr(config, "load_options", lambda path: Options(
        mode="cpu", test_folder=str(tmp_path), net_verbose=0))
    monkeypatch.setattr(distributed, "initialize",
                        lambda: calls.append("initialize"))
    monkeypatch.setattr(cli, "_evaluate",
                        lambda options: calls.append("evaluate"))
    assert cli.main(["evaluate", "--config", "unused.cfg"]) == 0
    assert calls == ["initialize", "evaluate"]
