"""Card-only tests of the port: its CUDA gather kernel, the engines, the
train step (at patch 32 and at patch 40, which takes the plain gather), the
on-device registration and connected components on the card against the
CPU, the post-process's component filter kernel against scipy (MNI-sized
noise, a snake past the plain version's sweep cap, ties), the dense scan's
input kernels (``scan_moments``, ``prior_rows``) against their plain
versions at MNI size and ``segment_volume`` through them against the
same call with the plain versions on the CPU, the BN + PReLU kernel
against its plain version in float32 and bfloat16 at every layer both
engines feed it, at odd shapes and values and past 2**31 values, the
dispatch on the card in training and under autograd, and
``segment_volume`` through it against the same call with the plain four
passes, registration levels replayed from a CUDA graph against the plain loop
(also captured on a second thread while the main one segments), the train
multistep and ``Trainer.fit`` replaying one captured step against the
plain loop (float32, bfloat16, patch 40, a learning-rate schedule, a
resume, a NaN), ``exact_float32`` under two threads doing card work, and the
multi-device paths on the one card (the patch engine over two entries of
``cuda:0``; the synced step over one NCCL rank and over two gloo ranks,
whose rank functions come from tests/test_torch_distributed.py; a world-1
NCCL rank's graphed fit against its eager fit, and a rank whose capture
fails, from tests/test_torch_rank_multistep.py), and the
headline benchmark's ``run`` on the card against the CPU (its phantom from
tests/test_torch_bench_scan.py), and FastSurferCNN's multi-view path on the
card against the CPU at a small spec and one full-width batch of 16 slices
against the plain reference (``benchmark/reference/fastsurfer.py``), and
SynthSeg's whole-volume path at a small spec against its plain reference
(``benchmark/reference/synthseg.py``) on the card, with its component step
(the filter kernel) against the plain version, and SwinUNETR at the
published widths on one 128^3 window and its sliding-window path at a cut
width against its plain reference (``benchmark/reference/swinunetr.py``);
each skips without a CUDA device.

This file imports no jax and uses no conftest fixture, so it runs on a
machine that has torch and no jax:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The kernel is held bit-equal (``torch.equal``) to its plain PyTorch version
on the same card tensors: a gather does no arithmetic. The engines run
float32 with TF32 off whatever the caller's global flags say, and so does
the train step.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine import Trainer, TrainingIndex, segment_volume
from subcort_tpu_torch.engine.train import ADAM, train_step
from subcort_tpu_torch.models import TriPlanarNet, TriPlanarSpec, init_params
from subcort_tpu_torch.models import fcn
from subcort_tpu_torch.ops import gather_kernel
from subcort_tpu_torch.ops.gather_kernel import (gather_triplanar_cuda,
                                                 prepare_gather_volume)
from subcort_tpu_torch.ops.patches import (gather_triplanar,
                                           gather_triplanar_subjects,
                                           pad_volume)

# the corners of tests/test_pallas_gather.py plus every corner of the volume;
# padded (66, 65, 67): Y' and Z' are not multiples of 4
SHAPE = (34, 33, 35)
CORNERS = [[0, 0, 0], [33, 32, 34], [0, 32, 17], [33, 0, 0]] + [
    [x, y, z] for x in (0, 33) for y in (0, 32) for z in (0, 34)]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _single(n, device, seed=0, corners=True):
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal(SHAPE).astype(np.float32)
    centers = np.stack([rng.integers(0, s, n) for s in SHAPE], 1)
    if corners:
        centers = np.concatenate([centers, np.asarray(CORNERS)])
    return (pad_volume(torch.from_numpy(vol).to(device)),
            torch.from_numpy(centers.astype(np.int32)).to(device))


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.is_cuda and g.is_contiguous() and g.dtype == torch.float32
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,corners", [(1, False), (3, False), (0, True),
                                       (13, True), (8192, True)])
def test_kernel_matches_plain_single_volume(cuda_device, n, corners):
    """N = 1 and 3 random centers; the 12 border corners alone; 13 random
    plus the corners (25, not a multiple of the ring depth); 8,192 plus the
    corners. One launch per call, counted."""
    padded, centers = _single(n, cuda_device, corners=corners)
    volume = prepare_gather_volume(padded)
    before = gather_kernel.LAUNCHES
    got = gather_triplanar_cuda(volume, centers)
    torch.cuda.synchronize()
    assert gather_kernel.LAUNCHES == before + 1
    _assert_equal(got, gather_triplanar(padded, centers))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 777])
def test_kernel_matches_plain_subjects(cuda_device, n):
    """A 3-subject stack whose padded Y' and Z' (69, 61) are not multiples
    of 4, random rows plus every corner of every subject."""
    rng = np.random.default_rng(1)
    S, shape = 3, (40, 37, 29)
    vols = rng.standard_normal((S,) + tuple(s + 32 for s in shape))
    centers = np.stack([rng.integers(0, S, n)]
                       + [rng.integers(0, s, n) for s in shape], 1)
    corners = [[s, x, y, z] for s in range(S) for x in (0, shape[0] - 1)
               for y in (0, shape[1] - 1) for z in (0, shape[2] - 1)]
    centers = np.concatenate([centers, corners])
    padded = torch.from_numpy(vols.astype(np.float32)).to(cuda_device)
    c = torch.from_numpy(centers.astype(np.int32)).to(cuda_device)
    before = gather_kernel.LAUNCHES
    got = gather_triplanar_cuda(prepare_gather_volume(padded), c)
    torch.cuda.synchronize()
    assert gather_kernel.LAUNCHES == before + 1
    _assert_equal(got, gather_triplanar_subjects(padded, c))


@pytest.mark.cuda
def test_kernel_empty_batch_launches_nothing(cuda_device):
    padded, _ = _single(0, cuda_device)
    before = gather_kernel.LAUNCHES
    got = gather_triplanar_cuda(prepare_gather_volume(padded),
                                torch.zeros((0, 3), dtype=torch.int32,
                                            device=cuda_device))
    assert gather_kernel.LAUNCHES == before
    assert all(g.shape == (0, 32, 32) for g in got)


@pytest.mark.cuda
def test_kernel_refuses_mixed_devices(cuda_device):
    padded, centers = _single(4, cuda_device)
    with pytest.raises(ValueError, match="centers on"):
        gather_triplanar_cuda(prepare_gather_volume(padded), centers.cpu())


@pytest.mark.cuda
def test_kernel_refuses_an_unprepared_volume(cuda_device):
    """On the card the kernel reads prepare_gather_volume's layouts only;
    a padded CUDA tensor raises and launches nothing."""
    padded, centers = _single(4, cuda_device)
    before = gather_kernel.LAUNCHES
    with pytest.raises(ValueError, match="prepare_gather_volume"):
        gather_triplanar_cuda(padded, centers)
    assert gather_kernel.LAUNCHES == before


def _scan(seed=2, n=3000):
    rng = np.random.default_rng(seed)
    image = (rng.random((36, 40, 32)) * 800 + 100).astype(np.int16)
    atlas = rng.random((36, 40, 32, 15)).astype(np.float32)
    atlas /= atlas.sum(-1, keepdims=True)
    centers = np.stack([rng.integers(0, s, n) for s in image.shape], 1)
    return image, atlas, np.unique(centers, axis=0).astype(np.int32)


NARROW = TriPlanarSpec(conv_filters=(8, 8, 8, 8, 8), fc_conv=16, fc_fc=16,
                       fc2=16)


@pytest.mark.cuda
def test_segment_volume_card_matches_cpu(cuda_device):
    """A small phantom through the patch engine on the card and on the CPU
    (narrow net): labels equal, float32 probs within 1e-5."""
    image, atlas, centers = _scan()
    params = init_params(NARROW, torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", cuda_device):
        net = TriPlanarNet.from_params(params, NARROW, dev)
        out[str(dev)] = segment_volume(net, image, atlas, centers,
                                       want_probs=True, chunk=1000,
                                       engine="patch", probs_dtype=np.float32)
    (cpu_l, cpu_p), (gpu_l, gpu_p) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(gpu_p, cpu_p, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gpu_l, cpu_l)


@pytest.mark.cuda
def test_patch_engine_over_two_entries_of_one_card(cuda_device):
    """The patch engine over ``[cuda:0, cuda:0]`` (two host threads, one
    card): labels and float32 probs equal to one device, and one kernel
    launch per chunk of each part."""
    from subcort_tpu_torch.parallel.mesh import shard_rows

    image, atlas, centers = _scan()
    params = init_params(NARROW, torch.Generator().manual_seed(0))
    net = TriPlanarNet.from_params(params, NARROW, cuda_device)
    kw = dict(want_probs=True, chunk=256, engine="patch",
              probs_dtype=np.float32)
    one_l, one_p = segment_volume(net, image, atlas, centers, **kw)
    before = gather_kernel.LAUNCHES
    two_l, two_p = segment_volume(net, image, atlas, centers,
                                  devices=[cuda_device] * 2, **kw)
    parts = shard_rows(len(centers), 2, align=256)
    assert gather_kernel.LAUNCHES - before == sum(
        -(-(p.stop - p.start) // 256) for p in parts) > 1
    np.testing.assert_array_equal(two_l, one_l)
    np.testing.assert_array_equal(two_p, one_p)


@pytest.mark.cuda
def test_synced_step_over_nccl_world_one_equals_the_plain_step(
        cuda_device, tmp_path, monkeypatch):
    """One NCCL rank: the step (gradients all-reduced over NCCL, BN plain
    at world 1) bit-equal to the plain step, both under cuDNN's
    deterministic algorithms (the launcher hands the rank the caller's
    flags); the synced BN Function alone, its two-pass statistics against
    the native kernel's, within 1e-6."""
    from subcort_tpu_torch.parallel import distributed
    from test_torch_distributed import B, _nccl_rank, _one_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    assert distributed.launch(_nccl_rank, [cuda_device], (str(tmp_path),),
                              timeout=150) == "nccl"
    got = torch.load(tmp_path / "step0.pt")
    loss, grads, state = _one_step(slice(0, B), cuda_device, 1)
    assert got["loss"] == loss
    assert all(torch.equal(got["grads"][k], g) for k, g in grads.items())
    assert all(torch.equal(got["state"][k], v) for k, v in state.items())
    bn = torch.load(tmp_path / "bn_world1.pt")
    for s, n in zip(bn["synced"], bn["native"]):
        torch.testing.assert_close(s, n, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_train_step_over_two_ranks_on_one_card(cuda_device, tmp_path,
                                               monkeypatch):
    """Two gloo ranks on ``cuda:0`` against the one-process card step on
    the global batch of 2B rows (augmentation and dropout on): loss,
    gradients and BN EMA within 1e-5."""
    from subcort_tpu_torch.parallel import distributed
    from test_torch_distributed import B, _one_step, _step_rank, check_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    assert distributed.launch(_step_rank, [cuda_device] * 2,
                              (str(tmp_path),), timeout=150) == "gloo"
    check_step(tmp_path, _one_step(slice(0, 2 * B), cuda_device, 2),
               atol=1e-5)


@pytest.mark.cuda
def test_fcn_card_matches_cpu(cuda_device):
    """The dense evaluator on one small slab (a compact 12x14x10 candidate
    block of the phantom, full-width net) on the card and on the CPU:
    labels equal, float32 probs within 1e-5."""
    image, atlas, _ = _scan()
    centers = np.stack(np.meshgrid(np.arange(12, 24), np.arange(14, 28),
                                   np.arange(10, 20), indexing="ij"),
                       -1).reshape(-1, 3).astype(np.int32)
    params = init_params(TriPlanarSpec(), torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", cuda_device):
        net = TriPlanarNet.from_params(params, TriPlanarSpec(), dev)
        before = fcn.SLABS
        out[str(dev)] = segment_volume(net, image, atlas, centers,
                                       want_probs=True, engine="fcn",
                                       prior_dtype=np.float32,
                                       probs_dtype=np.float32)
        assert fcn.SLABS == before + 1
    (cpu_l, cpu_p), (gpu_l, gpu_p) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(gpu_p, cpu_p, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gpu_l, cpu_l)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["patch", "fcn"])
def test_segment_volume_ignores_global_tf32(cuda_device, engine):
    """With TF32 allowed globally (PyTorch's default for cuDNN), the
    probabilities still equal a TF32-off run bit for bit, and the caller's
    flags are as they were afterwards."""
    image, atlas, centers = _scan(n=1500)
    params = init_params(TriPlanarSpec(), torch.Generator().manual_seed(0))
    net = TriPlanarNet.from_params(params, TriPlanarSpec(), cuda_device)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    probs = {}
    try:
        for tf32 in (False, True):
            cudnn.allow_tf32 = matmul.allow_tf32 = tf32
            _, probs[tf32] = segment_volume(net, image, atlas, centers,
                                            want_probs=True, engine=engine,
                                            prior_dtype=np.float32,
                                            probs_dtype=np.float32)
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (tf32, tf32)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    np.testing.assert_array_equal(probs[True], probs[False])


NARROW_NO_DROPOUT = dataclasses.replace(NARROW, dropout_conv=0.0,
                                        dropout_fc=0.0)


def _train_batch(seed=3, b=64, subjects=2, extent=(20, 22, 18)):
    rng = np.random.default_rng(seed)
    vols = rng.standard_normal(
        (subjects,) + tuple(e + 32 for e in extent)).astype(np.float32)
    centers = np.stack([rng.integers(0, subjects, b)]
                       + [rng.integers(0, e, b) for e in extent],
                       1).astype(np.int32)
    labels = rng.integers(0, 15, b)
    atlas = rng.random((b, 15)).astype(np.float32)
    return vols, centers, labels, atlas


def _step(params, device, vols, centers, labels, atlas, plain=False,
          spec=NARROW_NO_DROPOUT, dtype=None):
    """One train step on ``device`` from ``params``: the kernel's gather on
    the card (the plain version at a patch size other than 32), or with
    ``plain`` the plain gather of the padded stack."""
    net = TriPlanarNet.from_params(params, spec, device, trainable=True)
    optimizer = torch.optim.Adam(net.parameters(), **ADAM)
    c = torch.from_numpy(centers).to(device)
    padded = torch.from_numpy(vols).to(device)
    if plain:
        views = gather_triplanar_subjects(padded, c, spec.patch_size)
    else:
        views = gather_triplanar_cuda(prepare_gather_volume(padded), c,
                                      spec.patch_size)
    loss = train_step(net, optimizer, views,
                      torch.from_numpy(labels).to(device),
                      torch.from_numpy(atlas).to(device), compute_dtype=dtype)
    grads = {k: p.grad.cpu() for k, p in net.named_parameters()}
    return loss.cpu(), grads, {k: v.cpu() for k, v in net.state_dict().items()}


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda_device):
    """One float32 step (narrow net, dropout 0) on the card and on the CPU:
    loss within 1e-5, gradients within rtol 1e-4 / atol 1e-6, the BN EMA
    within 1e-6, and the parameters after Adam within 1e-6 where the
    gradient exceeds 1e-5 (elsewhere Adam's first move, about lr * sign(g),
    may flip with a near-zero gradient: within 2 lr)."""
    batch = _train_batch()
    params = init_params(NARROW_NO_DROPOUT, torch.Generator().manual_seed(0))
    before = gather_kernel.LAUNCHES
    card = _step(params, cuda_device, *batch)
    assert gather_kernel.LAUNCHES == before + 1
    cpu = _step(params, torch.device("cpu"), *batch)
    np.testing.assert_allclose(float(card[0]), float(cpu[0]), rtol=1e-5)
    for k, g in cpu[1].items():
        np.testing.assert_allclose(card[1][k].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        diff = (card[2][k] - cpu[2][k]).abs()
        assert (diff[g.abs() > 1e-5] <= 1e-6).all(), k
        assert (diff <= 2 * ADAM["lr"]).all(), k
    for k, v in cpu[2].items():
        if k.endswith((".mean", ".inv_std")):
            np.testing.assert_allclose(card[2][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.cuda
def test_bfloat16_train_step_card_matches_cpu(cuda_device):
    """One bfloat16 step (narrow net, dropout 0) on the card and on the CPU,
    whose step tests/test_torch_train.py holds to the JAX package's: the
    mean |BN EMA difference| within a quarter of the CPU's own bfloat16 vs
    float32 one, so a card step that ran in float32 fails, and the loss
    within 1e-3 relative, a quarter of bfloat16's 2^-8 step. (The loss
    alone cannot tell the dtypes apart: on this batch the CPU's bfloat16
    and float32 losses differ by 1.75e-5 relative.)"""
    batch = _train_batch(seed=7)
    params = init_params(NARROW_NO_DROPOUT, torch.Generator().manual_seed(3))
    cpu = torch.device("cpu")
    card16 = _step(params, cuda_device, *batch, dtype=torch.bfloat16)
    cpu16 = _step(params, cpu, *batch, dtype=torch.bfloat16)
    cpu32 = _step(params, cpu, *batch)

    def differ(a, b):
        ema = torch.cat([(a[2][k] - b[2][k]).abs() for k in b[2]
                         if k.endswith((".mean", ".inv_std"))])
        return abs(float(a[0]) - float(b[0])) / float(b[0]), float(ema.mean())

    got, gap = differ(card16, cpu16), differ(cpu16, cpu32)
    assert gap[0] > 0 and gap[1] > 0
    assert got[0] <= 1e-3, (got, gap)
    assert got[1] <= 0.25 * gap[1], (got, gap)


@pytest.mark.cuda
def test_train_step_kernel_gather_equals_plain_gather(cuda_device):
    """The same step with the kernel's gather and with the plain gather on
    the card: the patches are bit-equal, so the loss is too."""
    batch = _train_batch(seed=4)
    params = init_params(NARROW_NO_DROPOUT, torch.Generator().manual_seed(1))
    kernel = _step(params, cuda_device, *batch)
    plain = _step(params, cuda_device, *batch, plain=True)
    assert torch.equal(kernel[0], plain[0])


@pytest.mark.cuda
def test_trainer_fit_launches_the_kernel_every_step(cuda_device, tmp_path):
    """Trainer.fit on the card (the default mode): the gather kernel runs at
    least once per train step and once per eval batch."""
    vols, centers, labels, atlas = _train_batch(seed=5, b=200)
    index = TrainingIndex(vols, centers, labels.astype(np.int32), atlas,
                          ["a", "b"])
    options = Options(experiment="card", batch_size=32, max_epochs=2,
                      patience=5, train_split=0.25, net_verbose=0,
                      load_weights=False, seed=2)
    trainer = Trainer(options, spec=NARROW, weights_path=str(tmp_path))
    assert next(trainer.net.parameters()).device == cuda_device
    before = gather_kernel.LAUNCHES
    history = trainer.fit(index)
    n_valid = sum(-(-int(np.sum(labels == c)) // 4)
                  for c in np.unique(labels))
    steps = (len(labels) - n_valid) // 32
    assert gather_kernel.LAUNCHES - before >= 2 * (steps + 1)
    assert all(np.isfinite(h["train_loss"]) for h in history)


@pytest.mark.cuda
def test_train_step_ignores_global_tf32(cuda_device):
    """With TF32 allowed globally, a train step's loss equals a TF32-off
    step's bit for bit, and the caller's flags are as they were after."""
    batch = _train_batch(seed=6)
    spec = TriPlanarSpec(dropout_conv=0.0, dropout_fc=0.0)
    params = init_params(spec, torch.Generator().manual_seed(2))
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    losses = {}
    try:
        for tf32 in (False, True):
            cudnn.allow_tf32 = matmul.allow_tf32 = tf32
            losses[tf32] = _step(params, cuda_device, *batch,
                                 spec=spec)[0]
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (tf32, tf32)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    assert torch.equal(losses[True], losses[False])


@pytest.mark.cuda
def test_patch40_train_step_card_matches_cpu(cuda_device):
    """A train step at patch 40 on the card, centers at 0 and at the last
    index on every axis among them (windows that start at padded -4 and end
    past the padding): the gather takes the plain version on the card,
    launching no kernel, and the step equals the CPU's within 1e-5."""
    spec = dataclasses.replace(NARROW_NO_DROPOUT, patch_size=40)
    extent = (20, 22, 18)
    vols, centers, labels, atlas = _train_batch(seed=8, extent=extent)
    centers[:8, 1:] = [[x, y, z] for x in (0, extent[0] - 1)
                       for y in (0, extent[1] - 1) for z in (0, extent[2] - 1)]
    params = init_params(spec, torch.Generator().manual_seed(4))
    before = gather_kernel.LAUNCHES
    card = _step(params, cuda_device, vols, centers, labels, atlas, spec=spec)
    assert gather_kernel.LAUNCHES == before
    cpu = _step(params, torch.device("cpu"), vols, centers, labels, atlas,
                spec=spec)
    assert np.isfinite(float(card[0]))
    np.testing.assert_allclose(float(card[0]), float(cpu[0]), rtol=1e-5)
    for k, v in cpu[2].items():
        if k.endswith((".mean", ".inv_std")):
            np.testing.assert_allclose(card[2][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.cuda
def test_exact_float32_two_threads_doing_card_work(cuda_device):
    """Thread a enters exact_float32, then thread b; a leaves first, and
    b then runs a float32 convolution and matmul on the card. Both threads'
    results equal the TF32-off results bit for bit (a save-and-restore per
    thread would have turned TF32 back on under b), and the caller's flags,
    TF32 on, come back once both have left."""
    import threading

    from subcort_tpu_torch.config import exact_float32

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(8, 64, 48, 48, generator=g, device=cuda_device)
    w = torch.randn(64, 64, 3, 3, generator=g, device=cuda_device)
    m = torch.randn(512, 512, generator=g, device=cuda_device)

    def work():
        out = (torch.nn.functional.conv2d(x, w, padding=1), m @ m)
        torch.cuda.synchronize()
        return out

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = False
        exact = work()
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        tf32 = work()
        assert not any(torch.equal(a, b) for a, b in zip(exact, tf32)), \
            "TF32 changes both results on this card"
        a_in, b_in, a_out = (threading.Event() for _ in range(3))
        results = {}

        def thread_a():
            with exact_float32():
                a_in.set()
                assert b_in.wait(10)
                results["a"] = work()
            a_out.set()

        def thread_b():
            assert a_in.wait(10)
            with exact_float32():
                b_in.set()
                assert a_out.wait(10)
                results["b"] = work()
                results["b flags"] = (cudnn.allow_tf32, matmul.allow_tf32)

        threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert results["b flags"] == (False, False)
        for name in ("a", "b"):
            for got, want in zip(results[name], exact):
                assert torch.equal(got, want), name
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("seed,p", [(0, 0.12), (1, 0.3), (2, 0.5)])
def test_device_cc_card_matches_scipy(cuda_device, seed, p):
    """Connected components by min-label propagation on the card equal
    scipy's labeling (the same numbering), below, at and above the
    percolation threshold; the post-process keeps the same voxels with
    either backend."""
    import warnings

    from subcort_tpu_torch.engine.postprocess import \
        post_process_segmentation
    from subcort_tpu_torch.ops.connected import (label_components_device,
                                                 label_components_np)

    rng = np.random.default_rng(seed)
    mask = rng.random((40, 44, 36)) < p
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fallback to scipy
        got, n = label_components_device(mask, device=cuda_device)
    want, n_np = label_components_np(mask)
    assert n == n_np > 0
    np.testing.assert_array_equal(got, want)
    labels = (rng.integers(1, 6, mask.shape) * mask).astype(np.uint8)
    atlas_mask = np.zeros(mask.shape, bool)
    atlas_mask[10:30, 12:32, 8:28] = True
    np.testing.assert_array_equal(
        post_process_segmentation("", labels, atlas_mask=atlas_mask,
                                  cc_backend="device", device=cuda_device),
        post_process_segmentation("", labels, atlas_mask=atlas_mask,
                                  cc_backend="scipy"))


def _mni_noise(seed):
    """MNI-sized noisy labels: a uniform class 0..14 on each candidate of
    make_scan's ROI dilated 10 times (the benchmark's scan_dense labels
    are as noisy), and the ROI as the atlas mask."""
    from scipy import ndimage

    from subcort_tpu_torch.bench.scan import make_scan

    rng = np.random.default_rng(seed)
    _, _, roi = make_scan(rng)
    cand = ndimage.binary_dilation(roi, iterations=10)
    labels = np.zeros(roi.shape, np.uint8)
    labels[cand] = rng.integers(0, 15, int(cand.sum()))
    return labels, roi


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_kernel_matches_scipy_on_mni_noise(cuda_device, seed):
    """The component filter's kernel equals the scipy filter bit for bit
    on MNI-sized noise, through the post-process (``"auto"``, the default,
    on the card) and on the foreground crop against its plain version on
    the card; each call that reaches the kernel counts one launch."""
    from subcort_tpu_torch.engine import postprocess
    from subcort_tpu_torch.ops import connected

    labels, roi = _mni_noise(seed)
    want = postprocess.post_process_segmentation(
        "", labels, atlas_mask=roi, cc_backend="scipy")
    before = connected.FILTER_LAUNCHES
    got = postprocess.post_process_segmentation("", labels, atlas_mask=roi,
                                                device=cuda_device)
    torch.cuda.synchronize()
    assert connected.FILTER_LAUNCHES == before + 1
    np.testing.assert_array_equal(got, want)
    got = postprocess.post_process_segmentation("", labels, atlas_mask=roi)
    torch.cuda.synchronize()
    assert connected.FILTER_LAUNCHES == before + 2
    np.testing.assert_array_equal(got, want)
    box = postprocess._foreground_box(labels)
    crop = torch.from_numpy(np.ascontiguousarray(labels[box])).to(cuda_device)
    crop_atlas = torch.from_numpy(np.ascontiguousarray(roi[box])).to(
        cuda_device)
    kernel = connected.filter_components(crop, crop_atlas, 15)
    torch.cuda.synchronize()
    assert connected.FILTER_LAUNCHES == before + 3
    assert kernel.is_cuda and kernel.dtype == torch.uint8
    assert torch.equal(kernel, connected.filter_components_plain(
        crop, crop_atlas, 15))
    np.testing.assert_array_equal(kernel.cpu().numpy(), want[box])


def _mni_scan_inputs(seed):
    """make_scan's int16 T1, priors and the candidates of its ROI dilated
    10 times (scan_dense's shapes: 204,403 candidates, bbox 80x96x80)."""
    from scipy import ndimage

    from subcort_tpu_torch.bench.scan import make_scan

    image, atlas, roi = make_scan(np.random.default_rng(seed))
    centers = np.stack(np.nonzero(ndimage.binary_dilation(
        roi, iterations=10)), 1).astype(np.int32)
    return image, atlas, centers


@pytest.mark.cuda
@pytest.mark.parametrize("voxels", [np.int16, np.uint16])
def test_scan_input_kernels_match_plain_at_mni_size(cuda_device, voxels):
    """``scan_moments`` and ``prior_rows`` on the card against their plain
    versions on the same card tensors, bit for bit, at MNI size: the
    moments of an int16 and a uint16 scan (scrambled and duplicated
    centers), the prior rows of the candidates' bbox in every wire type,
    sparse (the candidates, scrambled, with repeats) and dense (every
    block voxel). Each call counts one launch."""
    from subcort_tpu_torch.engine.infer import _bbox_of
    from subcort_tpu_torch.ops import scan_inputs

    image, atlas, centers = _mni_scan_inputs(0)
    rng = np.random.default_rng(1)
    centers = centers[rng.permutation(len(centers))]
    centers = np.concatenate([centers, centers[:999]])
    # a few rows that sum to zero with mixed signs, and one that numpy's
    # order sums to 1 where a plain left-to-right sum gives 0
    atlas = atlas.copy()
    for i, row in enumerate(([0.5, -0.25, -0.25], [1e8, 0, 0, 0, -1e8],
                             [1, 0, 1e8, -1e8])):
        c = centers[i]
        atlas[c[0], c[1], c[2]] = 0
        atlas[c[0], c[1], c[2], :len(row)] = row
    volume = torch.from_numpy(image.astype(voxels)).to(cuda_device)
    cen = torch.from_numpy(centers).to(cuda_device)
    before = scan_inputs.LAUNCHES
    got = scan_inputs.scan_moments(volume, cen)
    want = scan_inputs.scan_moments_plain(volume, cen)
    assert scan_inputs.LAUNCHES == before + 1
    assert torch.equal(got, want)
    lo, dims = _bbox_of(centers, image.shape)
    block = torch.from_numpy(np.ascontiguousarray(
        atlas[lo[0]:lo[0] + dims[0], lo[1]:lo[1] + dims[1],
              lo[2]:lo[2] + dims[2]])).to(cuda_device)
    for prior_dtype in scan_inputs.ROW_TYPES:
        for sel in (cen, None):
            rows, lin = scan_inputs.prior_rows(block, sel, lo, prior_dtype)
            want_rows, want_lin = scan_inputs.prior_rows_plain(
                block, sel, lo, prior_dtype)
            assert rows.dtype == want_rows.dtype
            assert torch.equal(rows, want_rows), (prior_dtype, sel is None)
            assert (lin is None) == (sel is None)
            if lin is not None:
                assert torch.equal(lin, want_lin)
    torch.cuda.synchronize()
    assert scan_inputs.LAUNCHES == before + 1 + 2 * len(
        scan_inputs.ROW_TYPES)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["int16", "uint16", "split", "float32_wire",
                                  "float32_scan", "two_entries"])
def test_segment_volume_card_inputs_equal_the_host_path(cuda_device,
                                                        monkeypatch, case):
    """An MNI-sized scan through ``segment_volume``'s one path on the card:
    the inputs derived there by the kernels (two launches a call with one
    sub-bbox, one more for each further sub-bbox; a float32 scan takes its
    statistics and bbox from the host) give the labels and probabilities
    of the same call with the plain versions run on the CPU, bit for bit.
    The forward stays on the card, whose convolutions round otherwise
    than the CPU's. split: sub-bboxes of at most 200,000 voxels, each
    selecting its candidates on the card; two_entries: ``[cuda:0,
    cuda:0]``, one sub-slab each."""
    from subcort_tpu_torch.engine import infer
    from subcort_tpu_torch.ops import scan_inputs

    image, atlas, centers = _mni_scan_inputs(2)
    if case == "uint16":
        image = image.astype(np.uint16)
    elif case == "float32_scan":
        image = image.astype(np.float32)
    spec = TriPlanarSpec(conv_filters=(8, 8, 8, 8, 8), fc_conv=16,
                         fc_fc=16, fc2=16)
    net = TriPlanarNet.from_params(
        init_params(spec, torch.Generator().manual_seed(4)), spec,
        cuda_device)
    kw = dict(want_probs=True, engine="fcn")
    if case == "split":
        kw["fcn_max_bbox_voxels"] = 200_000
    elif case == "float32_wire":
        kw.update(prior_dtype=np.float32, probs_dtype=np.float32)
    elif case == "two_entries":
        kw["devices"] = [cuda_device, cuda_device]
    lo, dims = infer._bbox_of(centers, image.shape)
    slabs = len(infer._dense_jobs(lo, dims, len(kw.get("devices", [0])),
                                  kw.get("fcn_max_bbox_voxels", 6_000_000),
                                  True))
    before = scan_inputs.LAUNCHES
    got = segment_volume(net, image, atlas, centers, **kw)
    torch.cuda.synchronize()
    assert scan_inputs.LAUNCHES == before + (case != "float32_scan") + slabs

    def on_the_cpu(plain):
        def run(*args):
            out = plain(*(a.cpu() if isinstance(a, torch.Tensor) else a
                          for a in args))
            dev = args[0].device
            return (out.to(dev) if isinstance(out, torch.Tensor) else
                    tuple(None if t is None else t.to(dev) for t in out))
        return run

    monkeypatch.setattr(scan_inputs, "scan_moments",
                        on_the_cpu(scan_inputs.scan_moments_plain))
    monkeypatch.setattr(scan_inputs, "prior_rows",
                        on_the_cpu(scan_inputs.prior_rows_plain))
    want = segment_volume(net, image, atlas, centers, **kw)
    assert scan_inputs.LAUNCHES == before + (case != "float32_scan") + slabs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# the patch engine's BN + PReLU inputs: a chunk of 8,192 and scan_dense's
# short last chunk (204,403 = 24 x 8,192 + 7,795), at each conv's output
PATCH_LAYERS = [(n, c, s, s) for n in (8192, 7795)
                for c, s in ((20, 30), (20, 28), (40, 12), (40, 10), (60, 3))]
# odd planes, channel counts no multiple of 4, one value, none, a wide
# layer whose tables take more than the default 48 KiB of shared memory
ODD_LAYERS = [(3, 7, 5, 3), (2, 5, 1, 1), (1, 1, 1, 1), (0, 20, 30, 30),
              (2, 4000, 1, 3)]
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 1e-40,
            -1e-40, 1e-45, 3e-39]
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _bn_layer(c, device, seed, dtype=torch.float32):
    """A BN module of ``c`` channels in eval mode with random tables and
    PReLU alphas of both signs, in ``dtype``; channel 0 scales by about
    1e-38, so that its outputs are denormal."""
    from subcort_tpu_torch.models.triplanar import _BatchNorm

    g = torch.Generator().manual_seed(seed)
    bn = _BatchNorm(c, 1e-4)
    with torch.no_grad():
        bn.mean.copy_(torch.randn(c, generator=g))
        bn.inv_std.copy_(torch.rand(c, generator=g) * 3 + 0.1)
        bn.gamma.copy_(torch.randn(c, generator=g))
        bn.beta.copy_(torch.randn(c, generator=g))
        bn.mean[0], bn.inv_std[0], bn.gamma[0], bn.beta[0] = 0, 1e-8, 1e-30, 0
    alpha = torch.randn(c, generator=g)
    return (bn.eval().requires_grad_(False).to(device, dtype),
            alpha.to(device, dtype))


def _layer_input(shape, device, seed, offset=0, dtype=torch.float32):
    """A normal (N, C, H, W) input in ``dtype`` with NaN, infinities, -0.0
    and denormals at its first and at random places; ``offset`` values
    into its storage, so that 1 to 3 shift it off the alignment of four
    values."""
    n = int(np.prod(shape))
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(n + offset, device=device).normal_(generator=g)
    flat = flat.to(dtype)[offset:]
    if n:
        special = torch.tensor(SPECIALS, device=device, dtype=dtype)
        places = torch.randint(0, n, (1024,), device=device, generator=g)
        flat[places] = special[torch.arange(1024, device=device)
                               % len(SPECIALS)]
        flat[:min(n, len(SPECIALS))] = special[:n]
    return flat.view(shape)


def _same_bits(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(BITS[a.dtype]), b.view(BITS[b.dtype])))


def _kernel_of(x, bn, alpha):
    from subcort_tpu_torch.ops import bn_prelu

    return bn_prelu.bn_prelu(x, bn.mean, bn.inv_std, bn.gamma, bn.beta,
                             alpha)


def _check_bn_prelu(shape, device, seed, offset=0, dtype=torch.float32):
    from subcort_tpu_torch.ops import bn_prelu

    bn, alpha = _bn_layer(shape[1], device, seed, dtype)
    x = _layer_input(shape, device, seed, offset, dtype)
    before = bn_prelu.LAUNCHES
    got = _kernel_of(x, bn, alpha)
    assert bn_prelu.LAUNCHES == before + (1 if x.numel() else 0)
    assert _same_bits(got, F.prelu(bn(x), alpha)), (shape, offset, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PATCH_LAYERS + ODD_LAYERS)
def test_bn_prelu_kernel_equals_plain(cuda_device, shape):
    """The BN + PReLU kernel against its plain version (the BN module's
    three ATen ops and ``F.prelu``) on the same card tensors, bit for bit,
    at every layer a patch chunk and scan_dense's short last chunk feed
    it, and at odd planes, channel counts no multiple of 4, one value,
    none, and tables past 48 KiB of shared memory: NaN, infinities, -0.0,
    denormal inputs and outputs, negative alphas."""
    _check_bn_prelu(shape, cuda_device, seed=sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PATCH_LAYERS[:5] + ODD_LAYERS)
def test_bn_prelu_kernel_bfloat16_equals_plain(cuda_device, shape):
    """The kernel on a bfloat16 net's layers (``compute_dtype =
    bfloat16``) against the plain ops, which round each result to
    bfloat16: bit for bit, at a patch chunk's layers and the odd shapes,
    special values included."""
    _check_bn_prelu(shape, cuda_device, seed=sum(shape),
                    dtype=torch.bfloat16)


@pytest.mark.cuda
def test_bn_prelu_kernel_off_alignment(cuda_device):
    """Inputs that start 1, 2 and 3 values off the alignment of four
    values take the one-value path, bit for bit, in float32 and
    bfloat16."""
    for dtype in (torch.float32, torch.bfloat16):
        for offset in (1, 2, 3):
            _check_bn_prelu((4, 7, 12, 12), cuda_device, seed=offset,
                            offset=offset, dtype=dtype)


@pytest.mark.cuda
def test_bn_prelu_kernel_past_2_31_values(cuda_device):
    """A patch chunk of 119,306 rows at conv1 (2,147,508,000 values, past
    the 2**31 a launch takes): two launches split between samples, bit for
    bit the plain ops at both ends and across the split."""
    from subcort_tpu_torch.ops import bn_prelu

    shape = (119306, 20, 30, 30)
    per = (bn_prelu.MAX_ELEMENTS - 1) // (20 * 30 * 30)
    bn, alpha = _bn_layer(20, cuda_device, seed=9)
    x = torch.empty(shape, device=cuda_device).normal_(
        generator=torch.Generator(device=cuda_device).manual_seed(9))
    before = bn_prelu.LAUNCHES
    got = _kernel_of(x, bn, alpha)
    assert bn_prelu.LAUNCHES == before + 2
    for lo, hi in ((0, 3), (per - 3, per + 2), (shape[0] - 3, shape[0])):
        assert _same_bits(got[lo:hi], F.prelu(bn(x[lo:hi]), alpha)), lo
    del x, got
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_bn_prelu_card_training_and_autograd_take_the_plain_path(
        cuda_device):
    """On the card a trainable net's branch launches the kernel at each
    layer in eval mode without grad, and not in training mode or where
    autograd records the call; every output equals the module's BN and
    ``F.prelu``."""
    from subcort_tpu_torch.ops import bn_prelu

    net = TriPlanarNet.from_params(
        init_params(NARROW, torch.Generator().manual_seed(8)), NARROW,
        cuda_device, trainable=True)
    branch = net.axial
    x = torch.randn(5, NARROW.conv_filters[0], 9, 9, device=cuda_device)
    for training, grad, launches in ((False, False, 1), (False, True, 0),
                                     (True, False, 0), (True, True, 0)):
        branch.train(training)
        with torch.set_grad_enabled(grad):
            before = bn_prelu.LAUNCHES
            got = branch.bn_prelu(1, x)
            assert bn_prelu.LAUNCHES == before + launches
            want = F.prelu(branch.bn1(x), branch.prelu1)
            assert _same_bits(got.detach(), want.detach())


@pytest.mark.cuda
def test_bn_prelu_kernel_at_a_dense_slab(cuda_device, monkeypatch):
    """Every layer of a dense slab at scan_dense's bbox (80 x 96 x 80, the
    full-width net): the 15 shapes the slab feeds the kernel, each taken
    once (15 launches a slab), and the kernel at each of them against the
    plain version, bit for bit."""
    from subcort_tpu_torch.models.triplanar import DEFAULT_SPEC
    from subcort_tpu_torch.ops import bn_prelu

    net = TriPlanarNet.from_params(
        init_params(DEFAULT_SPEC, torch.Generator().manual_seed(6)),
        DEFAULT_SPEC, cuda_device)
    shapes, real = [], bn_prelu.bn_prelu
    monkeypatch.setattr(bn_prelu, "bn_prelu", lambda x, *tables: (
        shapes.append(tuple(x.shape)) or real(x, *tables)))
    dims = (80, 96, 80)
    slab = torch.randn([d + fcn.RF for d in dims], device=cuda_device)
    vecs = torch.rand(int(np.prod(dims)), 15, device=cuda_device)
    before = bn_prelu.LAUNCHES
    fcn.fcn_forward_slab(net, slab, vecs)
    assert bn_prelu.LAUNCHES == before + 15
    assert len(shapes) == 15 and (96, 40, 102, 102) in shapes
    monkeypatch.undo()
    for k, shape in enumerate(shapes):
        _check_bn_prelu(shape, cuda_device, seed=k)


def _segment_volume_against_plain(device, monkeypatch, engine, dtype):
    """``segment_volume`` on an MNI-sized scan (204,403 candidates) with the
    full-width net in ``dtype`` through the kernel, then with every
    branch's BN + PReLU the plain ops: labels and float32 probabilities
    equal, 15 launches a patch chunk (25 chunks) or a dense slab, none on
    the plain call."""
    from subcort_tpu_torch.engine import infer
    from subcort_tpu_torch.models.triplanar import DEFAULT_SPEC, _Branch
    from subcort_tpu_torch.ops import bn_prelu

    image, atlas, centers = _mni_scan_inputs(3)
    net = TriPlanarNet.from_params(
        init_params(DEFAULT_SPEC, torch.Generator().manual_seed(7)),
        DEFAULT_SPEC, device)
    kw = dict(want_probs=True, engine=engine, probs_dtype=np.float32,
              compute_dtype=dtype)
    if engine == "patch":
        kw["chunk"] = 8192
        units = -(-len(centers) // 8192)
    else:
        lo, dims = infer._bbox_of(centers, image.shape)
        units = len(infer._dense_jobs(lo, dims, 1, 6_000_000, True))
    before = bn_prelu.LAUNCHES
    got = segment_volume(net, image, atlas, centers, **kw)
    torch.cuda.synchronize()
    assert bn_prelu.LAUNCHES == before + 15 * units
    monkeypatch.setattr(_Branch, "bn_prelu", lambda self, i, x: F.prelu(
        getattr(self, f"bn{i}")(x), getattr(self, f"prelu{i}")))
    want = segment_volume(net, image, atlas, centers, **kw)
    assert bn_prelu.LAUNCHES == before + 15 * units
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["patch", "fcn"])
def test_segment_volume_bn_prelu_equals_plain(cuda_device, monkeypatch,
                                              engine):
    """An MNI-sized scan through the full-width float32 net on the card:
    the kernel's path equals the plain four passes' (see
    ``_segment_volume_against_plain``)."""
    _segment_volume_against_plain(cuda_device, monkeypatch, engine,
                                  "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["patch", "fcn"])
def test_segment_volume_bn_prelu_bfloat16_equals_plain(cuda_device,
                                                       monkeypatch, engine):
    """The same at ``compute_dtype = bfloat16``: the kernel's path equals
    the plain ops', each rounded to bfloat16."""
    _segment_volume_against_plain(cuda_device, monkeypatch, engine,
                                  "bfloat16")


@pytest.mark.cuda
def test_filter_kernel_serpentine_beyond_the_sweep_cap(cuda_device):
    """A snake of about 4,200 voxels, longer than the plain version's
    2,048-sweep cap (which warns and falls back to scipy), touching the
    atlas at its far end only, against a straight bar with more voxels
    and no atlas voxel: the kernel keeps the snake, as scipy does."""
    import warnings

    from subcort_tpu_torch.engine import postprocess
    from subcort_tpu_torch.ops import connected

    shape = (4, 64, 130)
    labels = np.zeros(shape, np.uint8)
    snake = np.zeros(shape[1:], bool)
    for row in range(0, shape[1], 2):
        snake[row, :] = True
        if row + 1 < shape[1]:
            snake[row + 1, -1 if (row // 2) % 2 == 0 else 0] = True
    labels[1][snake] = 2
    labels[3, 1:60, 1:80] = 2
    labels[3, 1:60, 90:] = 5
    atlas = np.zeros(shape, bool)
    atlas[1, -1, :3] = True
    atlas[3, 30:, 100:] = True
    want = postprocess.post_process_segmentation(
        "", labels, atlas_mask=atlas, cc_backend="scipy")
    np.testing.assert_array_equal(want[1] == 2, snake)
    before = connected.FILTER_LAUNCHES
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = postprocess.post_process_segmentation(
            "", labels, atlas_mask=atlas, cc_backend="device",
            device=cuda_device)
    torch.cuda.synchronize()
    assert connected.FILTER_LAUNCHES == before + 1
    np.testing.assert_array_equal(got, want)
    with pytest.warns(UserWarning, match="sweep cap"):
        plain = connected.filter_components_plain(
            torch.from_numpy(labels).to(cuda_device),
            torch.from_numpy(atlas).to(cuda_device), 15)
    np.testing.assert_array_equal(plain.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "beyond_classes", "one_voxel",
                                  "empty", "int16_uint8_atlas",
                                  "two_classes"])
def test_filter_kernel_edge_cases(cuda_device, case):
    """Ties of overlap and of size (the first in raster order wins),
    labels that are no class, a single voxel, no foreground, int16 labels
    with a uint8 atlas and two classes: the card equals scipy."""
    from subcort_tpu_torch.engine import postprocess

    shape, num_classes = (21, 18, 23), 15
    rng = np.random.default_rng(3)
    labels = np.zeros(shape, np.uint8)
    atlas = np.zeros(shape, bool)
    atlas[4:15, 3:12, 5:17] = True
    if case == "ties":
        labels[4, 3:5, 5:7] = 3         # 4 atlas voxels, first: wins
        labels[9, 10:14, 15:19] = 3     # 16 voxels, 4 in the atlas
        labels[1, 1, 1:4] = 4           # no atlas voxel; 3 voxels, first
        labels[19, 1, 1:4] = 4          # ties it
        labels[18, 16, 20] = 4
    elif case == "beyond_classes":
        labels = rng.integers(0, 256, shape).astype(np.uint8)
        labels[rng.random(shape) < 0.3] = 0
    elif case == "one_voxel":
        labels[7, 7, 7] = 14
    elif case == "int16_uint8_atlas":
        labels = rng.integers(-3, 40, shape).astype(np.int16)
        atlas = atlas.astype(np.uint8) * 7
    elif case == "two_classes":
        num_classes = 2
        labels = (rng.random(shape) < 0.4).astype(np.uint8)
    want = postprocess.post_process_segmentation(
        "", labels, atlas_mask=atlas, num_classes=num_classes,
        cc_backend="scipy")
    got = postprocess.post_process_segmentation(
        "", labels, atlas_mask=atlas, num_classes=num_classes,
        cc_backend="device", device=cuda_device)
    assert got.dtype == labels.dtype
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any() == (case != "empty")


# ------------------------------------------------------------- registration
def _reg_pair(shape=(36, 40, 34)):
    """A smooth structured pair: blobs, and the same under a 1.5-voxel
    sinusoidal warp along x."""
    from scipy import ndimage

    rng = np.random.default_rng(7)
    base = ndimage.gaussian_filter(rng.random(shape) * 100, 2).astype(np.float32)
    base[:4] = 0
    base[-4:] = 0
    coords = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                                  indexing="ij"), 0).astype(np.float64)
    coords[0] += 1.5 * np.sin(np.linspace(0, np.pi, shape[0]))[:, None, None]
    flo = ndimage.map_coordinates(base, coords, order=1).astype(np.float32)
    return base, flo


@pytest.mark.cuda
def test_resamplers_card_match_cpu(cuda_device):
    """Both resamplers on a 15-channel volume, card vs CPU: 1e-5 of the
    value range, whatever the global TF32 flags say."""
    from subcort_tpu_torch.registration import (resample_through_affine,
                                                resample_through_cpp)
    from subcort_tpu_torch.registration.torch_backend import CppGrid
    from subcort_tpu_torch.registration.torch_ffd import _grid_counts

    rng = np.random.default_rng(3)
    flo = rng.random((30, 34, 28, 15)).astype(np.float32)
    flo_affine = np.diag([1.0, 1.0, 1.2, 1.0])
    ref_shape, ref_affine = (28, 30, 20), np.diag([1.0, 1.0, 1.5, 1.0])
    A = np.eye(4)
    A[:3, :3] += rng.standard_normal((3, 3)) * 0.04
    A[:3, 3] = [1.5, -1.0, 0.5]
    spacing = (5.0, 5.0, 10.0 / 3.0)
    disp = (rng.standard_normal(_grid_counts(ref_shape, spacing) + (3,))
            * 2.0).astype(np.float32)
    grid = CppGrid(disp, spacing, ref_affine)
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for fn, how in ((resample_through_affine, A),
                        (resample_through_cpp, grid)):
            card = fn(flo, flo_affine, how, ref_shape, ref_affine,
                      device=cuda_device)
            cpu = fn(flo, flo_affine, how, ref_shape, ref_affine,
                     device="cpu")
            assert float(np.abs(cpu).max()) > 0.1
            np.testing.assert_allclose(card, cpu, atol=1e-5)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.cuda
@pytest.mark.parametrize("cost,be", [("ssd", 0.05), ("nmi", 5e-4)])
def test_ffd_level_loss_and_gradient_card_match_cpu(cuda_device, cost, be):
    """One FFD level's loss (rtol 1e-5) and gradient (rtol 1e-3, atol
    scaled by the largest |gradient|) on the card against the CPU, the
    hinge on."""
    from subcort_tpu_torch.config import exact_float32
    from subcort_tpu_torch.registration import torch_ffd
    from subcort_tpu_torch.registration.torch_backend import downsample2

    ref, flo = _reg_pair()
    ref_c, ra = downsample2(ref, np.eye(4))
    flo_c, fa = downsample2(flo, np.eye(4))
    nc = torch_ffd._grid_counts(ref.shape, 6.0)
    disp = (np.random.default_rng(3).standard_normal(nc + (3,)) * 3.0
            ).astype(np.float32)
    got = {}
    for dev in (cuda_device, torch.device("cpu")):
        arrays = [np.zeros_like(disp), ref_c, flo_c, ra, np.linalg.inv(fa)]
        tensors = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                   for a in arrays]
        with exact_float32():
            loss_fn = torch_ffd._level_loss(*tensors, (3.0, 3.0, 3.0), be,
                                            cost=cost, jw=1.0,
                                            vox_offset=0.25)
            d = torch.from_numpy(disp).to(dev).requires_grad_(True)
            loss = loss_fn(d)
            loss.backward()
        got[dev.type] = (loss.item(), d.grad.cpu().numpy())
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0], rtol=1e-5)
    scale = float(np.abs(got["cpu"][1]).max())
    np.testing.assert_allclose(got["cuda"][1], got["cpu"][1], rtol=1e-3,
                               atol=1e-3 * scale)


@pytest.mark.cuda
def test_register_masks_on_the_card(cuda_device, tmp_path):
    """register_masks with its default backend on a small phantom on the
    card: the file set, majority prior overlap, and, while spans record,
    a ``register.*`` span of every stage, with its peak device memory,
    whose spans (with their IO, mask, level and capture children) sum to
    the call; with spans off nothing is recorded and the device's peak
    statistics are left alone."""
    import shutil

    from scipy import ndimage

    from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii
    from subcort_tpu_torch.registration import (make_synthetic_atlas,
                                                register_masks)
    from subcort_tpu_torch.utils import runtime

    atlas_dir = str(tmp_path / "atlases")
    template, atlas = make_synthetic_atlas(atlas_dir, shape=(36, 40, 34))
    shift = (1.5, -1.0, 0.5)
    subject = ndimage.shift(template, shift, order=1).astype(np.float32)
    (tmp_path / "subj").mkdir()
    scan = str(tmp_path / "subj" / "T1.nii.gz")
    save_nii(NiftiImage(subject), scan)
    runtime.clear_records()
    with runtime.recording():
        seconds = register_masks(scan, atlas_dir=atlas_dir,
                                 device=cuda_device,
                                 tools_dir=str(tmp_path / "no_tools_here"))
    recs = runtime.records()
    report = runtime.self_seconds(recs)
    tmp = tmp_path / "subj" / "tmp"
    for f in ("transf.txt", "transform.nii", "rT1_template.nii.gz",
              "rT1d_template.nii.gz", "MNI_sub_probabilities.nii.gz",
              "MNI_subcortical_mask.nii.gz"):
        assert (tmp / f).exists(), f
    probs = load_nii(str(tmp / "MNI_sub_probabilities.nii.gz")).data
    want = np.stack([ndimage.shift(atlas[..., c], shift, order=1)
                     for c in range(14)], -1)
    inter = ((probs[..., :14] > 0.2) & (want > 0.2)).sum()
    union = ((probs[..., :14] > 0.2) | (want > 0.2)).sum()
    assert inter / max(union, 1) > 0.5
    stages = ("register.affine", "register.ffd", "register.prior_warp")
    for stage in stages:
        assert report[stage] > 0
        (rec,) = [r for r in recs if r.name == stage]
        assert rec.attrs["peak_bytes"] > 0
    assert report["register.io"] > 0 and report["register.mask"] > 0
    spans = sum(v for k, v in report.items() if k != "register.masks")
    assert 0.95 * seconds <= spans <= seconds
    assert register_masks(scan, atlas_dir=atlas_dir, backend="torch",
                          device=cuda_device) < 1.0
    # spans off: nothing recorded, the process's peak statistics untouched
    runtime.clear_records()
    shutil.rmtree(tmp)
    big = torch.empty(1 << 28, dtype=torch.uint8, device=cuda_device)
    peak = torch.cuda.max_memory_allocated(cuda_device)
    del big
    register_masks(scan, atlas_dir=atlas_dir, device=cuda_device)
    assert runtime.records() == []
    assert torch.cuda.max_memory_allocated(cuda_device) >= peak


@pytest.mark.cuda
def test_register_masks_writes_file_order_on_the_card(cuda_device, tmp_path,
                                                      monkeypatch):
    """register_masks on the card, the deflate chunk cut to 64 KiB so that
    every volume goes through the threaded writer: the priors' voxels are
    ``resample_through_cpp``'s output through the call's own grid, the
    mask is ``_roi_mask`` of those priors, and the priors and both
    templates were written in file order (the control grid and the mask,
    dilated by scipy in C order, transposed)."""
    from scipy import ndimage

    from subcort_tpu_torch.io import NiftiImage, load_nii, nifti, save_nii
    from subcort_tpu_torch.registration import (load_cpp_grid,
                                                make_synthetic_atlas,
                                                register_masks,
                                                resample_through_cpp)
    from subcort_tpu_torch.registration.driver import ATLAS_NAME, _roi_mask

    monkeypatch.setattr(nifti, "DEFLATE_CHUNK", 1 << 16)
    atlas_dir = str(tmp_path / "atlases")
    template, _ = make_synthetic_atlas(atlas_dir, shape=(36, 40, 34))
    subject = ndimage.shift(template, (1.5, -1.0, 0.5),
                            order=1).astype(np.float32)
    (tmp_path / "subj").mkdir()
    scan = str(tmp_path / "subj" / "T1.nii.gz")
    save_nii(NiftiImage(subject), scan)
    writes, chunks = dict(nifti.WRITES), nifti.DEFLATED_CHUNKS
    register_masks(scan, atlas_dir=atlas_dir, device=cuda_device)
    assert nifti.WRITES["in_order"] - writes["in_order"] == 3
    assert nifti.WRITES["transposed"] - writes["transposed"] == 2
    # the priors' 2,937,600 B in 45 chunks, each template's 195,840 B in 3,
    # the mask's 34 slabs of 5,760 B in runs of 11
    assert nifti.DEFLATED_CHUNKS - chunks == 45 + 2 * 3 + 4

    tmp = tmp_path / "subj" / "tmp"
    t1 = load_nii(scan)
    atlas = load_nii(f"{atlas_dir}/{ATLAS_NAME}")
    want = resample_through_cpp(
        atlas.data, atlas.affine,
        load_cpp_grid(str(tmp / "transform.nii"), t1.affine), t1.shape,
        t1.affine, device=cuda_device)
    priors = load_nii(str(tmp / "MNI_sub_probabilities.nii.gz")).data
    assert priors.dtype == np.float32 and priors.shape == want.shape
    assert priors.tobytes() == want.tobytes()
    mask = load_nii(str(tmp / "MNI_subcortical_mask.nii.gz")).data
    np.testing.assert_array_equal(mask, _roi_mask(priors, 13, 5))
    assert mask.any()


# the level kinds of register_masks: the affine's rigid and 12-dof phases,
# the FFD under SSD and under NMI, the fold penalty on
LEVEL_KINDS = [("affine", "nmi", 6), ("affine", "nmi", 12),
               ("ffd", "ssd", None), ("ffd", "nmi", None)]


def _level(kind, cost, dof, device, iters=8):
    """A function of ``eager`` that runs one optimiser level of ``kind`` on
    ``device`` over _reg_pair at half resolution, from parameters a little
    off the start, and returns (parameters, losses)."""
    from subcort_tpu_torch.registration import torch_affine, torch_ffd
    from subcort_tpu_torch.registration.torch_backend import downsample2

    ref, flo = _reg_pair()
    ref_c, ra = downsample2(ref, np.eye(4))
    flo_c, fa = downsample2(flo, np.eye(4))
    rng = np.random.default_rng(6)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    if kind == "affine":
        center, _ = torch_affine._moments(ref, np.eye(4))
        args = [t(a) for a in (rng.standard_normal(12) * 0.3, center, ref_c,
                               flo_c, ra, np.linalg.inv(fa))]
        return lambda eager: torch_affine._optimize_level(
            *args, iters, 0.05, cost=cost, dof=dof, _eager=eager)
    nc = torch_ffd._grid_counts(ref.shape, 6.0)
    disp = rng.standard_normal(nc + (3,)) * 3.0
    args = [t(a) for a in (disp, np.zeros_like(disp), ref_c, flo_c, ra,
                           np.linalg.inv(fa))]
    be = 0.05 if cost == "ssd" else 5e-4
    return lambda eager: torch_ffd._optimize_level(
        *args, (3.0, 3.0, 3.0), iters, be, 0.4, cost=cost, jw=1.0,
        vox_offset=0.25, _eager=eager)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cost,dof", LEVEL_KINDS)
def test_graphed_level_equals_eager_level(cuda_device, kind, cost, dof):
    """One optimiser level as a plain loop and as warm-up iterations plus
    replays of one captured iteration: parameters and every loss equal bit
    for bit (gathers, einsums and matmuls, no atomics), and the levels'
    ``register.level`` spans say which of the two ran, the capture a
    ``graph.capture`` span under the graphed one."""
    from subcort_tpu_torch.registration import torch_backend
    from subcort_tpu_torch.utils import runtime

    level = _level(kind, cost, dof, cuda_device)
    runtime.clear_records()
    with runtime.recording():
        eager, graphed = level(True), level(False)
    recs = runtime.records()
    runtime.clear_records()
    log = [r.attrs for r in recs if r.name == "register.level"]
    assert [e["replayed"] for e in log] == [False, True]
    assert log[1]["warmup_iters"] == torch_backend.WARMUP_ITERS
    assert log[1]["capture_ms"] > 0 and log[1]["device_ms_per_iter"] > 0
    assert log[0]["capture_ms"] is None and log[0]["warmup_iters"] == 0
    (capture,) = [r for r in recs if r.name == "graph.capture"]
    assert capture.parent == [r for r in recs
                              if r.name == "register.level"][1].id
    for got, want in zip(graphed, eager):
        assert got.is_cuda and torch.equal(got, want)


@pytest.mark.cuda
def test_level_captured_on_a_second_thread_while_the_main_thread_segments(
        cuda_device):
    """An FFD level (NMI, the hinge on) captured and replayed on a second
    thread's own stream, as the pipelined folder sweep registers on its
    loader thread, while the main thread runs segment_volume again and
    again: the level equals its serial run bit for bit, and every
    segmentation equals the serial one."""
    import threading

    level = _level("ffd", "nmi", None, cuda_device, iters=40)
    image, atlas, centers = _scan()
    net = TriPlanarNet.from_params(
        init_params(NARROW, torch.Generator().manual_seed(0)), NARROW,
        cuda_device)

    def segment():
        return segment_volume(net, image, atlas, centers, want_probs=True,
                              chunk=1000, engine="patch",
                              probs_dtype=np.float32)

    want_level, want_seg = level(False), segment()
    out = {}

    def loader():
        try:
            stream = torch.cuda.Stream(cuda_device)
            with torch.cuda.stream(stream):
                out["level"] = level(False)
            stream.synchronize()
        except BaseException as e:  # re-raised on the main thread
            out["error"] = e

    thread = threading.Thread(target=loader)
    segs = []
    thread.start()
    while thread.is_alive() or not segs:
        segs.append(segment())
    thread.join()
    if "error" in out:
        raise out["error"]
    for got, want in zip(out["level"], want_level):
        assert torch.equal(got, want)
    for labels, probs in segs:
        np.testing.assert_array_equal(labels, want_seg[0])
        np.testing.assert_array_equal(probs, want_seg[1])


@pytest.mark.cuda
def test_bench_scan_run_on_the_card_matches_the_cpu(cuda_device,
                                                     monkeypatch):
    """``bench/scan.py``'s ``run`` on tests/test_torch_bench_scan.py's
    phantom with a narrow seeded net, on the CPU and on the card, one
    repeat: the exact, probability-map and patch canary labels equal, the
    fast profile's (bfloat16) at >= 0.999; the gather kernel launched once
    per chunk of the canary during the card's run and never during the
    CPU's; the card's line carries its name and the table's peak."""
    from scipy import ndimage

    from subcort_tpu_torch.bench import scan
    from test_torch_bench_scan import NARROW as NARROW_KW
    from test_torch_bench_scan import _config, make_phantom

    image, atlas, roi = make_phantom(np.random.default_rng(0))
    params = init_params(NARROW, torch.Generator().manual_seed(0))
    real = scan.segment_volume
    labels, recs, launches = {}, {}, {}
    assert NARROW == TriPlanarSpec(**NARROW_KW)
    for dev in (torch.device("cpu"), cuda_device):
        seen = labels[dev.type] = {}

        def spy(*args, seen=seen, **kw):
            out = real(*args, **kw)
            seen[_config(kw)] = out[0]
            return out

        monkeypatch.setattr(scan, "segment_volume", spy)
        net = TriPlanarNet.from_params(params, NARROW, dev)
        before = gather_kernel.LAUNCHES
        recs[dev.type] = scan.run(net, image, atlas, roi,
                                  np.random.default_rng(5), device=dev,
                                  repeats=1, oracle_n=8)
        launches[dev.type] = gather_kernel.LAUNCHES - before
    cpu, card = labels["cpu"], labels["cuda"]
    for config in ("exact", "probs", "patch"):
        np.testing.assert_array_equal(card[config], cpu[config])
    n = recs["cuda"]["candidate_voxels"]
    sel = np.nonzero(ndimage.binary_dilation(roi, iterations=10))
    assert len(sel[0]) == n
    assert float(np.mean(card["fast"][sel] == cpu["fast"][sel])) >= 0.999
    assert launches == {"cpu": 0, "cuda": -(-n // 8192)}
    assert recs["cuda"]["fcn_vs_patch_agreement"] == \
        recs["cpu"]["fcn_vs_patch_agreement"]
    name = torch.cuda.get_device_name(cuda_device)
    rec = recs["cuda"]
    assert rec["device"] == name
    assert rec["peak_flops_assumed"] == scan.PEAK_FLOPS.get(name)
    if name == "NVIDIA H100 80GB HBM3":
        assert rec["peak_flops_assumed"] == 989.4e12
        assert rec["est_mfu_bf16"] > 0 and rec["est_mfu_f32_vs_bf16_peak"] > 0


@pytest.fixture()
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block (the default
    convolution backward sums in no fixed order, so two eager runs may
    differ in the last bits)."""
    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    yield
    cudnn.deterministic, cudnn.benchmark = flags


FULL_DROPOUT = TriPlanarSpec()
MULTISTEP_CASES = {
    "float32": (FULL_DROPOUT, None, dict(augment=True, intensity_augment=0.3)),
    "bfloat16": (FULL_DROPOUT, torch.bfloat16, dict(augment=True)),
    "patch40": (dataclasses.replace(FULL_DROPOUT, patch_size=40), None, {}),
}


def _multistep_run(device, case, eager, calls=(10, 3), batch=128):
    """One multistep at full width over ``calls`` calls of (K, 128) rows of
    a 2-subject stack, from seeded params and a seeded device generator,
    graphed or with ``eager`` the plain loop: (losses, state dict, Adam's
    state, the generator's state, gather launches, the GraphedStep)."""
    from subcort_tpu_torch.engine.train import (DeviceAdam,
                                                make_train_multistep)

    spec, dtype, opts = MULTISTEP_CASES[case]
    n = sum(calls) * batch
    vols, centers, labels, atlas = _train_batch(seed=9, b=n,
                                                extent=(40, 44, 36))
    params = init_params(spec, torch.Generator().manual_seed(6))
    net = TriPlanarNet.from_params(params, spec, device, trainable=True)
    optimizer = DeviceAdam(net.parameters(), **ADAM)
    gen = torch.Generator(device=device).manual_seed(8)
    volume = prepare_gather_volume(torch.from_numpy(vols).to(device))
    rows = [torch.from_numpy(a).to(device) for a in (centers, labels, atlas)]
    before, losses, i = gather_kernel.LAUNCHES, [], 0
    with make_train_multistep(net, optimizer, volume, gen, spec.patch_size,
                              max(calls), compute_dtype=dtype, _eager=eager,
                              **opts) as ms:
        for k in calls:
            sl = slice(i * batch, (i + k) * batch)
            losses.append(ms(*(r[sl].view((k, batch) + r.shape[1:])
                               for r in rows)))
            i += k
    launches = gather_kernel.LAUNCHES - before
    adam = [{k: v.clone() for k, v in optimizer.state[p].items()}
            for p in net.parameters()]
    return (torch.cat(losses), net.state_dict(), adam, gen.get_state(),
            launches, ms.graphed)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MULTISTEP_CASES))
def test_graphed_multistep_equals_eager_multistep(cuda_device,
                                                  deterministic_cudnn, case):
    """Full width, batch 128, 13 steps in two calls (10, then 3) on a
    2-subject stack: the replays of one captured step against the plain
    loop, bit for bit: the losses, parameters and BN EMA, Adam's state and
    the step generator's state (float32 with dropout, view and intensity
    augmentation; bfloat16; patch 40, the plain gather on the card). The
    gather kernel launches once per step, graphed or not; at patch 40
    never."""
    eager = _multistep_run(cuda_device, case, True)
    graphed = _multistep_run(cuda_device, case, False)
    steps = len(eager[0])
    assert eager[5] is None
    g = graphed[5]
    assert (g.warmup_calls, g.replays) == (2, steps - 2) and g.capture_ms > 0
    assert g.graph is None  # released when the multistep closed
    assert len(set(graphed[0].tolist())) == steps
    assert torch.equal(graphed[0], eager[0])
    for k, v in eager[1].items():
        assert torch.equal(graphed[1][k], v), k
    for got, want in zip(graphed[2], eager[2]):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert torch.equal(graphed[3], eager[3])
    want_launches = 0 if case == "patch40" else steps
    assert graphed[4] == eager[4] == want_launches


def _card_index(seed=5, b=600):
    vols, centers, labels, atlas = _train_batch(seed=seed, b=b)
    return TrainingIndex(vols, centers, labels.astype(np.int32), atlas,
                         ["a", "b"])


def _card_options(name, **kw):
    return Options(**{**dict(experiment=name, batch_size=32, max_epochs=3,
                             patience=5, train_split=0.25, net_verbose=0,
                             load_weights=False, seed=2), **kw})


def _strip(history):
    return [{k: v for k, v in h.items() if k != "dur"} for h in history]


@pytest.mark.cuda
def test_graphed_fit_with_lr_schedule_equals_eager_fit(
        cuda_device, deterministic_cudnn, tmp_path):
    """Three epochs with a learning-rate schedule, dropout and
    augmentation: the graphed fit (captured once, its replays taking each
    epoch's rate) equals the _eager fit bit for bit, history and
    parameters, and the kernel launched exactly once per step and per eval
    batch."""
    from subcort_tpu_torch.engine import train_split_stratified

    index = _card_index()
    spec = dataclasses.replace(NARROW, dropout_conv=0.3, dropout_fc=0.3)
    runs = {}
    for eager in (True, False):
        trainer = Trainer(_card_options(f"lr{eager}"), spec=spec,
                          augment=True, lr_schedule=(1e-3, 1e-4),
                          steps_per_call=4,
                          weights_path=str(tmp_path / str(eager)))
        before = gather_kernel.LAUNCHES
        history = trainer.fit(index, _eager=eager)
        runs[eager] = (_strip(history), trainer.params,
                       gather_kernel.LAUNCHES - before, trainer.step_graph)
    t_idx, v_idx = train_split_stratified(index.labels, 0.25)
    steps = 3 * (len(t_idx) // 32)
    assert runs[True][3] is None
    graph = runs[False][3]
    assert (graph.warmup_calls, graph.replays) == (2, steps - 2)
    assert runs[False][0] == runs[True][0]
    assert all(torch.equal(runs[False][1][k], v)
               for k, v in runs[True][1].items())
    evals = 3 * -(-len(v_idx) // 2048)
    assert runs[False][2] == runs[True][2] == steps + evals


@pytest.mark.cuda
def test_graphed_fit_resumes_to_the_uninterrupted_fit(
        cuda_device, deterministic_cudnn, tmp_path):
    """A graphed fit stopped after epoch 1 and resumed from its state
    file gives the uninterrupted graphed fit's history and parameters."""
    index = _card_index(seed=6)
    kw = dict(spec=NARROW, augment=True, shuffle_each_epoch=True,
              steps_per_call=4)
    whole = Trainer(_card_options("whole", max_epochs=2), **kw,
                    weights_path=str(tmp_path / "a"))
    want = _strip(whole.fit(index))
    Trainer(_card_options("part", max_epochs=1), **kw,
            weights_path=str(tmp_path / "b")).fit(index)
    resumed = Trainer(_card_options("part", max_epochs=2, load_weights=True),
                      **kw, weights_path=str(tmp_path / "b"))
    assert resumed.epoch == 1
    assert _strip(resumed.fit(index)) == want
    assert resumed.step_graph.replays > 0
    assert all(torch.equal(resumed.params[k], v)
               for k, v in whole.params.items())


@pytest.mark.cuda
def test_graphed_fit_raises_on_a_nan_loss(cuda_device, tmp_path):
    """With the checks on, a graphed fit from a NaN parameter raises
    FloatingPointError naming step 1, after the call's replays."""
    from subcort_tpu_torch.utils import runtime

    params = init_params(NARROW, torch.Generator().manual_seed(0))
    params["fc1.weight"][0, 0] = float("nan")
    trainer = Trainer(_card_options("nan"), spec=NARROW, params=params,
                      steps_per_call=8, weights_path=str(tmp_path))
    runtime.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError,
                           match="NaN in the train loss of epoch 1, step 1 "):
            trainer.fit(_card_index())
    finally:
        runtime.NAN_CHECKS = False
        torch.autograd.set_detect_anomaly(False)


def _rank_fit(path):
    with open(path / "rank0.pkl", "rb") as fh:
        return pickle.load(fh)


def _same(a, b) -> bool:
    """Nested dicts and lists of arrays and scalars equal, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.cuda
def test_nccl_rank_graphed_fit_equals_eager_fit(cuda_device,
                                                deterministic_cudnn,
                                                tmp_path):
    """One NCCL rank (world 1) runs Trainer.fit as a fit over several
    cards runs each rank (train.train_rank): graphed by default, 2
    warm-up steps and the rest replayed with the gradient all-reduce
    inside the graph, and bit-equal to the same rank's _eager fit: the
    history, the parameters and BN EMA, Adam's state and the step
    generator's; the kernel launched once per step and per eval batch."""
    from subcort_tpu_torch.engine import train_split_stratified
    from subcort_tpu_torch.parallel import distributed
    from test_torch_rank_multistep import train_ranks

    index = _card_index()
    spec = dataclasses.replace(NARROW, dropout_conv=0.3, dropout_fc=0.3)
    work = {eager: tmp_path / f"eager{eager}" for eager in (False, True)}
    for eager, path in work.items():
        path.mkdir()
        Trainer(_card_options(f"nccl{eager}"), spec=spec, augment=True,
                steps_per_call=4, weights_path=str(path / "nets"),
                devices=[cuda_device]).hand_off(path, index, 3, eager)
    assert distributed.launch(train_ranks, [cuda_device],
                              ([str(p) for p in work.values()],),
                              timeout=150) == "nccl"
    graphed, eager = _rank_fit(work[False]), _rank_fit(work[True])
    t_idx, v_idx = train_split_stratified(index.labels, 0.25)
    steps = 3 * (len(t_idx) // 32)
    assert graphed["step"]["graphed"] and graphed["step"]["capture_ms"] > 0
    assert (graphed["step"]["warmup_steps"],
            graphed["step"]["replays"]) == (2, steps - 2)
    assert eager["step"] == {"graphed": False, "warmup_steps": 0,
                             "replays": 0, "capture_ms": None}
    assert _strip(graphed["history"]) == _strip(eager["history"])
    for part in ("params", "optimizer", "generator"):
        assert _same(graphed["state"][part], eager["state"][part]), part
    evals = 3 * -(-len(v_idx) // 2048)
    assert graphed["launches"] == eager["launches"] == steps + evals


@pytest.mark.cuda
def test_nccl_rank_whose_capture_fails_fails_the_launch(cuda_device,
                                                        tmp_path):
    """An NCCL rank whose step reads a value back: its two eager warm-up
    steps run, the capture raises, and the rank fails the launch at once
    (well inside the launcher's bound), with no fit finished: nothing
    falls back to the plain loop."""
    import time

    from subcort_tpu_torch.parallel import distributed
    from subcort_tpu_torch.utils.graphs import WARMUP
    from test_torch_rank_multistep import failing_capture_rank

    Trainer(_card_options("fails"), spec=NARROW, steps_per_call=4,
            weights_path=str(tmp_path / "nets"),
            devices=[cuda_device]).hand_off(tmp_path, _card_index(), 3)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[0\] of 1"):
        distributed.launch(failing_capture_rank, [cuda_device],
                           (str(tmp_path),), timeout=150)
    assert time.monotonic() - t0 < 75
    assert int((tmp_path / "calls").read_text()) == WARMUP + 1
    assert not (tmp_path / "rank0.pkl").exists()


@pytest.mark.cuda
def test_graph_pools_do_not_pile_up(cuda_device):
    """Ten GraphedSteps in turn, each capturing a step whose temporaries
    take 512 MB: every closed graph's pool goes back to the device, so the
    caching allocator's reserved bytes stay where the first left them
    (before each capture took a pool of its own, they grew by 512 MB a
    graph; registration's levels grew them by about 14 GB a call)."""
    from subcort_tpu_torch.utils.graphs import GraphedStep

    x = torch.zeros(1 << 20, device=cuda_device)

    def step():
        big = torch.ones(1 << 27, device=cuda_device)  # 512 MB
        x.add_(big[: x.numel()])

    reserved = []
    for _ in range(10):
        with GraphedStep(step, cuda_device) as graphed:
            graphed.run(5)
        torch.cuda.synchronize(cuda_device)
        reserved.append(torch.cuda.memory_reserved(cuda_device))
    assert float(x[0]) == 50.0
    assert max(reserved) - reserved[0] <= 64 << 20, reserved


def _views_setup(device, filters, shape, size):
    """FastSurferCNN's views at ``filters`` with the benchmark's seeded
    weights calibrated on a scan of ``shape`` (``frozen.make_scan``)."""
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from benchmark import frozen, weights_fastsurfer
    cfg = dict(json.loads((root / "benchmark/configs/fastsurfer_cnn.json")
                          .read_text()), num_filters=filters)
    image = frozen.make_scan(np.random.default_rng(41), shape)[0]
    params = weights_fastsurfer.make_weights(cfg, 41, device)
    weights_fastsurfer.calibrate(params, cfg, image, device, 41, n=8,
                                 size=size)
    return params, image


@pytest.mark.cuda
def test_views_card_matches_cpu(cuda_device):
    """The multi-view path at the CPU tests' small spec (8 filters, a 32^3
    conformed volume): the card's P within 1e-5 of the CPU's on all but a
    thousandth of the voxels (max-unpool's near-ties), labels equal on
    >= 0.995 of them."""
    from subcort_tpu_torch.engine import views
    from subcort_tpu_torch.models.fastsurfer import FastSurferViews

    params, image = _views_setup(cuda_device, 8, (24, 28, 22), 32)
    cpu_params = {v: {k: t.cpu() for k, t in p.items()}
                  for v, p in params.items()}
    card = FastSurferViews.from_params(params, cuda_device)
    cpu = FastSurferViews.from_params(cpu_params, "cpu")
    from subcort_tpu_torch.config import exact_float32

    vol, _ = views.conform(torch.from_numpy(image), 32)
    vol = vol.float() / 255.0
    with torch.no_grad(), exact_float32():
        p_card = views.view_probabilities(card, vol.to(cuda_device), 16)
        p_cpu = views.view_probabilities(cpu, vol, 16)
    off = (p_card.cpu() - p_cpu).abs().max(-1).values
    assert float((off > 1e-5).float().mean()) <= 1e-3
    got = views.segment_views(card, image, (1, 1, 1), size=32)
    want = views.segment_views(cpu, image, (1, 1, 1), size=32)
    assert got.shape == image.shape
    assert float((got == want).mean()) >= 0.995


@pytest.mark.cuda
def test_views_full_width_batch_matches_reference(cuda_device):
    """One batch of 16 axial thick slices at the published widths (7 x 256 x
    256, 64 filters, 5 x 5, 79 classes) on the card against the plain
    reference: the slices bit-equal, the logits' argmax equal on >= 0.999
    of the pixels, their median difference under 1e-5 of the range."""
    from benchmark.reference import fastsurfer as ref
    from subcort_tpu_torch.config import exact_float32
    from subcort_tpu_torch.engine import views
    from subcort_tpu_torch.models.fastsurfer import FastSurferCNN

    params, image = _views_setup(cuda_device, 64, (181, 217, 181), 256)
    net = FastSurferCNN.from_params(params["axial"], device=cuda_device)
    vol = torch.from_numpy(ref.conform(image)[0]).to(cuda_device)
    vol = vol.float() / 255.0
    with torch.no_grad(), exact_float32():
        mine = views._thick_slices(views.view_volume(vol, 2), 120, 136)
        want = ref.thick_slices(vol, 2, 120, 136)
        assert torch.equal(mine, want)
        got, logits = net(mine), ref.forward(params["axial"], want)
    assert got.shape == (16, 79, 256, 256)
    agree = float((got.argmax(1) == logits.argmax(1)).float().mean())
    assert agree >= 0.999
    assert float((got - logits).abs().median()
                 / logits.abs().max()) < 1e-5


def _synthseg_setup(device, feat, shape):
    """SynthSeg's net at ``feat`` base filters with the benchmark's seeded
    weights calibrated on a scan of ``shape`` (``frozen.make_scan``)."""
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from benchmark import frozen, weights_synthseg
    cfg = dict(json.loads((root / "benchmark/configs/synthseg_unet.json")
                          .read_text()), unet_feat_count=feat)
    image = frozen.make_scan(np.random.default_rng(43), shape)[0]
    params = weights_synthseg.make_weights(cfg, 43, device)
    weights_synthseg.calibrate(params, image, device)
    return cfg, params, image


@pytest.mark.cuda
def test_synthseg_card_matches_reference(cuda_device):
    """SynthSeg's path at 8 base filters on a 60 x 70 x 58 scan (padded to
    64 x 96 x 64) on the card: the flip-averaged P within 1e-5 of the
    plain reference's on the card (TF32's lies further off); the labels
    equal the reference's post-process of the program's own P but at a
    thousandth of the voxels (a class sum crossing 0.25 in another
    order); two forwards and two filter launches a scan."""
    from benchmark.reference import synthseg as ref
    from subcort_tpu_torch.engine import synthseg
    from subcort_tpu_torch.models.synthseg import SynthSegUNet
    from subcort_tpu_torch.ops import connected

    cfg, params, image = _synthseg_setup(cuda_device, 8, (60, 70, 58))
    net = SynthSegUNet.from_params(params, cuda_device)
    prob, offsets = synthseg.flip_averaged_posteriors(net, image, (1, 1, 1),
                                                      cuda_device)
    want, want_offsets = ref.posteriors(params, image, cfg["labels"],
                                        cfg["lr_pairs"], cuda_device)
    assert prob.shape == (33, 64, 96, 64) and offsets == want_offsets
    assert float((prob - want).abs().max()) <= 1e-5
    low, _ = ref.posteriors(params, image, cfg["labels"], cfg["lr_pairs"],
                            cuda_device, "tf32")
    assert float((low - want).abs().max()) > 1e-4
    forwards, launches = synthseg.FORWARDS, connected.FILTER_LAUNCHES
    labels = synthseg.segment_synthseg(net, image, (1, 1, 1), cuda_device)
    assert synthseg.FORWARDS - forwards == 2
    assert connected.FILTER_LAUNCHES - launches == 2
    post = ref.crop_labels(ref.postprocess(prob.cpu().numpy(),
                                           cfg["topology_classes"]),
                           offsets, image.shape, cfg["structure_of"])
    assert labels.shape == image.shape
    assert float((labels != post).mean()) <= 1e-3


@pytest.mark.cuda
def test_synthseg_component_step_kernel_matches_plain(cuda_device):
    """``keep_largest`` on the card (the filter kernel, two launches)
    against its plain version on the CPU, bit for bit, on blobby planted
    posteriors in 1/64 steps (so every class sum is exact in any order)."""
    from subcort_tpu_torch.engine import synthseg
    from subcort_tpu_torch.ops import connected

    g = torch.Generator().manual_seed(5)
    logits = torch.nn.functional.avg_pool3d(
        torch.randn((33, 48, 56, 40), generator=g)[None], 5, 1, 2)[0] * 8
    prob = torch.floor(torch.softmax(logits, 0) * 64) / 64
    prob[0] += 1 - prob.sum(0)
    card = prob.to(cuda_device)
    launches = connected.FILTER_LAUNCHES
    assert synthseg.keep_largest(card) == 2
    assert connected.FILTER_LAUNCHES - launches == 2
    plain = prob.clone()
    synthseg.keep_largest(plain)
    assert torch.equal(card.cpu(), plain)
    assert not torch.equal(plain, prob)


def _swinunetr_setup(device, shape, **cut):
    """SwinUNETR's config (``cut`` replacing widths) with the benchmark's
    seeded weights centred on a scan of ``shape`` (``frozen.make_scan``)."""
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from benchmark import frozen, weights_swinunetr
    cfg = dict(json.loads((root / "benchmark/configs/swin_unetr.json")
                          .read_text()), **cut)
    image = frozen.make_scan(np.random.default_rng(29), shape)[0]
    params = weights_swinunetr.make_weights(cfg, 29, device)
    roi = int(cfg["roi"][0])
    weights_swinunetr.center(params, image, device, roi, cfg["overlap"])
    return cfg, params, image


@pytest.mark.cuda
def test_swinunetr_card_matches_reference_at_published_widths(cuda_device):
    """SwinUNETR at the published widths (48 -> 768, 7^3 windows, 3-24
    heads) on one 128^3 window on the card: the logits within 1e-4 of the
    largest of the plain reference's (the TF32 control lies further off),
    TF32 off whatever the global flags say, and two calls bit-equal."""
    from benchmark.reference import swinunetr as ref
    from subcort_tpu_torch.config import exact_float32
    from subcort_tpu_torch.models.swinunetr import SwinUNETR

    cfg, params, _ = _swinunetr_setup(cuda_device, (128, 128, 128))
    net = SwinUNETR.from_params(params, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn((1, 1, 128, 128, 128), generator=g, device=cuda_device)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad(), exact_float32():
            a, b = net(x), net(x)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    with torch.no_grad(), ref.full_float32():
        want = ref.forward(params, x)
        low = ref.forward(params, x, "tf32")
    scale = float(want.abs().max())
    assert a.shape == (1, 15, 128, 128, 128)
    assert torch.equal(a, b)
    assert float((a - want).abs().max()) <= 1e-4 * scale
    assert float((low - want).abs().max()) > 1e-4 * scale


@pytest.mark.cuda
def test_swinunetr_scan_on_card(cuda_device, monkeypatch):
    """SwinUNETR's path on a 140 x 130 x 120 scan at a cut width (24
    features, 64^3 windows: 4 x 4 x 3 of them in 12 batches of 4): the
    blended logits within 1e-4 of the reference's largest, the labels
    equal to the reference's post-process of the program's own raw
    labels, one filter launch a scan and a window counted each."""
    from benchmark.reference import swinunetr as ref
    from subcort_tpu_torch.engine import swinunetr
    from subcort_tpu_torch.models.swinunetr import SwinUNETR
    from subcort_tpu_torch.ops import connected

    cfg, params, image = _swinunetr_setup(cuda_device, (140, 130, 120),
                                          feature_size=24, roi=[64] * 3)
    net = SwinUNETR.from_params(params, cuda_device)
    monkeypatch.setattr(swinunetr, "ROI", 64)
    logits = swinunetr.blended_logits(net, image, (1, 1, 1), cuda_device)
    want = ref.blended_logits(params, image, cuda_device, 64, 0.5)
    assert logits.shape == (15,) + image.shape
    assert float((logits - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    windows, launches = swinunetr.WINDOWS, connected.FILTER_LAUNCHES
    labels = swinunetr.segment_swinunetr(net, image, (1, 1, 1), cuda_device)
    assert swinunetr.WINDOWS - windows == 48 == ref.window_count(
        image.shape, 64)
    assert connected.FILTER_LAUNCHES - launches == 1
    assert labels.shape == image.shape and labels.dtype == np.uint8
    assert np.array_equal(labels, ref.labels(logits))


@pytest.mark.cuda
def test_a_level_that_cannot_be_captured_raises(cuda_device):
    """run_level on the card with an iteration that reads a value back (a
    synchronizing copy, which a capture refuses): the call raises after the
    eager warm-up, and nothing falls back to the plain loop. Last in the
    file, after every other use of the card."""
    from subcort_tpu_torch.registration.torch_backend import (WARMUP_ITERS,
                                                              run_level)

    x = torch.zeros((), device=cuda_device)

    def step():
        x.add_(1.0)
        x.item()

    with pytest.raises(RuntimeError):
        run_level(step, WARMUP_ITERS + 3, cuda_device)
    torch.cuda.synchronize(cuda_device)
    assert float(x) == WARMUP_ITERS
