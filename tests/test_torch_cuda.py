"""Card-only tests of the port: its CUDA gather kernel, the engines, the
train step (at patch 32 and at patch 40, which takes the plain gather), the
on-device registration and connected components on the card against the
CPU, registration levels replayed from a CUDA graph against the plain loop
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
tests/test_torch_bench_scan.py); each skips without a CUDA device.

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
        post_process_segmentation("", labels, atlas_mask=atlas_mask))


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
    cards runs each rank (distributed.train_rank): graphed by default, 2
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
