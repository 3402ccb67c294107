"""Card-only tests of the port: its CUDA gather kernel, the engines, the
train step (at patch 32 and at patch 40, which takes the plain gather), the
on-device registration and connected components on the card against the
CPU, ``exact_float32`` under two threads doing card work, and the
multi-device paths on the one card (the patch engine over two entries of
``cuda:0``; the synced step over one NCCL rank and over two gloo ranks,
whose rank functions come from tests/test_torch_distributed.py), and the
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
def test_register_masks_on_the_card(cuda_device, tmp_path, monkeypatch):
    """register_masks with its default backend on a small phantom on the
    card: the file set, majority prior overlap, and, while ``driver.REPORT``
    is a dict, a report of every stage that sums to the call, with peak
    device memory; with the hook off the device's peak statistics are left
    alone."""
    import shutil

    from scipy import ndimage

    from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii
    from subcort_tpu_torch.registration import (driver, make_synthetic_atlas,
                                                register_masks)

    atlas_dir = str(tmp_path / "atlases")
    template, atlas = make_synthetic_atlas(atlas_dir, shape=(36, 40, 34))
    shift = (1.5, -1.0, 0.5)
    subject = ndimage.shift(template, shift, order=1).astype(np.float32)
    (tmp_path / "subj").mkdir()
    scan = str(tmp_path / "subj" / "T1.nii.gz")
    save_nii(NiftiImage(subject), scan)
    monkeypatch.setattr(driver, "REPORT", {})
    seconds = register_masks(scan, atlas_dir=atlas_dir, device=cuda_device,
                             tools_dir=str(tmp_path / "no_tools_here"))
    report = driver.REPORT
    monkeypatch.setattr(driver, "REPORT", None)
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
    for stage in ("affine", "ffd", "prior_warp"):
        assert report[stage + "_s"] > 0
        assert report[stage + "_peak_bytes"] > 0
    assert report["io_s"] > 0 and report["mask_s"] > 0
    spans = sum(v for k, v in report.items() if k.endswith("_s"))
    assert 0.95 * seconds <= spans <= seconds
    assert register_masks(scan, atlas_dir=atlas_dir, backend="torch",
                          device=cuda_device) < 1.0
    # hook off: nothing recorded, the process's peak statistics untouched
    shutil.rmtree(tmp)
    big = torch.empty(1 << 28, dtype=torch.uint8, device=cuda_device)
    peak = torch.cuda.max_memory_allocated(cuda_device)
    del big
    register_masks(scan, atlas_dir=atlas_dir, device=cuda_device)
    assert driver.REPORT is None
    assert torch.cuda.max_memory_allocated(cuda_device) >= peak


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
