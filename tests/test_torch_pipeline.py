"""PyTorch port: the pipelined folder sweep, ``exact_float32`` across
threads, and the gather at patch sizes other than 32, on the CPU.

- ``folder_pipeline = True`` (tests/test_engine.py:180-300 for the JAX
  package): the files equal the serial sweep's, byte for byte in their
  arrays; a failing write surfaces from ``segment_folder``; a failing scan
  drains the queued writes, reports their error and re-raises its own;
  ``_BoundedWriter`` holds at most ``max_inflight`` writes.
- ``exact_float32``: two threads inside at once keep both TF32 flags off
  until the last one leaves, which restores the caller's flags, in either
  exit order.
- The gather at patch 40: the kernel is taken by device and patch size
  alone (32 on a CUDA device), and the plain subject-stack gather reads
  border windows as the JAX package's jnp gather does (a negative index
  wraps, one past the end clamps).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subcort_tpu.engine.train import \
    gather_triplanar_subjects as jax_gather_subjects
from subcort_tpu.io import NiftiImage, load_nii, save_nii
from subcort_tpu.models import init_params as jax_init_params
from subcort_tpu.ops.patches import gather_triplanar as jax_gather
from subcort_tpu_torch import config
from subcort_tpu_torch.config import Options, exact_float32
from subcort_tpu_torch.engine import SegmentationEngine
from subcort_tpu_torch.engine import infer
from subcort_tpu_torch.models import params_from_jax
from subcort_tpu_torch.ops import gather_kernel
from subcort_tpu_torch.ops.gather_kernel import (gather_triplanar_cuda,
                                                 prepare_gather_volume,
                                                 takes_kernel)
from subcort_tpu_torch.ops.patches import pad_volume

torch.set_num_threads(1)

SUBJECTS = ("s1", "s2", "s3")


@pytest.fixture(scope="module")
def params():
    return params_from_jax(jax_init_params(jax.random.key(7)))


@pytest.fixture()
def phantom(rng):
    """tests/test_torch_engine.py's phantom: a few hundred candidates."""
    image = (rng.random((36, 40, 32)) * 800 + 100).astype(np.int16)
    image[:4] = 0
    atlas = rng.random((36, 40, 32, 15)).astype(np.float32)
    atlas /= atlas.sum(axis=-1, keepdims=True)
    mask = np.zeros((36, 40, 32), np.uint8)
    mask[16:20, 18:22, 14:18] = 1
    return image, atlas, mask


def _write_folder(root, image, atlas, mask, names=SUBJECTS):
    for i, s in enumerate(names):
        sub = root / s
        (sub / "tmp").mkdir(parents=True)
        # each subject its own scan, so a mix-up between scans shows
        save_nii(NiftiImage(np.roll(image, i, axis=0)), str(sub / "T1.nii.gz"))
        save_nii(NiftiImage(atlas),
                 str(sub / "tmp" / "MNI_sub_probabilities.nii.gz"))
        save_nii(NiftiImage(mask),
                 str(sub / "tmp" / "MNI_subcortical_mask.nii.gz"))


def _options(root, **kw):
    base = dict(test_folder=str(root), mode="cpu", post_process=True,
                out_probabilities=True, crop=True, debug=False,
                net_verbose=0, dilate_crop_iters=2, test_batch_size=256)
    base.update(kw)
    return Options(**base)


@pytest.mark.parametrize("cc_backend", ["scipy", "device"])
def test_folder_sweep_pipelined_matches_serial(params, phantom, tmp_path,
                                               cc_backend):
    image, atlas, mask = phantom
    for mode in ("pipe", "serial"):
        _write_folder(tmp_path / mode, image, atlas, mask)
        opts = _options(tmp_path / mode, folder_pipeline=(mode == "pipe"),
                        cc_backend=cc_backend)
        times = SegmentationEngine(params, opts).segment_folder()
        assert set(times) == set(SUBJECTS)
    for s in SUBJECTS:
        for f in ("out_subcortical_prob.nii.gz",
                  "out_subcortical_seg_prec.nii.gz"):
            a = load_nii(str(tmp_path / "pipe" / s / f))
            b = load_nii(str(tmp_path / "serial" / s / f))
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.affine, b.affine)
        assert (load_nii(str(tmp_path / "pipe" / s /
                             "out_subcortical_seg_prec.nii.gz")).data
                != 0).any()


def test_folder_sweep_pipelined_prefetches_on_another_thread(
        params, phantom, tmp_path, monkeypatch):
    """Every scan after the first is loaded by the loader thread while the
    main thread segments: registration on a priors miss runs there."""
    image, atlas, mask = phantom
    _write_folder(tmp_path, image, atlas, mask)
    real_load = infer._load_scan_inputs
    threads = {}

    def load(path, *a, **k):
        threads[path] = threading.get_ident()
        return real_load(path, *a, **k)

    monkeypatch.setattr(infer, "_load_scan_inputs", load)
    opts = _options(tmp_path, folder_pipeline=True, post_process=False,
                    out_probabilities=False)
    SegmentationEngine(params, opts).segment_folder()
    assert len(threads) == 3
    assert threading.get_ident() not in threads.values()


def test_folder_sweep_pipelined_surfaces_write_errors(params, phantom,
                                                      tmp_path, monkeypatch):
    image, atlas, mask = phantom
    _write_folder(tmp_path, image, atlas, mask, names=("s1", "s2"))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(infer, "save_nii", boom)
    opts = _options(tmp_path, folder_pipeline=True, post_process=False,
                    out_probabilities=False)
    with pytest.raises(OSError, match="disk full"):
        SegmentationEngine(params, opts).segment_folder()


def test_bounded_writer_backpressure_and_errors():
    """At most max_inflight deferred writes exist at once, and a failed
    write surfaces at the next submit, not only at drain."""
    gate = threading.Event()
    in_flight, peak = [], []

    def slow_write():
        in_flight.append(1)
        peak.append(len(in_flight))
        gate.wait(5)
        in_flight.pop()

    with ThreadPoolExecutor(1) as pool:
        w = infer._BoundedWriter(pool, max_inflight=2)
        w.submit(slow_write)
        w.submit(slow_write)
        t = threading.Thread(target=w.submit, args=(slow_write,))
        t.start()
        t.join(0.3)
        assert t.is_alive(), "a third submit blocks at max_inflight=2"
        gate.set()
        t.join(5)
        assert not t.is_alive()
        w.drain()
    assert max(peak) <= 2

    def boom():
        raise OSError("disk full")

    with ThreadPoolExecutor(1) as pool:
        w = infer._BoundedWriter(pool, max_inflight=1)
        w.submit(boom)
        with pytest.raises(OSError, match="disk full"):
            w.submit(boom)  # backpressure waits on the failed oldest write
        w.futures.clear()


def test_folder_sweep_scan_error_surfaces_pending_writes(params, phantom,
                                                         tmp_path, capsys,
                                                         monkeypatch):
    """The third scan's prefetch fails while the first scan's write has
    failed too: the queued write is drained and reported, and the scan's
    own error is the one raised."""
    image, atlas, mask = phantom
    _write_folder(tmp_path, image, atlas, mask)
    real_load = infer._load_scan_inputs

    def bad_write(*a, **k):
        raise OSError("disk full")

    def failing_load(path, *a, **k):
        if "s3" in path:
            raise RuntimeError("registration exploded")
        return real_load(path, *a, **k)

    monkeypatch.setattr(infer, "save_nii", bad_write)
    monkeypatch.setattr(infer, "_load_scan_inputs", failing_load)
    opts = _options(tmp_path, folder_pipeline=True, post_process=False,
                    out_probabilities=False)
    with pytest.raises(RuntimeError, match="registration exploded"):
        SegmentationEngine(params, opts).segment_folder()
    assert "a deferred output write failed" in capsys.readouterr().out


# ------------------------------------------------------------ exact_float32
def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("first_out", ["a", "b"])
@pytest.mark.parametrize("caller", [(True, True), (True, False),
                                    (False, True)])
def test_exact_float32_across_two_threads(first_out, caller):
    """Thread a enters, then b; one leaves, then the other. TF32 stays off
    while either is inside, and the caller's flags come back only when
    both have left."""
    saved = _flags()
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.allow_tf32, matmul.allow_tf32 = caller
    entered = {k: threading.Event() for k in "ab"}
    leave = {k: threading.Event() for k in "ab"}
    left = {k: threading.Event() for k in "ab"}
    seen = {}

    def worker(name):
        with exact_float32():
            seen[name + " in"] = _flags()
            entered[name].set()
            leave[name].wait(5)
        left[name].set()

    try:
        threads = {k: threading.Thread(target=worker, args=(k,))
                   for k in "ab"}
        threads["a"].start()
        assert entered["a"].wait(5)
        threads["b"].start()
        assert entered["b"].wait(5)
        assert _flags() == (False, False)
        second = "b" if first_out == "a" else "a"
        leave[first_out].set()
        assert left[first_out].wait(5)
        assert _flags() == (False, False), "one thread is still inside"
        leave[second].set()
        assert left[second].wait(5)
        for t in threads.values():
            t.join(5)
        assert seen == {"a in": (False, False), "b in": (False, False)}
        assert _flags() == caller
        assert config._FLOAT32_DEPTH == 0
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_exact_float32_stress():
    """More threads than cores entering and leaving at random, with a
    shortened switch interval: every thread inside always sees TF32 off,
    and the caller's flags come back once all have left."""
    import random
    import sys

    saved, interval = _flags(), sys.getswitchinterval()
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    bad = []

    def worker(seed):
        rnd = random.Random(seed)
        for _ in range(200):
            with exact_float32():
                for _ in range(rnd.randrange(3)):
                    if _flags() != (False, False):
                        bad.append(_flags())

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not bad
        assert _flags() == (True, False)
        assert config._FLOAT32_DEPTH == 0
    finally:
        sys.setswitchinterval(interval)
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_exact_float32_nested_and_on_error():
    saved = _flags()
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.allow_tf32, matmul.allow_tf32 = True, True
    try:
        with pytest.raises(KeyError):
            with exact_float32():
                with exact_float32():
                    assert _flags() == (False, False)
                assert _flags() == (False, False)
                raise KeyError("inside")
        assert _flags() == (True, True)
        assert config._FLOAT32_DEPTH == 0
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


# ------------------------------------------------------------ patch != 32
@pytest.mark.parametrize("patch", [16, 24, 32, 40, 48])
def test_kernel_branch_is_chosen_by_patch_size_alone(patch):
    """On a CUDA device only the 32x32 windows take the kernel; every other
    patch size takes the plain version there (the JAX package's
    ``use_pallas`` rule); the CPU always takes the plain version."""
    assert takes_kernel(torch.device("cuda", 0), patch) == (patch == 32)
    assert takes_kernel(torch.device("cuda", 1), patch) == (patch == 32)
    assert not takes_kernel(torch.device("cpu"), patch)


def _border_centers(rng, shape, n=40):
    """Random centers plus 0 and the last index on each axis, in every
    combination."""
    corners = [[x, y, z] for x in (0, shape[0] - 1)
               for y in (0, shape[1] - 1) for z in (0, shape[2] - 1)]
    rand = np.stack([rng.integers(0, s, n) for s in shape], 1)
    return np.concatenate([rand, corners]).astype(np.int32)


@pytest.mark.parametrize("patch", [16, 32, 40])
def test_subject_gather_matches_jax_at_the_borders(rng, patch):
    """gather_triplanar_cuda on the CPU (a GatherVolume, so the plain
    version reads ``padded()``) at patch 40 equals the JAX package's jnp
    gather on border centers, where the window starts at padded c - 4 and
    ends past the padded extent; no launch is counted."""
    shape = (20, 23, 18)
    vols = rng.standard_normal((2,) + tuple(s + 32 for s in shape))
    vols = vols.astype(np.float32)
    c3 = _border_centers(rng, shape)
    centers = np.concatenate(
        [rng.integers(0, 2, (len(c3), 1)), c3], 1).astype(np.int32)
    want = jax_gather_subjects(jnp.asarray(vols), jnp.asarray(centers),
                               patch=patch)
    before = gather_kernel.LAUNCHES
    got = gather_triplanar_cuda(prepare_gather_volume(torch.from_numpy(vols)),
                                torch.from_numpy(centers), patch)
    assert gather_kernel.LAUNCHES == before
    for g, w in zip(got, want):
        assert g.shape == (len(centers), patch, patch)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("patch", [32, 40])
def test_single_volume_gather_matches_jax_at_the_borders(rng, patch):
    shape = (20, 23, 18)
    vol = rng.standard_normal(shape).astype(np.float32)
    centers = _border_centers(rng, shape)
    padded = pad_volume(torch.from_numpy(vol))
    want = jax_gather(jnp.asarray(padded.numpy()), jnp.asarray(centers),
                      patch=patch)
    got = gather_triplanar_cuda(padded, torch.from_numpy(centers), patch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pipelined", [False, True])
def test_segment_folder_hands_out_the_raw_labels(params, phantom, tmp_path,
                                                 pipelined):
    """``segment_folder(on_raw_labels=...)`` hands each subject's raw
    labels to the hook on the calling thread, serial or pipelined: the
    written post-processed labels are their post-process against the
    subject's mask, and with ``post_process`` off the written raw labels
    are them."""
    from subcort_tpu_torch.engine.postprocess import \
        post_process_segmentation

    image, atlas, mask = phantom
    for post in (True, False):
        root = tmp_path / f"post{int(post)}"
        _write_folder(root, image, atlas, mask)
        got, threads = {}, set()

        def keep(subject, labels):
            got[subject] = labels.copy()
            threads.add(threading.get_ident())

        opts = _options(root, folder_pipeline=pipelined, post_process=post,
                        out_probabilities=False)
        SegmentationEngine(params, opts).segment_folder(on_raw_labels=keep)
        assert sorted(got) == list(SUBJECTS)
        assert threads == {threading.get_ident()}
        for s in SUBJECTS:
            if post:
                written = load_nii(str(root / s /
                                       "out_subcortical_seg_prec.nii.gz"))
                want = post_process_segmentation(None, got[s],
                                                 atlas_mask=mask,
                                                 cc_backend="scipy")
            else:
                written = load_nii(str(root / s /
                                       "out_subcortical_rawseg.nii.gz"))
                want = got[s]
            np.testing.assert_array_equal(written.data, want)
        assert any((got[s] != 0).any() for s in SUBJECTS)
