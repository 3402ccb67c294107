"""PyTorch port: inference over several devices from one process
(``segment_volume(devices=...)``: the patch engine's parts and the dense
engine's sub-slabs dealt over ``DeviceWorkers``), against the
port's own single-device run and the JAX package's multi-device run on its
8 virtual CPU devices (tests/conftest.py), in the style of
tests/test_parallel.py.

A list of k CPU devices (the CPU repeated) stands for k devices: every
entry gets a host thread of its own, as a card does. The same seeded numpy
inputs and the same params (the JAX package's ``init_params`` of a narrow
net, bridged by ``params_from_jax``) go through both packages. Tolerances:
labels bit-equal, multi-device vs one device and port vs JAX; float32
probabilities within 1e-5 absolute (summation order only, as
tests/test_torch_fcn.py and tests/test_parallel.py hold them); the raw
int16 case's uint8 probabilities within one 1/255 step.
"""

import numpy as np
import pytest
import jax
import torch

from subcort_tpu.config import Options as JaxOptions
from subcort_tpu.engine import infer as jax_infer
from subcort_tpu.engine import segment_volume as jax_segment_volume
from subcort_tpu.models import init_params as jax_init_params
from subcort_tpu.models.triplanar import TriPlanarSpec as JaxSpec
from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine import infer, segment_volume
from subcort_tpu_torch.engine.infer import (SegmentationEngine,
                                            _data_parallel_devices)
from subcort_tpu_torch.engine import test_scan as port_test_scan
from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii
from subcort_tpu_torch.models import (TriPlanarNet, TriPlanarSpec, fcn,
                                      params_from_jax)
from subcort_tpu_torch.parallel.mesh import shard_rows

torch.set_num_threads(1)

NARROW = dict(conv_filters=(8, 8, 8, 8, 8), fc_conv=16, fc_fc=16, fc2=16)
SPEC = TriPlanarSpec(**NARROW)
JAX_SPEC = JaxSpec(**NARROW)
CPU = torch.device("cpu")
PROBS_ATOL = 1e-5
STEP = 1.0 / 255 + 1e-6


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax.random.key(2), JAX_SPEC)


@pytest.fixture(scope="module")
def net(jax_params):
    return TriPlanarNet.from_params(params_from_jax(jax_params, SPEC), SPEC,
                                    CPU)


def _scan(seed, shape=(30, 34, 28), n=800, dtype=np.float32):
    """A raw scan, its prior atlas and unique random candidates."""
    rng = np.random.default_rng(seed)
    image = (rng.random(shape) * 800 + 100).astype(dtype)
    atlas = rng.random(shape + (15,)).astype(np.float32)
    centers = np.unique(np.stack([rng.integers(0, s, n) for s in shape],
                                 1).astype(np.int32), axis=0)
    return image, atlas, centers


def _sel(centers):
    return centers[:, 0], centers[:, 1], centers[:, 2]


def _holding(centers, bboxes) -> int:
    """How many of the (lo, dims) ``bboxes`` hold a candidate."""
    return sum(bool(np.all((centers >= lo) & (centers < lo + np.asarray(d)),
                           axis=1).any()) for lo, d in bboxes)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_patch_engine_over_devices_matches_one_device_and_jax(
        net, jax_params, k, monkeypatch):
    """The patch engine over k devices: one contiguous part of whole
    chunks per device; labels equal the single device's and JAX's over
    ``jax.devices()[:k]``. 790 candidates in chunks of 64: not a multiple
    of k x chunk."""
    image, atlas, centers = _scan(k, shape=(26, 30, 24), n=800)
    assert len(centers) % (k * 64)
    parts = []
    real = infer.forward_centers
    monkeypatch.setattr(infer, "forward_centers",
                        lambda net, vol, c, *a, **kw: parts.append(len(c))
                        or real(net, vol, c, *a, **kw))
    kw = dict(want_probs=True, engine="patch", chunk=64,
              probs_dtype=np.float32)
    one_l, one_p = segment_volume(net, image, atlas, centers, **kw)
    assert parts == [len(centers)]  # one device: one part
    parts.clear()
    got_l, got_p = segment_volume(net, image, atlas, centers,
                                  devices=[CPU] * k, **kw)
    want = [s.stop - s.start
            for s in shard_rows(len(centers), k, align=64)]
    if k == 1:
        # a one-entry list is the single-device path
        assert parts == [len(centers)]
    else:
        assert sorted(parts) == sorted(p for p in want if p)
        assert all(p % 64 == 0 for p in want[:-1])
    np.testing.assert_array_equal(got_l, one_l)
    np.testing.assert_allclose(got_p, one_p, rtol=0, atol=PROBS_ATOL)
    jax_l, jax_p = jax_segment_volume(jax_params, image, atlas, centers,
                                      spec=JAX_SPEC,
                                      devices=jax.devices()[:k], **kw)
    np.testing.assert_array_equal(got_l, jax_l)
    np.testing.assert_allclose(got_p, jax_p, rtol=0, atol=PROBS_ATOL)


@pytest.mark.parametrize("fcn_spmd", [True, False])
@pytest.mark.parametrize("case", ["float32", "int16"])
def test_dense_engine_over_devices_matches_one_device_and_jax(
        net, jax_params, fcn_spmd, case):
    """The dense evaluator over 4 devices, one sub-slab each (fcn_spmd)
    or sub-bboxes dealt round-robin: labels equal the single device's and
    JAX's. int16: the raw slab, uint16 priors and uint8 probs."""
    dtype = np.int16 if case == "int16" else np.float32
    image, atlas, centers = _scan(5, dtype=dtype)
    kw = (dict(prior_dtype=np.uint16, probs_dtype=np.uint8) if case == "int16"
          else dict(prior_dtype=np.float32, probs_dtype=np.float32))
    kw.update(want_probs=True, engine="fcn")
    atol = STEP if case == "int16" else PROBS_ATOL
    sel = _sel(centers)
    one_l, one_p = segment_volume(net, image, atlas, centers, **kw)
    lo, dims = infer._bbox_of(centers, image.shape)
    subs = (infer.spmd_sub_bboxes(lo, dims, 4) if fcn_spmd else list(
        infer._split_bbox(lo, dims, -(-int(np.prod(dims)) // 4))))
    before = fcn.SLABS
    got_l, got_p = segment_volume(net, image, atlas, centers,
                                  devices=[CPU] * 4, fcn_spmd=fcn_spmd, **kw)
    assert fcn.SLABS - before == _holding(centers, subs) >= 4
    np.testing.assert_array_equal(got_l, one_l)
    np.testing.assert_allclose(got_p[sel], one_p[sel], rtol=0, atol=atol)
    jax_l, jax_p = jax_segment_volume(jax_params, image, atlas, centers,
                                      spec=JAX_SPEC,
                                      devices=jax.devices()[:4],
                                      fcn_spmd=fcn_spmd, **kw)
    np.testing.assert_array_equal(got_l, jax_l)
    np.testing.assert_allclose(got_p[sel], jax_p[sel], rtol=0, atol=atol)


def test_dense_spmd_shards_without_candidates_run_nothing(net, jax_params):
    """Candidates clustered in a corner (tests/test_parallel.py:293): of
    the 4 sub-slabs along the bbox's largest axis, those without a
    candidate run no slab, and the labels equal the single device's and
    JAX's."""
    rng = np.random.default_rng(7)
    image = (rng.random((40, 36, 28)) * 800 + 100).astype(np.float32)
    atlas = rng.random((40, 36, 28, 15)).astype(np.float32)
    centers = np.unique(rng.integers(0, 5, (60, 3)).astype(np.int32), axis=0)
    kw = dict(engine="fcn", prior_dtype=np.float32)
    one_l, _ = segment_volume(net, image, atlas, centers, **kw)
    lo, dims = infer._bbox_of(centers, image.shape)
    holding = _holding(centers, infer.spmd_sub_bboxes(lo, dims, 4))
    assert holding < 4
    before = fcn.SLABS
    got_l, _ = segment_volume(net, image, atlas, centers, devices=[CPU] * 4,
                              **kw)
    assert fcn.SLABS - before == holding
    np.testing.assert_array_equal(got_l, one_l)
    jax_l, _ = jax_segment_volume(jax_params, image, atlas, centers,
                                  spec=JAX_SPEC, devices=jax.devices()[:4],
                                  **kw)
    np.testing.assert_array_equal(got_l, jax_l)


def test_slab_count_holds_under_many_threads(net):
    """16 device threads, more than the cores here, with a short switch
    interval: the dense fan-out counts every slab (the counters take a
    lock) and the labels equal one device's."""
    import sys

    image, atlas, centers = _scan(11, shape=(36, 30, 28), n=1200)
    kw = dict(engine="fcn", prior_dtype=np.float32, fcn_max_bbox_voxels=600)
    one_l, _ = segment_volume(net, image, atlas, centers, **kw)
    lo, dims = infer._bbox_of(centers, image.shape)
    cap = min(600, -(-int(np.prod(dims)) // 16))
    want = _holding(centers, infer._split_bbox(lo, dims, cap))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = fcn.SLABS
        got_l, _ = segment_volume(net, image, atlas, centers,
                                  devices=[CPU] * 16, fcn_spmd=False, **kw)
        assert fcn.SLABS - before == want > 16
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_array_equal(got_l, one_l)


def _record_slabs(monkeypatch, module, name, at):
    """Record the (lo, dims) of every sub-bbox ``module``'s ``name`` is
    asked to cut, from its arguments at ``at`` and ``at + 1``."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kw):
        seen.append((tuple(int(v) for v in args[at]),
                     tuple(int(v) for v in args[at + 1])))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("fcn_spmd", [True, False])
def test_split_geometry_matches_jax(net, jax_params, monkeypatch, fcn_spmd):
    """The sub-bboxes cut over 3 devices, within an outer split (spmd: 3 x
    ``fcn_max_bbox_voxels`` a piece) or capped at ``ceil(bbox voxels /
    3)`` (the host fan-out), equal the JAX package's (the port cuts them
    on the devices' threads, in no fixed order)."""
    image, atlas, centers = _scan(9, shape=(40, 34, 28), n=1500)
    kw = dict(engine="fcn", prior_dtype=np.float32,
              fcn_max_bbox_voxels=4000)
    mine = _record_slabs(monkeypatch, infer, "_fcn_slab", 2)
    theirs = _record_slabs(monkeypatch, jax_infer, "_fcn_slab_inputs", 3)
    got_l, _ = segment_volume(net, image, atlas, centers, devices=[CPU] * 3,
                              fcn_spmd=fcn_spmd, **kw)
    jax_l, _ = jax_segment_volume(jax_params, image, atlas, centers,
                                  spec=JAX_SPEC, devices=jax.devices()[:3],
                                  fcn_spmd=fcn_spmd, **kw)
    assert len(mine) > 3 and sorted(mine) == sorted(theirs)
    np.testing.assert_array_equal(got_l, jax_l)


def test_data_parallel_devices_clamps_with_a_note(capsys):
    """``[tpu] data_parallel`` maps to ``mode``'s devices, clamped to what
    exists with the JAX package's note under ``net_verbose``: the CPU is
    one device. 1 is the single-device path (None)."""
    assert _data_parallel_devices(Options(mode="cpu")) is None
    assert _data_parallel_devices(
        Options(mode="cpu", data_parallel=2, net_verbose=0)) == [CPU]
    assert capsys.readouterr().out == ""
    assert _data_parallel_devices(
        Options(mode="cpu", data_parallel=2, net_verbose=1)) == [CPU]
    note = capsys.readouterr().out
    jax_infer._data_parallel_devices(
        JaxOptions(data_parallel=16, net_verbose=1))
    assert note == capsys.readouterr().out.replace("16", "2").replace(
        "only 8", "only 1")
    if not torch.cuda.is_available():
        # a card that mode names and that is absent raises, as
        # select_device does
        with pytest.raises(RuntimeError, match="(?i)cuda"):
            _data_parallel_devices(Options(mode="cuda0", data_parallel=2))


@pytest.mark.parametrize("fcn_spmd", [True, False])
def test_test_scan_over_devices_reads_fcn_spmd(net, tmp_path, monkeypatch,
                                               fcn_spmd):
    """``test_scan`` over two devices writes the files of the single-device
    run, and ``[tpu] fcn_spmd`` picks the dense split."""
    image, atlas, _ = _scan(3, shape=(36, 40, 32))
    mask = np.zeros(image.shape, np.uint8)
    mask[16:20, 18:22, 14:18] = 1
    sub = tmp_path / "s0"
    (sub / "tmp").mkdir(parents=True)
    save_nii(NiftiImage(image), str(sub / "T1.nii.gz"))
    save_nii(NiftiImage(atlas), str(sub / "tmp" / "MNI_sub_probabilities.nii.gz"))
    save_nii(NiftiImage(mask), str(sub / "tmp" / "MNI_subcortical_mask.nii.gz"))
    options = Options(mode="cpu", post_process=True, out_probabilities=True,
                      crop=True, debug=False, net_verbose=0,
                      dilate_crop_iters=2, fcn_spmd=fcn_spmd)
    outputs = ("out_subcortical_seg_prec.nii.gz", "out_subcortical_prob.nii.gz")
    port_test_scan(net, str(sub / "T1.nii.gz"), options)
    want = [load_nii(str(sub / name)).data for name in outputs]
    calls = []
    real = infer.spmd_sub_bboxes
    monkeypatch.setattr(infer, "spmd_sub_bboxes",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    port_test_scan(net, str(sub / "T1.nii.gz"), options, devices=[CPU, CPU])
    assert bool(calls) == fcn_spmd
    for name, w in zip(outputs, want):
        np.testing.assert_array_equal(load_nii(str(sub / name)).data, w)


def test_engine_with_data_parallel_holds_its_devices():
    """``SegmentationEngine`` takes its device list from ``data_parallel``
    once (clamped here to the one CPU)."""
    params = params_from_jax(jax_init_params(jax.random.key(3), JAX_SPEC),
                             SPEC)
    engine = SegmentationEngine(params, Options(mode="cpu", data_parallel=3,
                                                net_verbose=0), SPEC)
    assert engine.devices == [CPU]
    engine = SegmentationEngine(params, Options(mode="cpu"), SPEC)
    assert engine.devices is None
