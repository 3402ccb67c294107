"""PyTorch port: the program's spans (``utils/runtime.py``) on the CPU.

- Off (no profiler, no ``recording()``): ``segment_volume`` and a tiny
  ``Trainer.fit`` leave no record, and their outputs equal the
  recording-on outputs bit for bit.
- On: the dense and the patch ``segment_volume`` give the span tree of
  PERF.md §3 under one request id, each child inside its parent, self
  times summing to the root; over two devices the workers' spans carry
  the call's request. ``test_scan`` and the pipelined folder sweep put a
  scan's load, candidates, segmentation and write under its subject, on
  whichever thread runs them. A fit gives one ``train.call`` and one
  ``train.loss_readback`` per call, one ``train.validation`` and one
  ``train.checkpoint`` per epoch with writes.
- Under a CPU ``torch.profiler`` each record is a user annotation of its
  name whose start and end lie within 1 ms of the record's: one clock.
- The buffer drops its oldest records and counts them; spans of two
  threads keep their own parents.
"""

import threading

import numpy as np
import pytest
import torch
from scipy import ndimage

from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine import SegmentationEngine
from subcort_tpu_torch.engine.data import TrainingIndex
from subcort_tpu_torch.engine.infer import segment_volume, test_scan
from subcort_tpu_torch.engine.train import Trainer
from subcort_tpu_torch.io import NiftiImage, save_nii
from subcort_tpu_torch.models import TriPlanarNet, TriPlanarSpec
from subcort_tpu_torch.models.triplanar import init_params
from subcort_tpu_torch.ops.sampling import get_mask_voxels
from subcort_tpu_torch.utils import runtime
from subcort_tpu_torch.utils.runtime import (recording, records,
                                             self_seconds, span)

torch.set_num_threads(1)

CPU = torch.device("cpu")
NARROW = dict(conv_filters=(8, 8, 8, 8, 8), fc_conv=16, fc_fc=16, fc2=16)
SPEC = TriPlanarSpec(**NARROW, dropout_conv=0.0, dropout_fc=0.0)
SLAB = ("infer.slab_inputs", "infer.upload", "infer.forward",
        "infer.readback", "infer.scatter")
STAGES = {"fcn": {"infer.prepare", *SLAB},
          "patch": {"infer.prepare", *SLAB[1:]}}


@pytest.fixture(autouse=True)
def empty_buffer():
    runtime.clear_records()
    yield
    runtime.clear_records()


@pytest.fixture(scope="module")
def net():
    params = init_params(SPEC, torch.Generator().manual_seed(5))
    return TriPlanarNet.from_params(params, SPEC, CPU)


@pytest.fixture(scope="module")
def phantom():
    """A 36x40x32 int16 scan, normalized priors and the candidates of a
    small ROI dilated twice (a few hundred)."""
    rng = np.random.default_rng(11)
    image = (rng.random((36, 40, 32)) * 800 + 100).astype(np.int16)
    image[:4] = 0
    atlas = rng.random((36, 40, 32, 15)).astype(np.float32)
    atlas /= atlas.sum(axis=-1, keepdims=True)
    mask = np.zeros((36, 40, 32), np.uint8)
    mask[16:20, 18:22, 14:18] = 1
    centers = get_mask_voxels(ndimage.binary_dilation(mask, iterations=2))
    return image, atlas, mask, centers


def _segment(net, phantom, engine, **kw):
    image, atlas, _, centers = phantom
    return segment_volume(net, image, atlas, centers, want_probs=True,
                          engine=engine, chunk=256, **kw)


def _by_id(recs):
    return {r.id: r for r in recs}


def _check_tree(recs, root_name):
    """One root named ``root_name``; every record under it by its parents,
    of its request, inside its parent's interval; self times summing to the
    root's duration. Returns the root."""
    ids = _by_id(recs)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [root_name]
    root = roots[0]
    for r in recs:
        assert r.request == root.request, r.name
        if r.parent is not None:
            p = ids[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, r.name
    assert sum(self_seconds(recs).values()) == pytest.approx(
        root.duration_ns * 1e-9, rel=1e-9)
    return root


def _tiny_fit(tmp_path, name, max_epochs=2):
    rng = np.random.default_rng(0)
    extent, n, subjects = (20, 22, 18), 96, 2
    vols = rng.standard_normal(
        (subjects,) + tuple(e + 32 for e in extent)).astype(np.float32)
    centers = np.stack([rng.integers(0, subjects, n)]
                       + [rng.integers(0, e, n) for e in extent],
                       1).astype(np.int32)
    index = TrainingIndex(vols, centers,
                          rng.integers(0, 15, n).astype(np.int32),
                          rng.random((n, 15)).astype(np.float32),
                          [f"s{i}" for i in range(subjects)])
    opts = Options(experiment=name, batch_size=16, max_epochs=max_epochs,
                   patience=10, train_split=0.25, net_verbose=0,
                   load_weights=False, seed=3, mode="cpu")
    tr = Trainer(opts, spec=TriPlanarSpec(**NARROW),
                 weights_path=str(tmp_path / "nets"),
                 params=init_params(SPEC, torch.Generator().manual_seed(5)),
                 steps_per_call=2)
    return tr, tr.fit(index)


@pytest.mark.parametrize("engine", ["fcn", "patch"])
def test_off_segment_volume_records_nothing_and_equals_on(net, phantom,
                                                         engine):
    assert span("infer.prepare") is runtime._OFF
    off = _segment(net, phantom, engine)
    assert records() == [] and runtime.dropped() == 0
    with recording():
        on = _segment(net, phantom, engine)
    assert records()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def test_off_fit_records_nothing_and_equals_on(tmp_path):
    tr_off, hist_off = _tiny_fit(tmp_path, "off")
    assert records() == []
    with recording():
        tr_on, hist_on = _tiny_fit(tmp_path, "on")
    assert records()
    assert [{k: v for k, v in h.items() if k != "dur"} for h in hist_off] \
        == [{k: v for k, v in h.items() if k != "dur"} for h in hist_on]
    for k, v in tr_off.params.items():
        assert torch.equal(v, tr_on.params[k]), k


@pytest.mark.parametrize("engine", ["fcn", "patch"])
def test_segment_volume_span_tree(net, phantom, engine):
    """One request, the stages of PERF.md §3 under the root, the upload's
    and readback's bytes, the slab's prior rows."""
    with recording():
        _segment(net, phantom, engine)
    recs = records()
    root = _check_tree(recs, "infer.segment_volume")
    names = {r.name for r in recs} - {"infer.segment_volume"}
    assert names == STAGES[engine]
    assert all(r.parent == root.id for r in recs if r is not root)
    centers = phantom[3]
    upload = sum(r.attrs["bytes"] for r in recs if r.name == "infer.upload")
    readback = sum(r.attrs["bytes"] for r in recs
                   if r.name == "infer.readback")
    # labels one byte a candidate, uint8 probabilities 15
    assert readback >= 16 * len(centers) and upload > 4 * len(centers)
    if engine == "fcn":
        rows = [r.attrs["rows"] for r in recs if r.name == "infer.slab_inputs"]
        assert sum(rows) >= len(centers)


@pytest.mark.parametrize("engine", ["fcn", "patch"])
def test_segment_volume_workers_carry_the_request(net, phantom, engine):
    """Over two device entries the workers' spans are roots of their
    threads, of the call's request; the labels equal one device's."""
    want = _segment(net, phantom, engine)
    with recording():
        got = _segment(net, phantom, engine, devices=[CPU, CPU])
    np.testing.assert_array_equal(got[0], want[0])
    recs = records()
    (root,) = [r for r in recs if r.name == "infer.segment_volume"]
    assert {r.request for r in recs} == {root.request}
    workers = [r for r in recs if r.thread != root.thread]
    assert {"infer.upload", "infer.forward", "infer.readback"} <= \
        {r.name for r in workers}
    ids = _by_id(recs)
    for r in workers:
        # a root of its thread, or under one of that thread's spans
        assert r.parent is None or ids[r.parent].thread == r.thread


def _write_subject(root, name, phantom):
    image, atlas, mask, _ = phantom
    sub = root / name
    (sub / "tmp").mkdir(parents=True)
    save_nii(NiftiImage(image), str(sub / "T1.nii.gz"))
    save_nii(NiftiImage(atlas),
             str(sub / "tmp" / "MNI_sub_probabilities.nii.gz"))
    save_nii(NiftiImage(mask),
             str(sub / "tmp" / "MNI_subcortical_mask.nii.gz"))


def _scan_options(root, **kw):
    return Options(test_folder=str(root), mode="cpu", post_process=True,
                   crop=True, debug=False, net_verbose=0, dilate_crop_iters=2,
                   test_batch_size=256, **kw)


def test_test_scan_spans_under_the_subject(net, phantom, tmp_path):
    _write_subject(tmp_path, "s7", phantom)
    with recording():
        test_scan(net, str(tmp_path / "s7" / "T1.nii.gz"),
                  _scan_options(tmp_path))
    recs = records()
    root = _check_tree(recs, "infer.scan")
    assert root.request == "s7"
    ids = _by_id(recs)
    children = [r.name for r in sorted(recs, key=lambda r: r.start_ns)
                if r.parent == root.id]
    assert children == ["infer.load", "infer.candidates",
                        "infer.segment_volume", "infer.write"]
    assert {ids[r.parent].name for r in recs
            if r.name == "infer.prepare"} == {"infer.segment_volume"}


def test_pipelined_sweep_loads_and_writes_under_each_subject(tmp_path):
    """The loader and writer threads' spans carry their scan's subject."""
    rng = np.random.default_rng(11)
    image = (rng.random((36, 40, 32)) * 800 + 100).astype(np.int16)
    atlas = rng.random((36, 40, 32, 15)).astype(np.float32)
    mask = np.zeros((36, 40, 32), np.uint8)
    mask[16:20, 18:22, 14:18] = 1
    for name in ("a1", "a2"):
        _write_subject(tmp_path, name, (image, atlas, mask, None))
    params = init_params(SPEC, torch.Generator().manual_seed(5))
    engine = SegmentationEngine(params, _scan_options(
        tmp_path, folder_pipeline=True), SPEC)
    main = threading.get_ident()
    with recording():
        engine.segment_folder()
    recs = records()
    for name in ("a1", "a2"):
        mine = {r.name: r for r in recs if r.request == name}
        assert {"infer.scan", "infer.load", "infer.candidates",
                "infer.segment_volume", "infer.write"} <= set(mine)
        assert mine["infer.scan"].thread == main
        assert mine["infer.load"].thread != main
        assert mine["infer.write"].thread != main
        assert mine["infer.load"].thread != mine["infer.write"].thread


def test_fit_spans(tmp_path):
    """2 epochs of 4 steps (67 rows at batch 16) at 2 steps a call: per
    epoch one train.rows, two calls each with its read-back, one
    validation and one checkpoint (this process writes), all under the
    epoch's span."""
    with recording():
        tr, _ = _tiny_fit(tmp_path, "spans")
    recs = records()
    ids = _by_id(recs)
    epochs = [r for r in recs if r.name == "train.epoch"]
    assert [r.request for r in epochs] == ["epoch1", "epoch2"]
    for ep in epochs:
        kids = sorted((r for r in recs if r.parent == ep.id),
                      key=lambda r: r.start_ns)
        assert [r.name for r in kids] == [
            "train.rows", "train.call", "train.loss_readback",
            "train.call", "train.loss_readback", "train.validation",
            "train.checkpoint"]
        assert [r.attrs["steps"] for r in kids
                if r.name == "train.call"] == [2, 2]
        assert all(r.request == ep.request for r in kids)
    ck = [r for r in recs if r.name == "train.checkpoint"]
    assert all(r.attrs["bytes"] > 0 for r in ck)
    assert all(ids[r.parent].name == "train.epoch" for r in recs
               if r.parent is not None)
    # the stratified holdout: 29 of the 96 rows
    assert {r.attrs["rows"] for r in recs if r.name == "train.validation"} \
        == {29}


def _ns(event, what):
    fn = getattr(event, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(
        event, f"{what}_us")() * 1000)


def test_spans_share_the_profiler_clock(net, phantom):
    """A profiler on records the spans with no recording(), each one also
    a user annotation of its name within 1 ms of the record."""
    from torch.profiler import ProfilerActivity, profile

    # a process's first annotation pays a one-time set-up (about 1 ms on
    # the CPU) between the profiler's stamp and the record's
    with profile(activities=[ProfilerActivity.CPU]):
        with span("warm-up"):
            pass
    runtime.clear_records()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _segment(net, phantom, "fcn")
    recs = records()
    assert {r.name for r in recs} == {"infer.segment_volume",
                                      *STAGES["fcn"]}
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            start = _ns(e, "start")
            marks.setdefault(e.name(), []).append(
                (start, start + _ns(e, "duration")))
    for r in recs:
        a, b = min(marks[r.name], key=lambda ab: abs(ab[0] - r.start_ns))
        assert abs(a - r.start_ns) < 1_000_000, r.name
        assert abs(b - r.end_ns) < 1_000_000, r.name
    # the profiler gone, spans are off again
    assert span("infer.prepare") is runtime._OFF


def test_buffer_drops_oldest_first_and_counts():
    n = runtime.SPAN_CAPACITY
    with recording():
        for i in range(n + 3):
            with span("s", i=i):
                pass
    kept = records()
    assert len(kept) == n and runtime.dropped() == 3
    assert [r.attrs["i"] for r in (kept[0], kept[-1])] == [3, n + 2]


def test_two_threads_keep_their_own_parents():
    """Two threads nest spans at the same time: each child's parent is its
    own thread's span; a span given a request keeps it, its children
    inherit it."""
    both = threading.Barrier(2)

    def work(tag):
        with span(f"{tag}.outer", request=tag):
            both.wait()
            with span(f"{tag}.inner"):
                both.wait()

    with recording():
        threads = [threading.Thread(target=work, args=(t,))
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    ids = _by_id(records())
    for tag in ("a", "b"):
        (inner,) = [r for r in ids.values() if r.name == f"{tag}.inner"]
        outer = ids[inner.parent]
        assert outer.name == f"{tag}.outer" and outer.parent is None
        assert inner.thread == outer.thread
        assert inner.request == outer.request == tag
