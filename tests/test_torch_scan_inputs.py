"""PyTorch port: the dense scan's inputs derived on the device
(``ops/scan_inputs.py``), on the CPU through the kernels' plain versions.

Held bit-equal to the JAX package's host derivation: the moments give
``normalize_stats``' statistics and ``_bbox_of``'s bbox, and the prior
rows and indices those of its ``_fcn_slab_inputs``
(``_atlas_vectors_host`` and ``_quantize_priors``). ``segment_volume``,
which takes this one path for every scan, engine and device count, gives
the labels and probabilities of a forward over the JAX package's slab and
rows. ``tests/test_torch_fcn.py`` holds it to the JAX package's
``segment_volume`` too.
"""

import numpy as np
import pytest
import torch

from subcort_tpu.engine import infer as jax_infer
from subcort_tpu.models.triplanar import DEFAULT_SPEC as JAX_SPEC
from subcort_tpu_torch.engine import infer, segment_volume
from subcort_tpu_torch.models.fcn import fcn_forward_slab
from subcort_tpu_torch.models import TriPlanarNet, TriPlanarSpec, init_params
from subcort_tpu_torch.ops import scan_inputs
from subcort_tpu_torch.ops.normalize import (normalize_stats,
                                             stats_from_moments)
from subcort_tpu_torch.utils import runtime
from subcort_tpu_torch.utils.runtime import recording, records

torch.set_num_threads(1)

CPU = torch.device("cpu")
SPEC = TriPlanarSpec(conv_filters=(8, 8, 8, 8, 8), fc_conv=16, fc_fc=16,
                     fc2=16, dropout_conv=0.0, dropout_fc=0.0)
SHAPE = (36, 40, 32)
# rows of mixed sign: one that sums to 0 in any order, and one that numpy's
# order (pairwise over the first 8) sums to 2**-25 where left to right gives 0
ZERO_ROW = [0.5, -0.25, -0.25]
ORDER_ROW = [2.0 ** -25, 0.0, 1.0, -1.0]


@pytest.fixture(scope="module")
def net():
    params = init_params(SPEC, torch.Generator().manual_seed(5))
    return TriPlanarNet.from_params(params, SPEC, CPU)


def _phantom(seed=11, dtype=np.int16, rows=(ZERO_ROW,)):
    """An int16 scan with a zero border, normalized priors with ``rows``
    planted at the first candidates, and the candidates of a blob, sparse
    in its bbox."""
    rng = np.random.default_rng(seed)
    image = (rng.random(SHAPE) * 800 + 100).astype(dtype)
    image[:4] = 0
    atlas = rng.random(SHAPE + (15,)).astype(np.float32)
    atlas /= atlas.sum(axis=-1, keepdims=True)
    x, y, z = np.ogrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    blob = ((x - 17.5) ** 2 / 30 + (y - 19.5) ** 2 / 40
            + (z - 15.5) ** 2 / 25) < 1.0
    centers = np.stack(np.nonzero(blob), 1).astype(np.int32)
    for c, row in zip(centers[3::7], rows):
        atlas[tuple(c)] = 0
        atlas[tuple(c)][:len(row)] = row
    # a prior row that is all zero
    atlas[tuple(centers[1])] = 0
    return image, atlas, centers


def _moments(image, centers):
    return scan_inputs.scan_moments(torch.from_numpy(image),
                                    torch.from_numpy(centers)).tolist()


@pytest.mark.parametrize("dtype", [np.int16, np.uint16, np.int8, np.uint8])
def test_moments_give_the_host_statistics_and_bbox(dtype):
    """The integer moments of a scan over the whole range of its type
    (negative values too) give normalize_stats' (mean, std) and _bbox_of's
    bbox bit for bit, and the range check's extent."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(3)
    image = rng.integers(info.min, info.max, (23, 19, 21), dtype=dtype,
                         endpoint=True)
    image[:5] = 0
    centers = np.stack([rng.integers(2, s - 1, 300) for s in image.shape],
                       1).astype(np.int32)
    count, total, squares, *extent = _moments(image, centers)
    assert count == np.count_nonzero(image)
    assert stats_from_moments(count, float(total), float(squares)) == \
        normalize_stats(image)
    lo, hi = np.asarray(extent[:3]), np.asarray(extent[3:]) + 1
    np.testing.assert_array_equal(lo, centers.min(0))
    np.testing.assert_array_equal(hi, centers.max(0) + 1)
    got_lo, got_dims = infer._bbox_from(lo, hi, image.shape)
    want_lo, want_dims = infer._bbox_of(centers, image.shape)
    np.testing.assert_array_equal(got_lo, want_lo)
    assert got_dims == want_dims


@pytest.mark.parametrize("size", ["small", "past_2_53"])
def test_squares_past_2_53_take_the_host_statistics(monkeypatch, size):
    """The statistics come from the integer sums while the sum of squares
    is below 2**53 and from normalize_stats beyond (a uint16 scan of 2.7 M
    voxels, nearly all at 65535); either way they equal normalize_stats'."""
    image = np.full((140, 140, 140) if size == "past_2_53" else (9, 8, 7),
                    65535, np.uint16)
    image[::16] = 1000
    centers = np.asarray([[3, 4, 5]], np.int32)
    squares = _moments(image, centers)[2]
    assert (squares >= infer.EXACT_SQUARES) == (size == "past_2_53")
    host = []
    monkeypatch.setattr(infer, "normalize_stats",
                        lambda im: host.append(1) or normalize_stats(im))
    _, stats = infer._prepare(image, infer._wire(image), centers, CPU)
    assert stats == normalize_stats(image)
    assert len(host) == (size == "past_2_53")


@pytest.mark.parametrize("case", ["zero_scan", "zero_variance",
                                  "center_outside", "negative_center"])
def test_errors_as_the_host_path(net, case):
    """An all-zero int16 scan, a constant one and centers outside the
    volume raise the ValueError that a float32 copy of the scan raises
    through the host's statistics and bbox, word for word."""
    image, atlas, centers = _phantom()
    if case == "zero_scan":
        image[:] = 0
    elif case == "zero_variance":
        image[image != 0] = 7
    elif case == "center_outside":
        centers[5] = [SHAPE[0], 3, 3]
    else:
        centers[-1, 2] = -1
    with pytest.raises(ValueError) as card:
        segment_volume(net, image, atlas, centers)
    with pytest.raises(ValueError) as host:
        segment_volume(net, image.astype(np.float32), atlas, centers)
    assert str(card.value) == str(host.value)


def _host_rows(atlas, cs):
    """The JAX package's prior rows of the candidates ``cs``, in float32."""
    return jax_infer._atlas_vectors_host(atlas, cs)


@pytest.mark.parametrize("prior_dtype", [np.uint16, np.uint8, np.float32,
                                         np.float16])
@pytest.mark.parametrize("case", ["unsorted_duplicates", "fills_bbox",
                                  "sub_bboxes"])
def test_prior_rows_equal_the_host_rows(prior_dtype, case):
    """The plain prior rows and indices equal the JAX package's
    (``_quantize_priors`` of ``_atlas_vectors_host``, and the linear bbox
    indices) in every wire type: scrambled candidates with repeats
    (sparse), candidates that fill their bbox (dense: a row for every
    block voxel, no indices), and several sub-bboxes, each selecting its
    candidates; with mixed-sign rows, one that sums to zero and one whose
    sum depends on the order of the adds, and an all-zero row."""
    rows = (ZERO_ROW, ORDER_ROW)
    image, atlas, centers = _phantom(rows=rows)
    cap = 6_000_000
    if case == "unsorted_duplicates":
        perm = np.random.default_rng(1).permutation(len(centers))
        centers = np.concatenate([centers[perm], centers[perm][:41]])
    elif case == "fills_bbox":
        centers = np.stack(np.meshgrid(np.arange(10, 26), np.arange(12, 28),
                                       np.arange(8, 24), indexing="ij"),
                           -1).reshape(-1, 3).astype(np.int32)
        for c, row in zip(centers[5::9], rows):
            atlas[tuple(c)] = 0
            atlas[tuple(c)][:len(row)] = row
    else:
        cap = 700
    lo, dims = infer._bbox_of(centers, image.shape)
    slabs = list(infer._split_bbox(lo, dims, cap))
    assert (len(slabs) > 1) == (case == "sub_bboxes")
    for lo, dims in slabs:
        inside = np.all((centers >= lo) & (centers < lo + np.asarray(dims)),
                        axis=1)
        cs = centers[inside]
        if len(cs) == 0:
            continue
        block = atlas[lo[0]:lo[0] + dims[0], lo[1]:lo[1] + dims[1],
                      lo[2]:lo[2] + dims[2]]
        dense = len(cs) == np.prod(dims)
        assert dense == (case == "fills_bbox")
        got_vecs, got_lin = scan_inputs.prior_rows(
            torch.from_numpy(block), None if dense else torch.from_numpy(cs),
            lo, prior_dtype)
        if dense:
            grid = np.stack(np.meshgrid(*(np.arange(l, l + d) for l, d in
                                          zip(lo, dims)), indexing="ij"),
                            -1).reshape(-1, 3)
            want_vecs = jax_infer._quantize_priors(
                _host_rows(atlas, grid), prior_dtype)
        else:
            want_vecs = jax_infer._quantize_priors(_host_rows(atlas, cs),
                                                   prior_dtype)
            rel = cs.astype(np.int64) - lo
            want_lin = (rel[:, 0] * dims[1] + rel[:, 1]) * dims[2] + rel[:, 2]
            np.testing.assert_array_equal(got_lin.numpy(), want_lin)
        assert got_vecs.numpy().dtype == want_vecs.dtype
        np.testing.assert_array_equal(got_vecs.numpy(), want_vecs)
        assert (got_lin is None) == dense


def test_order_row_is_not_fixed_up():
    """The planted order-dependent row: numpy's sum is 2**-25, so the host
    keeps it, where a left-to-right float32 sum would have zeroed it."""
    p = np.zeros((1, 15), np.float32)
    p[0, :4] = ORDER_ROW
    assert p.sum(axis=1)[0] == 2.0 ** -25
    assert np.cumsum(p[0], dtype=np.float32)[-1] == 0.0
    np.testing.assert_array_equal(jax_infer._atlas_vectors_host(
        p[None, None], np.zeros((1, 3), np.int32)), p)


def _host_derivation(net, image, atlas, centers, want_probs=False,
                     fcn_max_bbox_voxels=6_000_000, prior_dtype=np.uint16,
                     probs_dtype=np.uint8):
    """``segment_volume(engine="fcn")`` with every sub-bbox's slab and norm
    from the JAX package's ``_fcn_slab_inputs`` (its slab cut) and the
    rows from its ``_quantize_priors(_atlas_vectors_host(...))``, through
    the port's ``fcn_forward_slab`` and a plain scatter."""
    stats = normalize_stats(image)
    label_vol = np.zeros(image.shape, np.uint8)
    prob_vol = np.zeros(image.shape + (15,), np.float32)
    lo, dims = jax_infer._bbox_of(centers, image.shape)
    for lo, dims in jax_infer._split_bbox(lo, dims, fcn_max_bbox_voxels):
        slab, dense_vecs, _, _, norm = jax_infer._fcn_slab_inputs(
            image, stats, atlas, lo, dims, image.shape, JAX_SPEC,
            prior_dtype)
        cs = centers[np.all((centers >= lo)
                            & (centers < lo + np.asarray(dims)), axis=1)]
        if len(cs) == 0:
            continue
        rel = cs.astype(np.int64) - lo
        lin = (rel[:, 0] * dims[1] + rel[:, 1]) * dims[2] + rel[:, 2]
        dense = len(cs) >= np.prod(dims)
        vecs = (dense_vecs if dense else jax_infer._quantize_priors(
            jax_infer._atlas_vectors_host(atlas, cs), prior_dtype))
        labels, probs = fcn_forward_slab(
            net, torch.from_numpy(slab), torch.from_numpy(vecs), want_probs,
            probs_dtype=getattr(torch, np.dtype(probs_dtype).name),
            gather_idx=None if dense else torch.from_numpy(lin),
            norm=(torch.from_numpy(norm[0]), tuple(norm[1]), tuple(norm[2])))
        at = lin if dense else slice(None)
        label_vol[tuple(cs.T)] = labels.numpy().reshape(-1)[at]
        if want_probs:
            probs = probs.numpy()[at]
            prob_vol[tuple(cs.T)] = (
                probs.astype(np.float32) * np.float32(1.0 / 255.0)
                if probs.dtype == np.uint8 else probs)
    return label_vol, prob_vol if want_probs else None


@pytest.mark.parametrize("case", ["int16", "uint16", "sub_bboxes",
                                  "fills_bbox", "float32_wire",
                                  "duplicates"])
def test_segment_volume_equals_the_host_derivation(net, case):
    """Labels and probabilities through the device's derivation equal a
    forward over the JAX package's host derivation bit for bit: an int16
    and a uint16 scan (sparse, uint16 priors, uint8 probabilities),
    several sub-bboxes, candidates that fill their bbox, float32 priors
    and probabilities, scrambled candidates with repeats."""
    image, atlas, centers = _phantom(
        dtype=np.uint16 if case == "uint16" else np.int16)
    kw = dict(want_probs=True)
    if case == "sub_bboxes":
        kw["fcn_max_bbox_voxels"] = 700
    elif case == "fills_bbox":
        centers = np.stack(np.meshgrid(np.arange(10, 26), np.arange(12, 28),
                                       np.arange(8, 24), indexing="ij"),
                           -1).reshape(-1, 3).astype(np.int32)
    elif case == "float32_wire":
        kw.update(prior_dtype=np.float32, probs_dtype=np.float32)
    elif case == "duplicates":
        perm = np.random.default_rng(2).permutation(len(centers))
        centers = np.concatenate([centers[perm], centers[perm][:53]])
    got = segment_volume(net, image, atlas, centers, engine="fcn", **kw)
    want = _host_derivation(net, image, atlas, centers, **kw)
    assert (want[0][tuple(centers.T)] != 0).any()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["int16", "float32_scan", "two_devices",
                                  "patch_engine", "float64_scan",
                                  "int32_scan"])
def test_card_inputs_engage_where_they_should(net, monkeypatch, case):
    """Every scan takes the one path: the scan as it goes up (int16 as it
    is, float32, float64 and int32 as float32) and the centers uploaded
    as a child of ``infer.prepare``, then ``prior_rows`` for the dense
    engine (on one device or two entries) or ``_normalized_padded`` of the
    uploaded scan for the patch engine; no kernel launches on the CPU."""
    image, atlas, centers = _phantom()
    kw = dict(engine="auto")
    if case.endswith("_scan"):
        image = image.astype(case[:-len("_scan")])
    elif case == "two_devices":
        kw["devices"] = [CPU, CPU]
    elif case == "patch_engine":
        kw.update(engine="patch", chunk=256)
    calls = {"prior_rows": 0, "_normalized_padded": 0}
    for module, name in ((scan_inputs, "prior_rows"),
                         (infer, "_normalized_padded")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _real=real, _name=name:
                            calls.__setitem__(_name, calls[_name] + 1)
                            or _real(*a))
    launches = scan_inputs.LAUNCHES
    runtime.clear_records()
    with recording():
        segment_volume(net, image, atlas, centers, **kw)
    recs = records()
    runtime.clear_records()
    assert scan_inputs.LAUNCHES == launches
    patch = case == "patch_engine"
    assert calls["_normalized_padded"] == int(patch)
    assert (calls["prior_rows"] > 0) == (not patch)
    (prepare,) = [r for r in recs if r.name == "infer.prepare"]
    (upload,) = [r for r in recs if r.name == "infer.upload"
                 and r.parent == prepare.id]
    wire = 2 if image.dtype == np.int16 else 4
    assert upload.attrs["bytes"] == wire * image.size + centers.nbytes
