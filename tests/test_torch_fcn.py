"""PyTorch port: the dense à-trous evaluator and bfloat16, against the JAX
package on the CPU.

The same seeded numpy inputs and the same params (the JAX package's
``init_params(jax.random.key(7))``, bridged by ``params_from_jax``) go
through both packages. Tolerances:

- labels bit-equal, port vs JAX and port dense vs port patch (the repo's
  invariant), in float32;
- float32 probabilities within 1e-5 absolute between the packages (both
  run float32 on the CPU and differ only in summation order), and within
  atol 2e-4 / rtol 1e-3 between the dense and the patch evaluation, as
  tests/test_fcn.py holds them (the dense convs reassociate the sums);
- uint8 probability maps within one 1/255 step (a value within rounding
  noise of a half step may round either way);
- prior quantization and dequantization, and the slab cut, bit-equal;
- bfloat16 labels at >= 0.999 agreement with float32 and with JAX's
  bfloat16 (tests/test_engine.py's bound).
"""

from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import subcort_tpu.models.fcn as jax_fcn
from subcort_tpu.config import Options as JaxOptions
from subcort_tpu.engine import segment_volume as jax_segment_volume
from subcort_tpu.engine import test_scan as jax_test_scan
from subcort_tpu.engine.infer import _fcn_slab_inputs as jax_slab_inputs
from subcort_tpu.engine.infer import _quantize_priors as jax_quantize
from subcort_tpu.io import NiftiImage, load_nii, save_nii
from subcort_tpu.models import init_params as jax_init_params
from subcort_tpu.models.triplanar import DEFAULT_SPEC as JAX_SPEC
from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine import SegmentationEngine, segment_volume
from subcort_tpu_torch.engine import infer
from subcort_tpu_torch.models import TriPlanarNet, params_from_jax
from subcort_tpu_torch.models import fcn
from subcort_tpu_torch.ops import scan_inputs
from subcort_tpu_torch.ops.normalize import normalize_stats
from subcort_tpu_torch.ops.patches import gather_triplanar, pad_volume

torch.set_num_threads(1)

PROBS_ATOL = 1e-5
STEP = 1.0 / 255 + 1e-6
RF = fcn.RF


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax.random.key(7))


@pytest.fixture(scope="module")
def net(jax_params):
    return TriPlanarNet.from_params(params_from_jax(jax_params), device="cpu")


@pytest.fixture()
def phantom(rng):
    """tests/test_engine.py's phantom; the candidates are a dilated-looking
    blob of a few hundred voxels, sparse in its 16^3 bbox."""
    image = (rng.random((36, 40, 32)) * 800 + 100).astype(np.float32)
    image[:4] = 0  # background border
    atlas = rng.random((36, 40, 32, 15)).astype(np.float32)
    atlas /= atlas.sum(axis=-1, keepdims=True)
    mask = np.zeros((36, 40, 32), np.uint8)
    mask[16:20, 18:22, 14:18] = 1
    x, y, z = np.ogrid[:36, :40, :32]
    blob = ((x - 17.5) ** 2 / 16 + (y - 19.5) ** 2 / 20
            + (z - 15.5) ** 2 / 13) < 1.0
    centers = np.stack(np.nonzero(blob), 1).astype(np.int32)
    return image, atlas, mask, centers


def _sel(centers):
    return centers[:, 0], centers[:, 1], centers[:, 2]


def test_dense_branch_matches_patch_branch(net, jax_params, rng):
    """Every pixel of each view's dense feature map equals the port's patch
    branch at that patch (the à-trous equivalence; a non-square plane
    catches a transposed d1 kernel), and the JAX dense branch."""
    H, W = 11, 9
    slab = rng.standard_normal((1, 1, H + RF, W + RF)).astype(np.float32)
    patches = torch.from_numpy(np.stack(
        [slab[0, 0, i:i + 32, j:j + 32] for i in range(H) for j in range(W)]))
    for view in ("axial", "coronal", "sagittal"):
        branch = getattr(net, view)
        with torch.inference_mode():
            dense = fcn.dense_branch_features(branch, torch.from_numpy(slab))
            feats = branch(patches.unsqueeze(1))
        assert dense.shape == (1, 180, H, W)
        dense = dense[0].permute(1, 2, 0).reshape(H * W, 180).numpy()
        np.testing.assert_allclose(dense, feats.numpy(), atol=2e-4, rtol=1e-3)
        want = np.asarray(jax_fcn.dense_branch_features(
            jax_params[view], jnp.asarray(slab.transpose(0, 2, 3, 1))))
        np.testing.assert_allclose(dense, want.reshape(H * W, 180),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["dense", "gather_idx", "norm", "uint8"])
def test_fcn_forward_slab_matches_jax(net, jax_params, rng, mode):
    """One slab of a non-cubic 7x6x8 bbox through both ``fcn_forward_slab``s:
    dense mode, explicit (unsorted, repeated) indices, a raw int16 slab
    normalized on the device with voxels outside [lo, hi) zeroed, and
    uint8 probabilities."""
    bx, by, bz = 7, 6, 8
    n = bx * by * bz
    slab = rng.standard_normal((bx + RF, by + RF, bz + RF)).astype(np.float32)
    kw_port, kw_jax = {}, {}
    rows = n
    if mode == "gather_idx":
        idx = rng.integers(0, n, 150)
        kw_port["gather_idx"] = torch.from_numpy(idx.astype(np.int64))
        kw_jax["gather_idx"] = jnp.asarray(idx.astype(np.int32))
        rows = len(idx)
    elif mode == "norm":
        slab = (rng.random(slab.shape) * 800 + 100).astype(np.int16)
        scale = np.array([450.0, 1.0 / 230.0], np.float32)
        lo, hi = (3, 0, 5), (bx + RF - 2, by + RF, bz + RF - 4)
        kw_port["norm"] = (torch.from_numpy(scale), lo, hi)
        kw_jax["norm"] = (jnp.asarray(scale), jnp.asarray(lo),
                          jnp.asarray(hi), jnp.zeros((), jnp.float32))
    elif mode == "uint8":
        kw_port["probs_dtype"] = torch.uint8
        kw_jax["probs_dtype"] = "uint8"
    atlas = rng.random((rows, 15)).astype(np.float32)
    want_l, want_p = jax_fcn.fcn_forward_slab(
        jax_params, jnp.asarray(slab), jnp.asarray(atlas), True, **kw_jax)
    got_l, got_p = fcn.fcn_forward_slab(
        net, torch.from_numpy(slab), torch.from_numpy(atlas), True,
        head_chunk=64, **kw_port)
    assert got_l.dtype == torch.uint8 and got_l.shape == want_l.shape
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    if mode == "uint8":
        assert got_p.dtype == torch.uint8
        diff = np.abs(got_p.numpy().astype(int) - np.asarray(want_p).astype(int))
        assert diff.max() <= 1
    else:
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                                   rtol=0, atol=PROBS_ATOL)


def _jax_dequantize(vecs, dtype):
    """The JAX package's prior dequantization, fcn.py:221-229, verbatim."""
    if vecs.dtype == jnp.uint8:
        return vecs.astype(dtype) * (1.0 / 255.0)
    if vecs.dtype == jnp.uint16:
        return (vecs.astype(jnp.float32) * (1.0 / 65535.0)).astype(dtype)
    return vecs.astype(dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prior_dtype", ["uint16", "uint8", "float32"])
def test_prior_quantization_bit_equal_to_jax(rng, prior_dtype, compute_dtype):
    vecs = rng.random((257, 15)).astype(np.float32)
    vecs /= vecs.sum(1, keepdims=True)
    vecs[:3] = 0.0
    vecs[:3, 14] = 1.0
    q = scan_inputs.prior_rows_plain(torch.from_numpy(vecs[:, None, None]),
                                     None, (0, 0, 0),
                                     np.dtype(prior_dtype))[0].numpy()
    want_q = jax_quantize(vecs, np.dtype(prior_dtype))
    assert q.dtype == want_q.dtype
    np.testing.assert_array_equal(q, want_q)
    got = fcn.dequantize_priors(torch.from_numpy(q),
                                getattr(torch, compute_dtype))
    want = _jax_dequantize(jnp.asarray(q), jnp.dtype(compute_dtype))
    assert str(got.dtype) == f"torch.{compute_dtype}"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("case", ["default_int16", "float32", "full_bbox"])
def test_segment_volume_fcn_matches_jax(net, jax_params, phantom, case):
    """``engine="fcn"`` through both packages. default_int16: the raw int16
    slab with the default uint16 priors and uint8 probs (sparse mode);
    float32: a float scan normalized on the host, float32 priors and probs;
    full_bbox: candidates that fill their bbox (the dense head)."""
    image, atlas, _, centers = phantom
    kw = dict(prior_dtype=np.float32, probs_dtype=np.float32)
    if case == "default_int16":
        image, kw = image.astype(np.int16), {}
    elif case == "full_bbox":
        centers = np.stack(np.meshgrid(np.arange(10, 26), np.arange(12, 28),
                                       np.arange(8, 24), indexing="ij"),
                           -1).reshape(-1, 3).astype(np.int32)
    want_l, want_p = jax_segment_volume(jax_params, image, atlas, centers,
                                        want_probs=True, engine="fcn", **kw)
    got_l, got_p = segment_volume(net, image, atlas, centers,
                                  want_probs=True, engine="fcn", **kw)
    assert got_l.dtype == np.uint8 and got_p.dtype == np.float32
    np.testing.assert_array_equal(got_l, want_l)
    assert (got_l[_sel(centers)] != 0).any()
    atol = STEP if case == "default_int16" else PROBS_ATOL
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=atol)


def test_fcn_matches_patch_engine(net, phantom):
    """The invariant: the port's dense and patch engines agree on 100% of
    labels at every candidate voxel, with the same float32 priors."""
    image, atlas, _, centers = phantom
    lv_p, pv_p = segment_volume(net, image, atlas, centers, want_probs=True,
                                engine="patch", chunk=256,
                                probs_dtype=np.float32)
    lv_f, pv_f = segment_volume(net, image, atlas, centers, want_probs=True,
                                engine="fcn", prior_dtype=np.float32,
                                probs_dtype=np.float32)
    np.testing.assert_array_equal(lv_f, lv_p)
    np.testing.assert_allclose(pv_f[_sel(centers)], pv_p[_sel(centers)],
                               atol=2e-4, rtol=1e-3)


def test_fcn_forward_bbox_matches_patch_gather(net, rng):
    """The bbox cut from a padded volume, against the patch net on the
    plainly gathered patches of every bbox voxel."""
    vol = torch.from_numpy(rng.standard_normal((30, 34, 28)).astype(np.float32))
    origin, (bx, by, bz) = (4, 6, 3), (7, 6, 8)
    atlas = torch.from_numpy(rng.random((bx * by * bz, 15), dtype=np.float32))
    labels, probs = fcn.fcn_forward_bbox(net, pad_volume(vol), origin,
                                         (bx, by, bz), atlas, want_probs=True)
    centers = torch.stack(torch.meshgrid(
        *(torch.arange(o, o + d) for o, d in zip(origin, (bx, by, bz))),
        indexing="ij"), -1).reshape(-1, 3).to(torch.int32)
    with torch.inference_mode():
        want = net(*gather_triplanar(pad_volume(vol), centers), atlas)
    np.testing.assert_allclose(probs.numpy(), want.numpy(), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_array_equal(labels.reshape(-1).numpy(),
                                  want.argmax(1).numpy())


def test_fcn_bbox_splitting_equals_unsplit(net, jax_params, rng):
    """Every nonzero voxel of a 24x20x18 scan (crop=False) in sub-slabs of
    at most 5,000 voxels: labels equal the unsplit run's and JAX's split
    run's."""
    image = (rng.random((24, 20, 18)) * 800 + 100).astype(np.float32)
    atlas = rng.random((24, 20, 18, 15)).astype(np.float32)
    centers = np.stack(np.nonzero(image), 1).astype(np.int32)
    kw = dict(want_probs=True, engine="fcn", prior_dtype=np.float32,
              probs_dtype=np.float32)
    before = fcn.SLABS
    lv_one, pv_one = segment_volume(net, image, atlas, centers, **kw)
    assert fcn.SLABS == before + 1
    lv_split, pv_split = segment_volume(net, image, atlas, centers,
                                        fcn_max_bbox_voxels=5000, **kw)
    assert fcn.SLABS == before + 3
    np.testing.assert_array_equal(lv_split, lv_one)
    np.testing.assert_allclose(pv_split, pv_one, rtol=0, atol=PROBS_ATOL)
    want_l, _ = jax_segment_volume(jax_params, image, atlas, centers,
                                   fcn_max_bbox_voxels=5000, **kw)
    np.testing.assert_array_equal(lv_split, want_l)


def test_fcn_unsorted_duplicate_centers(net, jax_params, phantom, rng):
    """A scrambled candidate list with repeats gives the label volume of the
    sorted, unique list, in the port and in JAX."""
    image, atlas, _, uniq = phantom
    scrambled = uniq[rng.permutation(len(uniq))]
    dup = np.concatenate([scrambled, scrambled[:37]])
    lv_ref, pv_ref = segment_volume(net, image, atlas, uniq, engine="fcn",
                                    want_probs=True)
    lv_dup, pv_dup = segment_volume(net, image, atlas, dup, engine="fcn",
                                    want_probs=True)
    want, _ = jax_segment_volume(jax_params, image, atlas, dup, engine="fcn")
    np.testing.assert_array_equal(lv_dup, lv_ref)
    np.testing.assert_array_equal(pv_dup, pv_ref)
    np.testing.assert_array_equal(lv_dup, want)


@pytest.mark.parametrize("density", ["dense", "sparse"])
def test_auto_engine_chooses_as_jax(net, jax_params, phantom, rng,
                                    monkeypatch, density):
    """``engine="auto"`` takes the dense evaluator for a compact candidate
    blob and the patch engine for a few scattered voxels, in both packages,
    with the same labels."""
    image, atlas, _, centers = phantom
    if density == "sparse":
        centers = np.unique(np.stack([rng.integers(0, s, 40)
                                      for s in image.shape], 1), axis=0)
        centers = centers.astype(np.int32)
    jax_slabs = []
    real = jax_fcn.fcn_forward_slab
    monkeypatch.setattr(jax_fcn, "fcn_forward_slab",
                        lambda *a, **k: jax_slabs.append(1) or real(*a, **k))
    want, _ = jax_segment_volume(jax_params, image, atlas, centers)
    before = fcn.SLABS
    got, _ = segment_volume(net, image, atlas, centers)
    ran_fcn = fcn.SLABS > before
    assert ran_fcn == bool(jax_slabs) == (density == "dense")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("engine", ["fcn", "patch"])
def test_bfloat16_agreement(net, jax_params, phantom, engine):
    """compute_dtype=bfloat16 on either engine, on the 2,016 candidates of
    tests/test_engine.py::test_segment_volume_bfloat16_agreement: >= 0.999
    label agreement with JAX's bfloat16 and with the port's float32; the
    net passed in stays float32.

    The patch engine argmaxes bfloat16 probabilities (JAX forward.py:73),
    whose rounding ties flip labels where this random-weight model is
    undecided, in both packages alike: there its float32 agreement is held
    to JAX's own, less one label in a thousand."""
    image, atlas, _, _ = phantom
    mask = np.zeros(image.shape, bool)
    mask[12:24, 14:28, 10:22] = True
    centers = np.stack(np.nonzero(mask), 1).astype(np.int32)
    sel = _sel(centers)
    lv32, _ = segment_volume(net, image, atlas, centers, engine=engine)
    lv16, pv16 = segment_volume(net, image, atlas, centers, engine=engine,
                                compute_dtype="bfloat16", want_probs=True)
    want16, _ = jax_segment_volume(jax_params, image, atlas, centers,
                                   engine=engine, compute_dtype="bfloat16")
    assert next(net.parameters()).dtype == torch.float32
    assert (lv16[sel] == want16[sel]).mean() >= 0.999
    floor = 0.999
    if engine == "patch":
        want32, _ = jax_segment_volume(jax_params, image, atlas, centers,
                                       engine=engine)
        floor = min(floor, (want16[sel] == want32[sel]).mean() - 0.001)
    assert (lv16[sel] == lv32[sel]).mean() >= floor
    assert np.isfinite(pv16).all()
    np.testing.assert_allclose(pv16[sel].sum(1), 1.0, atol=0.02)


def test_bfloat16_normalizes_in_float32_first(net, phantom):
    """The raw int16 slab is normalized in float32 before the bfloat16 cast,
    so an int16 scan and the same values in float32 give equal labels."""
    image, atlas, _, centers = phantom
    image16 = image.astype(np.int16)
    lb16, _ = segment_volume(net, image16, atlas, centers, engine="fcn",
                             compute_dtype="bfloat16")
    lb32, _ = segment_volume(net, image16.astype(np.float32), atlas, centers,
                             engine="fcn", compute_dtype="bfloat16")
    np.testing.assert_array_equal(lb16, lb32)


@pytest.mark.parametrize("lo", [(0, 0, 0), (20, 30, 10), (39, 0, 0),
                                (70, 0, 0), (70, 60, 55)])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_slab_cut_matches_jax(rng, lo, dtype):
    """The device slab cut (on the CPU), borders and past-the-end origins
    included, normalized by ``fcn_forward_slab``'s ``_normalize_slab``:
    the JAX package's slab (for int16, its raw slab normalized by its own
    bounds), the same bounds, and an all-zero slab where the sub-bbox lies
    beyond the volume."""
    image = (rng.random((40, 44, 40)) * 800 + 100).astype(dtype)
    atlas = rng.random((40, 44, 40, 15)).astype(np.float32)
    lo, dims = np.asarray(lo, np.int32), (16, 14, 12)
    stats = normalize_stats(image)
    centers = lo[None].copy()
    scan = infer._Scan(torch.from_numpy(infer._wire(image)),
                       torch.from_numpy(centers), lo, dims)
    slab, _, _, norm, _ = infer._slab_inputs(scan, stats, atlas, lo, dims,
                                             np.float32, centers)
    got = fcn._normalize_slab(slab, *norm, torch.float32).numpy()
    want, _, _, _, want_norm = jax_slab_inputs(
        image, stats, atlas, lo, dims, image.shape, JAX_SPEC, np.float32)
    assert (want_norm is None) == (dtype == "float32")
    if want_norm is not None:
        np.testing.assert_array_equal(norm[0].numpy(), want_norm[0])
        assert norm[1:] == tuple(tuple(int(v) for v in w)
                                 for w in want_norm[1:])
        want = fcn._normalize_slab(torch.from_numpy(want),
                                   torch.from_numpy(want_norm[0]),
                                   *want_norm[1:], torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    if lo[0] >= 40 + fcn.HALF:
        assert not got.any()


def test_slab_flops_matches_jax():
    for dims, m in (((80, 96, 80), 204_403), ((7, 6, 8), None)):
        assert fcn.slab_flops(dims, m) == jax_fcn.slab_flops(dims, m)


def _write_subject(folder, image, atlas, mask):
    affine = np.diag([1.2, 0.9, 1.1, 1.0])
    (folder / "tmp").mkdir(parents=True)
    save_nii(NiftiImage(image, affine), str(folder / "T1.nii.gz"))
    save_nii(NiftiImage(atlas),
             str(folder / "tmp" / "MNI_sub_probabilities.nii.gz"))
    save_nii(NiftiImage(mask),
             str(folder / "tmp" / "MNI_subcortical_mask.nii.gz"))
    return folder / "T1.nii.gz"


def test_test_scan_use_fcn_matches_jax(jax_params, phantom, tmp_path):
    """The default config (use_fcn=True, uint16 priors, uint8 probs,
    post-process) through both ``test_scan``s on one written int16 subject:
    the same output files."""
    image, atlas, mask, _ = phantom
    image = image.astype(np.int16)
    opts = dict(post_process=True, out_probabilities=True, crop=True,
                debug=False, net_verbose=0, dilate_crop_iters=2,
                use_fcn=True)
    jax_scan = _write_subject(tmp_path / "jax" / "s1", image, atlas, mask)
    port_scan = _write_subject(tmp_path / "port" / "s1", image, atlas, mask)
    jax_test_scan(jax_params, str(jax_scan), JaxOptions(**opts))
    before = fcn.SLABS
    engine = SegmentationEngine(params_from_jax(jax_params),
                                Options(mode="cpu", **opts))
    engine.segment_scan(str(port_scan))
    assert fcn.SLABS > before
    for name in ("out_subcortical_seg_prec.nii.gz",
                 "out_subcortical_prob.nii.gz"):
        want = load_nii(str(Path(jax_scan).parent / name))
        got = load_nii(str(Path(port_scan).parent / name))
        assert got.data.shape == want.data.shape
        assert got.data.dtype == want.data.dtype
        np.testing.assert_array_equal(got.affine, want.affine)
        if name.endswith("prob.nii.gz"):
            assert np.abs(got.data - want.data).max() <= STEP
        else:
            np.testing.assert_array_equal(got.data, want.data)
            assert (got.data != 0).any()
