"""PyTorch port: the headline per-scan benchmark
(``subcort_tpu_torch/bench/scan.py``) held to the original at the repo
root (``bench.py``) and to the JAX package's calls, on the CPU.

``run`` goes once over a small phantom (``make_scan``'s construction at
44x48x40, a narrow net with the JAX package's seeded weights bridged by
``params_from_jax``, one repeat, an oracle sample of 24 voxels). The JAX
package runs the same ``segment_volume`` calls the original makes on the
same inputs. Tolerances:

- exact and probability-map labels bit-equal to the JAX package's (both
  float32 on the CPU, as tests/test_torch_fcn.py holds them);
- the fast profile's labels (bfloat16 with uint8 priors) at >= 0.999
  agreement with the JAX package's (tests/test_torch_fcn.py's bound);
- ``fcn_vs_patch_agreement``, ``candidate_voxels`` and
  ``est_flops_per_scan`` equal to the JAX package's numbers;
- ``oracle_agreement`` equal to the one computed here with
  tests/lasagne_oracle.py on the same voxel sample;
- ``make_scan`` array-equal to the original's, and the constants equal.
"""

import ast
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import ndimage

from subcort_tpu_torch.bench import scan
from subcort_tpu_torch.models import (TriPlanarNet, TriPlanarSpec,
                                      params_from_jax, save_theano_checkpoint)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ORIGINAL = REPO / "bench.py"
CPU = torch.device("cpu")
NARROW = dict(conv_filters=(8, 8, 8, 8, 8), fc_conv=16, fc_fc=16, fc2=16)
PHANTOM = (44, 48, 40)
ORACLE_N = 24
RNG_SEED = 5


def _original_source(name: str):
    """A top-level node of bench.py by name (the module itself imports jax
    and turns on its compilation cache, so it is parsed, not imported)."""
    for node in ast.parse(ORIGINAL.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == name):
            return node
    raise KeyError(name)


def make_phantom(rng, shape=PHANTOM):
    """``make_scan``'s construction at a small shape: int16 brain
    ellipsoid, a 15-channel atlas with random priors in a small ROI
    ellipsoid and channel 14 elsewhere."""
    image = np.zeros(shape, np.int16)
    x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
    c = [s / 2 for s in shape]
    brain = (((x - c[0]) / (shape[0] * 0.45)) ** 2
             + ((y - c[1]) / (shape[1] * 0.45)) ** 2
             + ((z - c[2]) / (shape[2] * 0.45)) ** 2) < 1.0
    image[brain] = (rng.random(int(brain.sum())) * 800 + 100).astype(np.int16)
    atlas = np.zeros(shape + (15,), np.float32)
    atlas[..., 14] = 1.0
    roi = (((x - c[0]) / 3.0) ** 2 + ((y - c[1]) / 4.0) ** 2
           + ((z - c[2]) / 3.0) ** 2) < 1.0
    pri = rng.random((int(roi.sum()), 15)).astype(np.float32)
    pri /= pri.sum(1, keepdims=True)
    atlas[roi] = pri
    return image, atlas, roi


def _config(kw) -> str:
    """Which of the original's calls a ``segment_volume`` call is."""
    if kw.get("engine") == "patch":
        return "patch"
    if kw.get("compute_dtype") == "bfloat16":
        return "fast"
    return "probs" if kw.get("want_probs") else "exact"


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """One ``run`` on the phantom with a reference-format pickle of the
    net's weights, the JAX package's labels for the same calls, and what
    the port's calls returned (the last of each configuration)."""
    import jax

    from subcort_tpu.engine import segment_volume as jax_segment_volume
    from subcort_tpu.models import init_params as jax_init_params
    from subcort_tpu.models.triplanar import TriPlanarSpec as JaxSpec

    image, atlas, roi = make_phantom(np.random.default_rng(0))
    jspec, spec = JaxSpec(**NARROW), TriPlanarSpec(**NARROW)
    jparams = jax_init_params(jax.random.key(3), jspec)
    params = params_from_jax(jparams, spec)
    ckpt = tmp_path_factory.mktemp("ckpt") / "narrow_seed3.pkl"
    save_theano_checkpoint(params, str(ckpt))
    net = TriPlanarNet.from_params(params, spec, CPU)

    port = {}
    real = scan.segment_volume

    def spy(*args, **kw):
        out = real(*args, **kw)
        port[_config(kw)] = out[0]
        return out

    scan.segment_volume = spy
    try:
        rec = scan.run(net, image, atlas, roi,
                       np.random.default_rng(RNG_SEED), device=CPU,
                       repeats=1, oracle_n=ORACLE_N, checkpoint=str(ckpt))
    finally:
        scan.segment_volume = real

    centers = np.stack(np.nonzero(ndimage.binary_dilation(
        roi, iterations=10)), axis=1).astype(np.int32)
    calls = {"exact": {}, "probs": dict(want_probs=True),
             "fast": dict(compute_dtype="bfloat16", prior_dtype=np.uint8),
             "patch": dict(engine="patch")}
    want = {name: jax_segment_volume(jparams, image, atlas, centers,
                                     spec=jspec, **kw)[0]
            for name, kw in calls.items()}
    return dict(rec=rec, port=port, jax=want, centers=centers, image=image,
                atlas=atlas, ckpt=str(ckpt), spec=jspec)


def _sel(centers):
    return centers[:, 0], centers[:, 1], centers[:, 2]


@pytest.mark.parametrize("config", ["exact", "probs", "patch"])
def test_run_labels_bit_equal_to_the_jax_package(bench_run, config):
    got, want = bench_run["port"][config], bench_run["jax"][config]
    assert got.dtype == want.dtype == np.uint8
    assert (got[_sel(bench_run["centers"])] != 0).any()
    np.testing.assert_array_equal(got, want)


def test_run_fast_labels_agree_with_the_jax_package(bench_run):
    sel = _sel(bench_run["centers"])
    got, want = bench_run["port"]["fast"], bench_run["jax"]["fast"]
    agreement = float(np.mean(got[sel] == want[sel]))
    assert agreement >= 0.999, agreement
    assert bench_run["rec"]["bf16_fast_agreement"] == round(float(np.mean(
        got[sel] == bench_run["port"]["exact"][sel])), 6)


def test_run_canary_and_counts_equal_the_jax_package(bench_run):
    """``fcn_vs_patch_agreement`` and ``candidate_voxels`` equal the JAX
    package's, and the FLOP count equals its ``slab_flops`` at the same
    bbox and one row per candidate."""
    from subcort_tpu.engine.infer import _bbox_of as jax_bbox_of
    from subcort_tpu.models.fcn import slab_flops as jax_slab_flops

    rec, centers, jax_l = bench_run["rec"], bench_run["centers"], \
        bench_run["jax"]
    sel = _sel(centers)
    assert rec["fcn_vs_patch_agreement"] == round(float(np.mean(
        jax_l["exact"][sel] == jax_l["patch"][sel])), 6)
    assert rec["candidate_voxels"] == len(centers)
    _, dims = jax_bbox_of(centers, PHANTOM)
    assert int(np.prod(dims)) > len(centers)  # the head runs at the rows
    assert rec["est_flops_per_scan"] == jax_slab_flops(
        dims, m_rows=len(centers), spec=bench_run["spec"])


def test_run_oracle_agreement_equals_the_oracle_by_hand(bench_run):
    """The oracle canary on the sample the original draws (from the rng
    after the scan), computed here with tests/lasagne_oracle.py."""
    sys.path.insert(0, str(REPO / "tests"))
    import lasagne_oracle as oracle

    from subcort_tpu_torch.ops.normalize import normalize_nonzero
    from subcort_tpu_torch.ops.patches import gather_triplanar_np

    centers, image, atlas = (bench_run[k] for k in
                             ("centers", "image", "atlas"))
    sub = centers[np.random.default_rng(RNG_SEED).choice(
        len(centers), size=ORACLE_N, replace=False)]
    norm, _, _ = normalize_nonzero(image)
    ax, co, sa = gather_triplanar_np(norm, sub)
    vec = atlas[sub[:, 0], sub[:, 1], sub[:, 2]].astype(np.float32).copy()
    empty = vec.sum(1) == 0
    vec[empty] = 0.0
    vec[empty, 14] = 1.0
    want = oracle.forward(oracle.load_raw(bench_run["ckpt"]), ax[:, None],
                          co[:, None], sa[:, None], vec).argmax(1)
    got = bench_run["port"]["exact"][_sel(sub)]
    assert bench_run["rec"]["oracle_agreement"] == round(
        float(np.mean(got == want)), 6)
    assert bench_run["rec"]["oracle_agreement"] >= (ORACLE_N - 1) / ORACLE_N


def test_run_line_on_the_cpu(bench_run):
    rec = bench_run["rec"]
    assert rec["device"] == "cpu" and rec["checkpoint"] == "narrow_seed3"
    assert rec["peak_flops_assumed"] is None
    assert rec["est_mfu_bf16"] is None
    assert rec["est_mfu_f32_vs_bf16_peak"] is None
    assert rec["n_repeats"] == 1 and rec["includes_post_process"] is True
    assert rec["volume_shape"] == list(PHANTOM)
    for key in ("value", "median_seconds", "device_seconds",
                "bf16_device_seconds", "with_prob_maps_seconds",
                "bf16_fast_seconds"):
        assert rec[key] > 0, key
    # vs_baseline comes from the unrounded seconds
    assert rec["vs_baseline"] == pytest.approx(
        scan.TARGET_SECONDS / rec["value"], rel=1e-3)


# ------------------------------------------------------------- constants
def test_constants_equal_the_originals():
    for name in ("REF_CKPT", "TARGET_SECONDS"):
        assert getattr(scan, name) == ast.literal_eval(
            _original_source(name).value), name


def test_peak_table_holds_the_h100_dense_bfloat16_peak():
    assert scan.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert scan.peak_flops("cpu") is None
    assert 197e12 not in scan.PEAK_FLOPS.values()


def _digest(arrays) -> list:
    return [(a.dtype.str, a.shape, hashlib.sha256(
        np.ascontiguousarray(a).tobytes()).hexdigest()) for a in arrays]


def test_make_scan_array_equal_to_the_original():
    """The original's ``make_scan``, its source run with numpy; one scan
    (427 MB of atlas) is held at a time."""
    namespace = {"np": np}
    exec(compile(ast.Module(body=[_original_source("make_scan")],
                            type_ignores=[]), str(ORIGINAL), "exec"),
         namespace)
    want = _digest(namespace["make_scan"](np.random.default_rng(0)))
    got = _digest(scan.make_scan(np.random.default_rng(0)))
    assert got == want


# ------------------------------------------------------------------- main
def test_main_without_a_card_raises_before_building_the_scan(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")

    def no_scan(rng):
        raise AssertionError("the scan was built before the device check")

    monkeypatch.setattr(scan, "make_scan", no_scan)
    with pytest.raises(RuntimeError, match="CUDA device"):
        scan.main([])


def test_main_mode_cpu_prints_one_line(monkeypatch, capsys, tmp_path):
    """``main(["--mode", "cpu"])`` with the scan cut to the phantom and
    the net to the narrow spec (the seeded weights; no reference
    checkpoint): one JSON line on the CPU, without the oracle canary."""
    monkeypatch.setattr(scan, "make_scan", make_phantom)
    monkeypatch.setattr(scan, "DEFAULT_SPEC", TriPlanarSpec(**NARROW))
    monkeypatch.setattr(scan, "REF_CKPT", str(tmp_path / "absent.pkl"))
    monkeypatch.setenv("SUBCORT_BENCH_REPEATS", "1")
    rec = scan.main(["--mode", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines == [rec]
    assert rec["device"] == "cpu" and rec["checkpoint"] == "random-init"
    assert rec["oracle_agreement"] is None and rec["n_repeats"] == 1
    assert rec["peak_flops_assumed"] is None and rec["est_mfu_bf16"] is None
    assert rec["volume_shape"] == list(PHANTOM)
