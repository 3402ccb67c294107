"""PyTorch port: the patch-engine slice, end to end on the CPU.

The same phantom (numpy, seeded) and the same params (the JAX package's
``init_params(jax.random.key(7))``, bridged by ``params_from_jax``) go
through both packages' ``segment_volume`` and ``test_scan``. Tolerances:
labels and post-processed segmentations bit-equal; float32 probabilities
within 1e-5 absolute (summation order only); the default uint8 prob map
within one 1/255 step (a probability within rounding noise of a half step
may round either way).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

from subcort_tpu.config import Options as JaxOptions
from subcort_tpu.engine import segment_volume as jax_segment_volume
from subcort_tpu.engine import test_scan as jax_test_scan
from subcort_tpu.engine.postprocess import \
    post_process_segmentation as jax_post_process
from subcort_tpu.io import NiftiImage, load_nii, save_nii
from subcort_tpu.models import init_params as jax_init_params
from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine import (SegmentationEngine,
                                      post_process_segmentation,
                                      segment_volume)
from subcort_tpu_torch.engine import test_scan as port_test_scan
from subcort_tpu_torch.models import TriPlanarNet, params_from_jax
from subcort_tpu_torch.ops import gather_kernel

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PROBS_ATOL = 1e-5
AFFINE = np.array([[1.2, 0.0, 0.0, -20.0],
                   [0.0, 0.9, 0.0, 14.5],
                   [0.0, 0.0, 1.1, -7.0],
                   [0.0, 0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax.random.key(7))


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params)


@pytest.fixture(scope="module")
def net(params):
    return TriPlanarNet.from_params(params, device="cpu")


@pytest.fixture()
def phantom(rng):
    """test_engine.py's phantom, with a small atlas mask so that a few
    hundred candidates stay after the dilation."""
    image = (rng.random((36, 40, 32)) * 800 + 100).astype(np.float32)
    image[:4] = 0  # background border
    atlas = rng.random((36, 40, 32, 15)).astype(np.float32)
    atlas /= atlas.sum(axis=-1, keepdims=True)
    mask = np.zeros((36, 40, 32), np.uint8)
    mask[16:20, 18:22, 14:18] = 1
    return image, atlas, mask


def _options(options_cls=Options, **kw):
    """The port's options, or with ``options_cls=JaxOptions`` the JAX
    package's, for the JAX function a test compares against."""
    base = dict(post_process=True, out_probabilities=True, crop=True,
                debug=False, net_verbose=0, dilate_crop_iters=2,
                test_batch_size=256)
    base.update(kw)
    return options_cls(**base)


def _write_subject(folder, image, atlas, mask):
    (folder / "tmp").mkdir(parents=True)
    save_nii(NiftiImage(image, AFFINE), str(folder / "T1.nii.gz"))
    save_nii(NiftiImage(atlas), str(folder / "tmp" / "MNI_sub_probabilities.nii.gz"))
    save_nii(NiftiImage(mask), str(folder / "tmp" / "MNI_subcortical_mask.nii.gz"))
    return folder / "T1.nii.gz"


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_segment_volume_matches_jax_patch_engine(net, jax_params, phantom,
                                                 rng, dtype):
    """Labels bit-equal and float32 probs within 1e-5 of the JAX patch
    engine. int16 exercises the raw upload + on-device normalization,
    float32 the host normalization; chunk=128 leaves a short last chunk."""
    image, atlas, _ = phantom
    image = image.astype(dtype)
    centers = np.unique(np.stack([rng.integers(0, s, 300)
                                  for s in image.shape], 1), axis=0)
    centers = centers.astype(np.int32)
    want_l, want_p = jax_segment_volume(jax_params, image, atlas, centers,
                                        want_probs=True, chunk=128,
                                        engine="patch",
                                        probs_dtype=np.float32)
    got_l, got_p = segment_volume(net, image, atlas, centers,
                                  want_probs=True, chunk=128, engine="patch",
                                  probs_dtype=np.float32)
    assert got_l.dtype == np.uint8 and got_p.dtype == np.float32
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=PROBS_ATOL)
    untouched = np.ones(image.shape, bool)
    untouched[centers[:, 0], centers[:, 1], centers[:, 2]] = False
    assert got_l[untouched].sum() == 0 and got_p[untouched].sum() == 0


@pytest.mark.parametrize("variant", ["seg_prec", "rawseg"])
def test_test_scan_matches_jax(params, jax_params, phantom, tmp_path,
                               variant):
    """The same written int16 subject through both ``test_scan``s: the
    output files agree and keep the input affine. The rawseg variant runs
    the port with the default ``use_fcn=True``, whose "auto" engine takes
    the dense evaluator on this compact candidate set; the labels still
    equal the JAX patch engine's."""
    image, atlas, mask = phantom
    image = image.astype(np.int16)
    pp = variant == "seg_prec"
    jax_scan = _write_subject(tmp_path / "jax" / "s1", image, atlas, mask)
    port_scan = _write_subject(tmp_path / "port" / "s1", image, atlas, mask)
    jax_test_scan(jax_params, str(jax_scan),
                  _options(JaxOptions, post_process=pp, use_fcn=False))
    engine = SegmentationEngine(params, _options(post_process=pp,
                                                 use_fcn=not pp, mode="cpu"))
    assert engine.segment_scan(str(port_scan)) >= 0

    name = f"out_subcortical_{variant}.nii.gz"
    want = load_nii(str(jax_scan.parent / name))
    got = load_nii(str(port_scan.parent / name))
    assert got.data.shape == image.shape and got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data, want.data)
    assert (got.data != 0).any()
    np.testing.assert_array_equal(got.affine, want.affine)
    np.testing.assert_allclose(got.affine, AFFINE, atol=1e-5)
    other = "rawseg" if pp else "seg_prec"
    assert not (port_scan.parent / f"out_subcortical_{other}.nii.gz").exists()

    want_p = load_nii(str(jax_scan.parent / "out_subcortical_prob.nii.gz"))
    got_p = load_nii(str(port_scan.parent / "out_subcortical_prob.nii.gz"))
    assert got_p.data.shape == image.shape + (15,)
    assert np.abs(got_p.data - want_p.data).max() <= 1.0 / 255 + 1e-6
    np.testing.assert_array_equal(got_p.affine, want_p.affine)


def test_segment_folder_serial_sweep(params, phantom, tmp_path):
    image, atlas, mask = phantom
    for s in ("s1", "s2"):
        _write_subject(tmp_path / s, image, atlas, mask)
    opts = _options(test_folder=str(tmp_path), post_process=False,
                    out_probabilities=False, mode="cpu")
    times = SegmentationEngine(params, opts).segment_folder()
    assert set(times) == {"s1", "s2"}
    a = load_nii(str(tmp_path / "s1" / "out_subcortical_rawseg.nii.gz")).data
    b = load_nii(str(tmp_path / "s2" / "out_subcortical_rawseg.nii.gz")).data
    np.testing.assert_array_equal(a, b)
    assert not (tmp_path / "s1" / "out_subcortical_prob.nii.gz").exists()


def test_priors_come_from_cache_or_register_fn(params, phantom, tmp_path,
                                               monkeypatch):
    """A missing ``tmp/`` prior with no ``register_fn`` is registered by
    ``register_masks`` under the configured backend, cost and device, as in
    the JAX package (infer.py:710-715); a given ``register_fn`` is called
    instead."""
    import subcort_tpu_torch.registration as registration

    image, atlas, mask = phantom
    opts = _options(post_process=False, out_probabilities=False, mode="cpu",
                    reg_backend="torch", reg_similarity="ssd")
    calls = []

    def register(path, **kw):
        calls.append((path, kw))
        tmp = Path(path).parent / "tmp"
        tmp.mkdir()
        save_nii(NiftiImage(atlas), str(tmp / "MNI_sub_probabilities.nii.gz"))
        save_nii(NiftiImage(mask), str(tmp / "MNI_subcortical_mask.nii.gz"))

    monkeypatch.setattr(registration, "register_masks", register)
    for name, register_fn in (("s1", None), ("s2", register)):
        scan = tmp_path / name / "T1.nii.gz"
        scan.parent.mkdir()
        save_nii(NiftiImage(image), str(scan))
        SegmentationEngine(params, opts,
                           register_fn=register_fn).segment_scan(str(scan))
        assert (scan.parent / "out_subcortical_rawseg.nii.gz").exists()
    assert calls == [
        (str(tmp_path / "s1" / "T1.nii.gz"),
         dict(backend="torch", similarity="ssd", device=torch.device("cpu"))),
        (str(tmp_path / "s2" / "T1.nii.gz"), {})]
    # cached priors: nothing registers
    SegmentationEngine(params, opts).segment_scan(
        str(tmp_path / "s1" / "T1.nii.gz"))
    assert len(calls) == 2


def test_priors_miss_without_a_card_raises_from_select_device(params, phantom,
                                                              tmp_path):
    """``reg_backend = torch`` registers on the device ``mode`` names: a
    net on the CPU under the default mode does not pull it to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    image, _, _ = phantom
    scan = tmp_path / "s1" / "T1.nii.gz"
    scan.parent.mkdir()
    save_nii(NiftiImage(image), str(scan))
    net = TriPlanarNet.from_params(params, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_test_scan(net, str(scan), _options(reg_backend="torch"))


@pytest.mark.parametrize("option,match", [
    ({"reg_backend": "jax"}, "'torch'"),
    ({"reg_backend": "ants"}, "reg_backend"),
    ({"reg_similarity": "ncc"}, "reg_similarity"),
])
def test_unknown_registration_options_raise_before_any_work(params, option,
                                                            match):
    """``reg_backend = jax`` raises a ValueError that names ``torch``; an
    unknown backend or similarity raises too, when the engine is built."""
    with pytest.raises(ValueError, match=match):
        SegmentationEngine(params, _options(mode="cpu", **option))
    for backend in ("native", "torch"):
        SegmentationEngine(params, _options(mode="cpu", reg_backend=backend))


@pytest.mark.parametrize("option", [
    {"compute_dtype": "bfloat16"},
    {"data_parallel": 2},
    {"folder_pipeline": True},
    {"cc_backend": "device"},
])
def test_options_outside_the_slice_raise(params, option):
    """No option is outside the ported slices any more: each builds an
    engine that runs it. compute_dtype=bfloat16 (item 3) a bfloat16 net;
    folder_pipeline=True (item 6), cc_backend=device (item 8) and
    data_parallel=2 (item 9) keep the options as given for segment_folder,
    the post-process and the device list, which the one CPU clamps to
    itself."""
    from subcort_tpu_torch.engine.infer import check_slice_options

    options = _options(mode="cpu", **option)
    check_slice_options(options)
    engine = SegmentationEngine(params, options)
    assert engine.devices == (None if option != {"data_parallel": 2}
                              else [torch.device("cpu")])
    if option == {"compute_dtype": "bfloat16"}:
        assert all(t.dtype == torch.bfloat16
                   for t in engine.net.state_dict().values())
    else:
        key, value = next(iter(option.items()))
        assert engine.options[key] == value
        assert next(engine.net.parameters()).dtype == torch.float32


@pytest.mark.parametrize("call", ["engine_fcn", "bf16", "device_cc"])
def test_functions_refuse_what_is_not_ported(net, phantom, call):
    """Nothing of these is refused any more. The dense evaluator and
    bfloat16 (items 2 and 3) run: one centre gets a label and the dense
    path counts its slab. Device connected components (item 8) run on the
    device given and keep the mask's one component, as scipy does."""
    from subcort_tpu_torch.models import fcn

    image, atlas, mask = phantom
    centers = np.array([[10, 10, 10]], np.int32)
    if call == "device_cc":
        got = post_process_segmentation("", mask, atlas_mask=mask,
                                        cc_backend="device",
                                        device=torch.device("cpu"))
        np.testing.assert_array_equal(got, mask)
        return
    before = fcn.SLABS
    kw = ({"engine": "fcn"} if call == "engine_fcn"
          else {"compute_dtype": "bfloat16", "engine": "patch"})
    lv, pv = segment_volume(net, image, atlas, centers, want_probs=True, **kw)
    assert fcn.SLABS == before + (call == "engine_fcn")
    assert lv.shape == image.shape and (lv != 0).sum() <= 1
    assert abs(float(pv[10, 10, 10].sum()) - 1.0) < 0.02


def test_segment_volume_edge_cases(net, phantom):
    """No candidates: all-zero outputs and no launch. Centers outside the
    volume: refused before anything reaches the kernel."""
    image, atlas, _ = phantom
    before = gather_kernel.LAUNCHES
    lv, pv = segment_volume(net, image, atlas, np.zeros((0, 3), np.int32),
                            want_probs=True)
    assert lv.shape == image.shape and lv.sum() == 0
    assert pv.shape == image.shape + (15,) and pv.sum() == 0
    assert gather_kernel.LAUNCHES == before
    for bad in ([-1, 0, 0], [0, 40, 0], [36, 0, 0]):
        with pytest.raises(ValueError, match="outside"):
            segment_volume(net, image, atlas, np.array([bad], np.int32))


@pytest.mark.parametrize("bugcompat", [False, True])
def test_postprocess_matches_jax(bugcompat, rng):
    labels = rng.integers(0, 4, (20, 22, 18)).astype(np.uint8)
    labels[rng.random(labels.shape) < 0.6] = 0
    mask = np.zeros(labels.shape, bool)
    mask[5:12, 6:14, 4:10] = True
    got = post_process_segmentation("", labels, atlas_mask=mask,
                                    bugcompat_argmax=bugcompat)
    want = jax_post_process("", labels, atlas_mask=mask,
                            bugcompat_argmax=bugcompat)
    np.testing.assert_array_equal(got, want)


def _run(code_or_args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    args = (code_or_args if isinstance(code_or_args, list)
            else [sys.executable, "-c", code_or_args])
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_port_and_chip_smoke_import_without_jax():
    """Every port module, and chip_smoke (imported, not run), with jax
    made unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import importlib, pkgutil, subcort_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "subcort_tpu_torch.__path__, 'subcort_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(len(names), 'modules')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 15


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke would run")
    proc = _run([sys.executable, "chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_numpy_helper_copies_match_jax_package(phantom, dtype):
    """The port's numpy copies (normalize, voxel enumeration, candidate
    centers, Dice) give the JAX package's results."""
    from subcort_tpu.engine.infer import candidate_centers as jax_candidates
    from subcort_tpu.engine.metrics import dice_per_class as jax_dice
    from subcort_tpu.ops import normalize_nonzero as jax_normalize
    from subcort_tpu_torch.engine import candidate_centers, dice_per_class
    from subcort_tpu_torch.ops import normalize_nonzero

    image, _, mask = phantom
    image = image.astype(dtype)
    got, want = normalize_nonzero(image), jax_normalize(image)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    for crop in (True, False):
        np.testing.assert_array_equal(
            candidate_centers(image, _options(crop=crop), mask),
            jax_candidates(image, _options(JaxOptions, crop=crop), mask))
    seg = (image.astype(np.int64) % 5).astype(np.uint8)
    assert dice_per_class(seg, mask * 3) == jax_dice(seg, mask * 3)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_normalized_padded_volume_bit_equal_to_jax(phantom, dtype):
    """The volume the gather reads, normalized on the device from the
    uploaded scan (int16 as it is, float32 as float32): bit-equal to the
    JAX package's (int16: ``_pad_normalize_device``; float32: its host
    normalization), halo included."""
    import jax.numpy as jnp
    from subcort_tpu.engine.infer import _pad_normalize_device
    from subcort_tpu.ops import normalize_stats, pad_volume as jax_pad
    from subcort_tpu_torch.engine.infer import _normalized_padded, _wire

    image = phantom[0].astype(dtype)
    mean, std = normalize_stats(image)
    if dtype == "int16":
        want = _pad_normalize_device(
            jnp.asarray(image), jnp.asarray([mean, 1.0 / std], np.float32))
    else:
        want = jax_pad(jnp.asarray((image - np.float32(mean))
                                   * np.float32(1.0 / std)))
    got = _normalized_padded(torch.from_numpy(_wire(image)), (mean, std))
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
