"""PyTorch port: SynthSeg's 3D U-Net and its whole-volume path
(``models/synthseg.py``, ``engine/synthseg.py``) on the CPU, seeded, at a
small spec (5 levels, 4 base filters, 5 classes with one left/right pair,
32^3 and 40 x 32 x 48 phantoms), against the plain reference
``benchmark/reference/synthseg.py``:

- each encoder and decoder level, and the whole network, on the
  reference's arithmetic, where the TF32 control does not pass;
- the central padding to multiples of 32 on sides that are not, and the
  percentile normalisation bit for bit (NumPy's ``np.percentile``);
- the flip, the left/right swap and the average against the reference,
  and the flip averaging's exact symmetry;
- the post-process on planted posteriors (two components of one class,
  overlapping masks of two classes, a brain mask with an island) against
  the reference's and against the labels by hand;
- the raw labels against the reference's argmax except at near-ties, and
  the post-processed ones against the reference's post-process of the
  program's own posteriors;
- ``test_scan`` through ``SegmentationEngine`` (serial and pipelined) and
  ``cli infer`` writing ``out_subcortical_seg_prec.nii.gz`` of the input's
  shape; the options the path cannot run raise; the engine's one dispatch
  over the three kinds of network;
- SynthSeg-named state dicts loading with ``strict=True``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import synthseg as ref  # noqa: E402
from benchmark.weights_synthseg import (calibrate, leaf_shapes,  # noqa: E402
                                        make_weights)
from subcort_tpu_torch import cli  # noqa: E402
from subcort_tpu_torch.config import Options  # noqa: E402
from subcort_tpu_torch.engine import SegmentationEngine, infer  # noqa: E402
from subcort_tpu_torch.engine import synthseg  # noqa: E402
from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii  # noqa: E402
from subcort_tpu_torch.models import fastsurfer  # noqa: E402
from subcort_tpu_torch.models import init_params as triplanar_init  # noqa
from subcort_tpu_torch.models.synthseg import (SynthSegSpec,  # noqa: E402
                                               SynthSegUNet, init_params,
                                               num_params, spec_of)

torch.set_num_threads(1)

# one left/right pair (10, 49) and two midline labels
LABELS = (0, 10, 14, 24, 49)
PAIRS = synthseg.LR_PAIRS
CFG = dict(n_levels=5, nb_conv_per_level=2, conv_size=3, unet_feat_count=4,
           feat_multiplier=2, in_channels=1, labels=list(LABELS))
SPEC = SynthSegSpec(base_filters=4, num_classes=len(LABELS))
SHAPE = (40, 32, 48)
# Program against reference, relative to the largest logit: torch's BN
# kernel and BN written out round apart by an ulp, which 18 convolutions
# carry to about 1e-6 of the logits' range; TF32 moves them by over 1e-4.
REL = 1e-5
# Posteriors: the logits' float32 differences through the softmax, about
# 1e-7; TF32's reach 1e-4 and more.
PROB_ATOL = 2e-6


def _phantom(shape, seed):
    rng = np.random.default_rng(seed)
    image = np.zeros(shape, np.int16)
    x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
    c = [s / 2 for s in shape]
    head = sum(((a - ci) / (0.42 * s)) ** 2
               for a, ci, s in zip((x, y, z), c, shape)) < 1
    image[head] = (rng.random(int(head.sum())) * 800 + 100).astype(np.int16)
    return image


@pytest.fixture(scope="module")
def phantom():
    return _phantom(SHAPE, 7)


@pytest.fixture(scope="module")
def cube():
    return _phantom((32, 32, 32), 8)


@pytest.fixture(scope="module")
def params(phantom):
    """The benchmark's seeded weights at the small spec, their BN
    statistics and likelihood bias calibrated on the phantom."""
    p = make_weights(CFG, 31, "cpu")
    calibrate(p, phantom, "cpu")
    return p


@pytest.fixture(scope="module")
def net(params):
    return SynthSegUNet.from_params(params, "cpu")


def volume(seed, shape=(1, 4, 16, 16, 16)):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _close(got, want, rel=REL):
    scale = want.abs().max()
    return bool(((got - want).abs().max() / scale) <= rel)


@pytest.mark.parametrize("name", ["down1", "down3", "down4", "up2", "up0"])
def test_level_matches_reference(net, params, name):
    """One level, at its own input widths; the reference in TF32 does not
    pass the same tolerance."""
    block = getattr(net, name)
    c_in = block.conv0.in_channels
    x = volume(1, (1, c_in, 16, 16, 16))
    got = block(x)
    want = ref.level(params, name, x)
    assert got.shape == want.shape == (1, block.conv0.out_channels,
                                       16, 16, 16)
    assert _close(got, want)
    assert not _close(ref.level(params, name, x, "tf32"), want)


@pytest.mark.parametrize("weights", ["calibrated", "init_params"])
def test_network_matches_reference(net, params, weights):
    """The whole network on the calibrated weights and on
    :func:`init_params`'s draws."""
    if weights == "init_params":
        net = SynthSegUNet.from_params(init_params(
            SPEC, torch.Generator().manual_seed(5)), "cpu")
    p = net.state_dict()
    x = volume(2, (1, 1, 32, 32, 48))
    got = net(x)
    want = ref.forward(p, x)
    assert got.shape == (1, len(LABELS), 32, 32, 48)
    assert _close(got, want)
    assert not _close(ref.forward(p, x, "tf32"), want)


def test_the_published_widths():
    assert num_params() == 13_242_849
    assert [SynthSegSpec().filters(k) for k in range(5)] == \
        [24, 48, 96, 192, 384]


def test_padding_to_multiples_of_32(phantom):
    vol = torch.from_numpy(phantom.astype(np.float32))
    got, offsets = synthseg.pad(vol, 32)
    want, want_off = ref.pad(phantom.astype(np.float32), 32)
    assert got.shape == (64, 32, 64) and offsets == want_off == (12, 0, 8)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["int16", "float32", "constant", "cube"])
def test_normalisation_bit_for_bit(phantom, cube, kind):
    """The clip to the 0.5 and 99.5 percentiles and the map to [0, 1]
    equal NumPy's on the volume in float64, bit for bit; at 32^3 the lower
    percentile's fraction is over one half and the upper's under (both of
    NumPy's branches)."""
    image = {"int16": phantom, "cube": cube,
             "float32": phantom.astype(np.float32) * np.float32(0.37) + 3.1,
             "constant": np.full(SHAPE, 5, np.int16)}[kind]
    raw = torch.from_numpy(image)
    got = synthseg.normalize(raw)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref.normalize(image))
    lo, hi = synthseg.percentile_range(torch.sort(raw.reshape(-1)).values)
    wide = image.astype(np.float64)
    assert (lo, hi) == (np.percentile(wide, 0.5), np.percentile(wide, 99.5))
    if kind == "cube":
        n = image.size - 1
        assert 0.005 * n % 1 > 0.5 > 0.995 * n % 1


def test_the_tables():
    assert len(synthseg.LABELS) == 33 and list(synthseg.LABELS) == sorted(
        synthseg.LABELS)
    perm = synthseg.lr_permutation()
    assert sorted(perm) == list(range(33))
    assert all(perm[perm[i]] == i for i in range(33))
    lab = synthseg.LABELS
    assert sum(perm[i] != i for i in range(33)) == 28
    assert lab[perm[lab.index(17)]] == 53 and lab[perm[lab.index(60)]] == 28
    assert perm == tuple(ref.lr_swap(lab, PAIRS))
    struct = synthseg.structure_of()
    assert sorted(s for s in struct if s) == list(range(1, 15))
    assert synthseg.lr_permutation(LABELS) == (0, 4, 2, 3, 1)


def test_flip_swap_and_average_match_reference(net, params, phantom):
    """``P`` against the reference's, whose TF32 control does not pass;
    the single forwards it averages differ from it by far more."""
    got, offsets = synthseg.flip_averaged_posteriors(net, phantom, (1, 1, 1),
                                                     "cpu", LABELS)
    want, want_off = ref.posteriors(params, phantom, LABELS, PAIRS, "cpu")
    assert offsets == want_off == (12, 0, 8)
    assert got.shape == (len(LABELS), 64, 32, 64)
    torch.testing.assert_close(got.sum(0), torch.ones(64, 32, 64),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(got, want, rtol=0, atol=PROB_ATOL)
    low, _ = ref.posteriors(params, phantom, LABELS, PAIRS, "cpu", "tf32")
    assert (low - want).abs().max() > 10 * PROB_ATOL
    x = torch.from_numpy(ref.pad(ref.normalize(phantom), 32)[0])[None, None]
    one = torch.softmax(net(x), 1)[0]
    assert (one - want).abs().max() > 0.01


def test_flip_averaging_is_symmetric(net, phantom):
    """The flipped scan's ``P`` is the scan's flipped along axis 0 with its
    left/right channels swapped, bit for bit (an even padding excess
    along axis 0)."""
    p, _ = synthseg.flip_averaged_posteriors(net, phantom, (1, 1, 1), "cpu",
                                             LABELS)
    q, _ = synthseg.flip_averaged_posteriors(
        net, np.ascontiguousarray(phantom[::-1]), (1, 1, 1), "cpu", LABELS)
    perm = torch.as_tensor(synthseg.lr_permutation(LABELS))
    assert torch.equal(q, torch.flip(p, (1,))[perm])


def _planted():
    """Posteriors of 5 classes on 20 x 12 x 12 with: class 1 in two
    components (8 and 27 voxels), classes 1 and 3 over 0.25 together on
    part of the larger, and a foreground island away from the brain."""
    shape = (20, 12, 12)
    p = np.zeros((5,) + shape, np.float32)
    p[0] = 1.0
    brain = np.zeros(shape, bool)
    brain[1:13, 1:11, 1:11] = True
    p[0][brain], p[2][brain] = 0.3, 0.7           # class 2 everywhere
    small = (slice(2, 4), slice(2, 4), slice(2, 4))
    large = (slice(6, 9), slice(6, 9), slice(6, 9))
    for sl in (small, large):
        p[:, sl[0], sl[1], sl[2]] = 0
        p[0][sl], p[1][sl] = 0.2, 0.8
    both = (slice(6, 9), slice(6, 8), slice(6, 9))
    p[:, both[0], both[1], both[2]] = 0
    p[0][both], p[1][both], p[3][both] = 0.2, 0.45, 0.35
    island = (slice(16, 18), slice(4, 6), slice(4, 6))
    p[0][island], p[4][island] = 0.3, 0.7
    return p


def test_postprocess_on_planted_posteriors():
    p = _planted()
    classes = tuple(range(5))
    want = ref.postprocess(p, classes)
    prob = torch.from_numpy(p.copy())
    assert synthseg.keep_largest(prob) == 2
    got = (prob / prob.sum(0)).argmax(0).numpy()
    assert np.array_equal(got, want)
    assert (got[2:4, 2:4, 2:4] == 0).all()         # the smaller component
    assert (got[6:9, 6:9, 6:9] == 1).all()         # 0.45 over 0.35
    assert (got[16:18, 4:6, 4:6] == 0).all()       # the island
    rest = np.zeros(got.shape, bool)
    rest[1:13, 1:11, 1:11] = True
    rest[2:4, 2:4, 2:4] = rest[6:9, 6:9, 6:9] = False
    assert (got[rest] == 2).all() and (got[~rest][got[~rest] == 2]).size == 0


def test_labels_match_reference(net, params, phantom):
    """Raw labels equal the reference's argmax wherever its best class
    leads the next by more than 1e-5; the post-processed labels equal the
    reference's post-process of the program's own ``P``; two forwards."""
    before = synthseg.FORWARDS
    raw = synthseg.segment_synthseg(net, phantom, (1, 1, 1), "cpu", LABELS,
                                    post_process=False)
    labels = synthseg.segment_synthseg(net, phantom, (1, 1, 1), "cpu",
                                       LABELS)
    assert synthseg.FORWARDS - before == 4
    assert raw.dtype == labels.dtype == np.uint8
    assert raw.shape == labels.shape == SHAPE
    struct = synthseg.structure_of(LABELS)
    want, off = ref.posteriors(params, phantom, LABELS, PAIRS, "cpu")
    crop = (slice(12, 52), slice(0, 32), slice(8, 56))
    top = torch.topk(want, 2, 0).values[(slice(None),) + crop]
    clear = (top[0] - top[1] > 1e-5).numpy()
    ref_raw = ref.crop_labels(want.argmax(0).numpy(), off, SHAPE, struct)
    assert np.array_equal(raw[clear], ref_raw[clear])
    assert clear.mean() > 0.99
    mine, _ = synthseg.flip_averaged_posteriors(net, phantom, (1, 1, 1),
                                                "cpu", LABELS)
    post = ref.crop_labels(ref.postprocess(mine.numpy(), range(5)), off,
                           SHAPE, struct)
    assert np.array_equal(labels, post)
    assert len(np.unique(raw)) >= 2


@pytest.mark.parametrize("shape,zooms", [
    ((24, 22), (1, 1)), (SHAPE, (1, 1, 1.2)), ((257, 20, 20), (1, 1, 1))])
def test_the_path_refuses(net, shape, zooms):
    with pytest.raises(ValueError, match="SynthSeg"):
        synthseg.segment_synthseg(net, np.zeros(shape, np.int16), zooms,
                                  "cpu", LABELS)


def _write_scans(root: Path, phantom, n=2):
    for i in range(n):
        sub = root / f"s{i:02d}"
        sub.mkdir(parents=True)
        save_nii(NiftiImage(np.roll(phantom, i, 1), np.eye(4)),
                 str(sub / "T1.nii.gz"))


def _five_class(monkeypatch):
    """The path's tables at the small spec's 5 classes."""
    monkeypatch.setattr(synthseg, "LABELS", LABELS)


@pytest.mark.parametrize("pipeline", [False, True])
def test_scan_through_the_engine(tmp_path, monkeypatch, params, net, phantom,
                                 pipeline):
    _five_class(monkeypatch)
    _write_scans(tmp_path, phantom)
    options = Options(mode="cpu", test_folder=str(tmp_path), net_verbose=0,
                      folder_pipeline=pipeline)
    engine = SegmentationEngine(params, options)
    assert isinstance(engine.net, SynthSegUNet)
    assert engine.kind is infer.SYNTHSEG and engine.devices is None
    times = engine.segment_folder()
    assert sorted(times) == ["s00", "s01"]
    for i in range(2):
        sub = tmp_path / f"s{i:02d}"
        assert not (sub / "tmp").exists()
        out = load_nii(str(sub / "out_subcortical_seg_prec.nii.gz")).data
        assert out.shape == SHAPE and out.max() <= 14
        want = synthseg.segment_synthseg(net, np.roll(phantom, i, 1),
                                         (1, 1, 1), "cpu", LABELS)
        assert np.array_equal(out, want)


def test_cli_infer_runs_synthseg_weights(tmp_path, monkeypatch, params,
                                        phantom):
    _five_class(monkeypatch)
    scans = tmp_path / "scans"
    _write_scans(scans, phantom, 1)
    (tmp_path / "w" / "ss").mkdir(parents=True)
    torch.save(params, str(tmp_path / "w" / "ss" / "ss.pt"))
    cfg = tmp_path / "configuration.cfg"
    cfg.write_text(f"[database]\ninference_folder = {scans}\n"
                   "t1_name = T1.nii.gz\n\n[model]\nname = ss\nmode = cpu\n"
                   "net_verbose = 0\n")
    assert cli.main(["infer", "--config", str(cfg), "--weights-path",
                     str(tmp_path / "w")]) == 0
    out = load_nii(str(scans / "s00" / "out_subcortical_seg_prec.nii.gz"))
    assert out.data.shape == SHAPE and out.data.dtype == np.uint8


@pytest.mark.parametrize("key,value", [("out_probabilities", True),
                                       ("data_parallel", 2),
                                       ("compute_dtype", "bfloat16"),
                                       ("bugcompat_postprocess_argmax",
                                        True)])
def test_options_the_path_cannot_run_raise(params, key, value):
    with pytest.raises(ValueError, match=key):
        SegmentationEngine(params, Options(mode="cpu", **{key: value}))


def test_one_dispatch_over_three_kinds(params):
    """The weights pick the kind once; a net picks the same kind."""
    tri = triplanar_init()
    views = {v: fastsurfer.init_params() for v in fastsurfer.VIEWS}
    assert infer.kind_of_params(params) is infer.SYNTHSEG
    assert infer.kind_of_params(tri) is infer.TRIPLANAR
    assert infer.kind_of_params(views) is infer.VIEWS
    for kind in infer.KINDS:
        assert infer.kind_of_net(kind.net_type.__new__(kind.net_type)) \
            is kind
    engine = SegmentationEngine(params, Options(mode="cpu"))
    with pytest.raises(ValueError, match="SynthSeg"):
        engine.predict_proba({})


def test_synthseg_state_dict_loads_strictly():
    """A state dict under the benchmark's list of names (written
    independently of the module) loads strictly; one key missing or one
    too many refuses."""
    shapes = leaf_shapes(CFG)
    assert {"down0.conv0.weight", "down4.bn.running_var", "up0.conv1.bias",
            "up3.bn.weight", "likelihood.weight"} <= set(shapes)
    sd = {k: (torch.zeros(s, dtype=torch.int64) if k.endswith("tracked")
              else torch.rand(s)) for k, s in shapes.items()}
    net = SynthSegUNet.from_params(sd, "cpu")
    assert set(net.state_dict()) == set(sd)
    assert spec_of(sd) == SPEC
    with pytest.raises(RuntimeError):
        SynthSegUNet.from_params({k: v for k, v in sd.items()
                                  if k != "up1.bn.running_mean"}, "cpu")
    with pytest.raises(RuntimeError):
        SynthSegUNet.from_params(dict(sd, extra=torch.zeros(1)), "cpu")
