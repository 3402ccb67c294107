"""PyTorch port: FastSurferCNN's three view networks and the multi-view
path (``models/fastsurfer.py``, ``engine/views.py``) on the CPU, seeded, at
a small spec (8 filters, 32 x 32 slices of a phantom of at most 24 a side),
against the plain reference ``benchmark/reference/fastsurfer.py``:

- each block (the input block, a dense block, an encoder, a decoder) and
  the whole network on the reference's arithmetic;
- max-pool indices and unpool at maxima in odd rows and columns;
- thick slices at both edges of each view's axis;
- the conform's padding, its intensity map bit for bit, and its refusals;
- the aggregation with both tables, and ``segment_views``'s labels against
  the reference's argmax except at near-ties;
- ``test_scan`` through ``SegmentationEngine`` (serial and pipelined) and
  ``cli infer`` writing ``out_subcortical_seg_prec.nii.gz`` of the input's
  shape; the options the path cannot run raise;
- FastSurfer-named state dicts loading with ``strict=True``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import fastsurfer as ref  # noqa: E402
from benchmark.reference import postprocess as ref_post  # noqa: E402
from benchmark.weights_fastsurfer import (calibrate, leaf_shapes,  # noqa
                                          make_weights)
from subcort_tpu_torch import cli  # noqa: E402
from subcort_tpu_torch.config import Options  # noqa: E402
from subcort_tpu_torch.engine import SegmentationEngine, views  # noqa: E402
from subcort_tpu_torch.engine.postprocess import \
    post_process_segmentation  # noqa: E402
from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii  # noqa: E402
from subcort_tpu_torch.models import fastsurfer  # noqa: E402
from subcort_tpu_torch.models.fastsurfer import (FastSurferCNN,  # noqa: E402
                                                 FastSurferSpec,
                                                 FastSurferViews,
                                                 init_params)

torch.set_num_threads(1)

SPEC = FastSurferSpec(num_filters=8)
SIZE = 32
SHAPE = (24, 22, 20)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params(phantom):
    """The benchmark's seeded weights at the small spec, their BN
    statistics and classifier bias calibrated on the phantom."""
    cfg = dict(num_filters=8, kernel_h=5, num_channels=7, num_classes=79,
               num_classes_sagittal=51)
    p = make_weights(cfg, 23, "cpu")
    calibrate(p, cfg, phantom, "cpu", 23, n=8, size=SIZE)
    return p


@pytest.fixture(scope="module")
def nets(params):
    return FastSurferViews.from_params(params, "cpu")


@pytest.fixture(scope="module")
def phantom():
    rng = np.random.default_rng(7)
    image = np.zeros(SHAPE, np.int16)
    x, y, z = np.ogrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    brain = (((x - 12) / 10) ** 2 + ((y - 11) / 9) ** 2
             + ((z - 10) / 8) ** 2) < 1
    image[brain] = (rng.random(int(brain.sum())) * 800 + 100).astype(np.int16)
    return image


def slices(n=3, c=7, side=SIZE, seed=0):
    return torch.rand((n, c, side, side),
                      generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name", ["encode1", "encode2", "bottleneck",
                                  "decode3"])
def test_block_matches_reference(nets, params, name):
    p = {k: v for k, v in params["axial"].items()}
    block = getattr(nets.axial, name)
    x = slices(c=7 if name == "encode1" else 8, side=16, seed=1)
    if name.startswith("decode"):
        pooled, idx = F.max_pool2d(x, 2, 2, return_indices=True)
        got = block(pooled, x, idx)
        up = F.max_unpool2d(pooled, idx, 2, 2, output_size=x.shape[-2:])
        want = ref.block(p, name, torch.maximum(up, x))
    elif name.startswith("encode"):
        pooled, skip, idx = block(x)
        want = ref.block(p, name, x, input_block=name == "encode1")
        torch.testing.assert_close(pooled, F.max_pool2d(want, 2), **TOL)
        got = skip
    else:
        got, want = block(x), ref.block(p, name, x)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("view", ["axial", "sagittal"])
@pytest.mark.parametrize("weights", ["calibrated", "init_params"])
def test_network_matches_reference(nets, params, view, weights):
    """The whole network, on the calibrated weights and on
    :func:`init_params`'s draws, relative to the largest logit: torch's BN
    kernel and the written-out BN round apart by an ulp, which 25
    convolutions carry to about 1e-6 of the logits' range."""
    spec = SPEC if view == "axial" else SPEC.sagittal()
    net = (getattr(nets, view) if weights == "calibrated" else
           FastSurferCNN.from_params(init_params(
               spec, torch.Generator().manual_seed(5)), spec, "cpu"))
    x = slices(seed=2)
    got = net(x)
    want = ref.forward(net.state_dict(), x)
    assert got.shape == (3, spec.num_classes, SIZE, SIZE)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=1e-5)


def test_pool_indices_and_unpool_at_odd_maxima():
    """Maxima at odd rows and columns: the indices point at them, unpool
    puts each value back there and zeros elsewhere, and the decoder's
    maxout with the skip restores the skip."""
    x = torch.rand((2, 3, 8, 8), generator=torch.Generator().manual_seed(3))
    x[..., 1::2, 1::2] += 2.0
    pooled, idx = F.max_pool2d(x, 2, 2, return_indices=True)
    rows, cols = torch.meshgrid(torch.arange(4), torch.arange(4),
                                indexing="ij")
    assert torch.equal(idx[0, 0], (2 * rows + 1) * 8 + 2 * cols + 1)
    up = F.max_unpool2d(pooled, idx, 2, 2, output_size=x.shape[-2:])
    assert torch.equal(up[..., 1::2, 1::2], x[..., 1::2, 1::2])
    assert not up[..., 0::2, :].any() and not up[..., :, 0::2].any()
    assert torch.equal(torch.maximum(up, x), x)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_thick_slices_at_the_edges(axis):
    vol = torch.arange(SIZE ** 3, dtype=torch.float32).reshape((SIZE,) * 3)
    padded = views.view_volume(vol, axis)
    for start, stop in ((0, 4), (SIZE - 4, SIZE)):
        got = views._thick_slices(padded, start, stop)
        torch.testing.assert_close(got, ref.thick_slices(vol, axis, start,
                                                         stop), rtol=0,
                                   atol=0)
    first = views._thick_slices(padded, 0, 1)[0]
    rest = [a for a in range(3) if a != axis]
    plane = vol.permute(axis, *rest)
    assert [int(torch.nonzero(plane == first[c][0, 0])[0, 0])
            for c in range(7)] == [0, 0, 0, 0, 1, 2, 3]


def test_conform_pads_and_maps_like_the_reference(phantom):
    raw = torch.from_numpy(phantom)
    got, offsets = views.conform(raw, SIZE)
    want, want_off = ref.conform(phantom, SIZE)
    assert offsets == want_off == (4, 5, 6)
    assert got.dtype == torch.uint8 and got.shape == (SIZE,) * 3
    assert np.array_equal(got.numpy(), want)
    inside = got.numpy()[4:28, 5:27, 6:26]
    assert got.numpy().sum() == inside.sum() and inside.max() == 255
    # the range: the minimum and the 0.999 quantile of every voxel
    lo, hi = views.conform_range(torch.sort(raw.reshape(-1)).values)
    assert lo == phantom.min() and hi == pytest.approx(
        np.quantile(phantom, 0.999), rel=1e-12)


@pytest.mark.parametrize("shape,zooms", [
    ((24, 22), (1, 1)), ((4, 4, 4, 2), (1, 1, 1)), (SHAPE, (1, 1, 1.2)),
    (SHAPE, (0.9, 1, 1)), ((33, 20, 20), (1, 1, 1))])
def test_conform_refuses(nets, shape, zooms):
    with pytest.raises(ValueError):
        views.segment_views(nets, np.zeros(shape, np.int16), zooms,
                            size=SIZE)


def test_tables():
    s2f, struct = views.SAGITTAL_TO_FULL, views.STRUCTURE_OF
    assert len(s2f) == len(struct) == len(views.FULL_LABELS) == 79
    assert sorted(set(s2f)) == list(range(51))
    full, sag = views.FULL_LABELS, views.SAGITTAL_LABELS
    # a right structure reads the sagittal class of its left partner
    assert sag[s2f[full.index(49)]] == 10 and sag[s2f[full.index(2014)]] \
        == 1014 and sag[s2f[full.index(16)]] == 16
    assert sorted(s for s in struct if s) == list(range(1, 15))
    assert [full[struct.index(c)] for c in range(1, 15)] == list(
        views.STRUCTURE_LABELS)


@pytest.mark.parametrize("tables", ["default", "permuted"])
def test_aggregation_matches_reference(nets, params, phantom, tables):
    rng = np.random.default_rng(11)
    s2f = (views.SAGITTAL_TO_FULL if tables == "default"
           else tuple(int(i) for i in rng.integers(0, 51, 79)))
    got = views.view_probabilities(nets, torch.from_numpy(
        ref.conform(phantom, SIZE)[0]).float() / 255.0, 8, s2f)
    want = ref.aggregate(params, phantom, s2f, "cpu", size=SIZE, block_n=5)
    crop = got[4:28, 5:27, 6:26]
    assert crop.shape == want.shape == SHAPE + (79,)
    # the probabilities carry the logits' float32 differences (above)
    torch.testing.assert_close(crop, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tables", ["default", "reversed"])
def test_labels_match_reference_argmax(nets, params, phantom, tables):
    """Labels equal the reference's structure of its argmax wherever P's
    best class leads the next by more than 1e-5 (a near-tie may go either
    way), and the reference's gap of the labels is under 1e-5."""
    s2f = views.SAGITTAL_TO_FULL
    struct = (views.STRUCTURE_OF if tables == "default"
              else views.STRUCTURE_OF[::-1])
    before = views.SLICES
    labels = views.segment_views(nets, phantom, (1, 1, 1), batch=8,
                                 sagittal_to_full=s2f, structure_of=struct,
                                 size=SIZE)
    assert views.SLICES - before == 3 * SIZE
    assert labels.dtype == np.uint8 and labels.shape == SHAPE
    prob = ref.aggregate(params, phantom, s2f, "cpu", size=SIZE)
    want = ref.labels_of(prob, struct)
    top = torch.topk(prob, 2, -1).values
    clear = (top[..., 0] - top[..., 1] > 1e-5).numpy()
    assert np.array_equal(labels[clear], want[clear])
    assert (labels != want).mean() < 0.01
    assert float(ref.label_gaps(prob, labels, struct).max()) < 1e-5
    assert len(np.unique(labels)) > 3


def _write_scans(root: Path, phantom, n=2):
    for i in range(n):
        sub = root / f"s{i:02d}"
        sub.mkdir(parents=True)
        save_nii(NiftiImage(np.roll(phantom, i, 0), np.eye(4)),
                 str(sub / "T1.nii.gz"))


@pytest.mark.parametrize("pipeline", [False, True])
def test_scan_through_the_engine(tmp_path, monkeypatch, params, phantom,
                                 nets, pipeline):
    monkeypatch.setattr(views, "SIZE", SIZE)
    _write_scans(tmp_path, phantom)
    options = Options(mode="cpu", test_folder=str(tmp_path), net_verbose=0,
                      folder_pipeline=pipeline)
    engine = SegmentationEngine(params, options)
    assert isinstance(engine.net, FastSurferViews)
    times = engine.segment_folder()
    assert sorted(times) == ["s00", "s01"]
    for i in range(2):
        sub = tmp_path / f"s{i:02d}"
        assert not (sub / "tmp").exists()
        out = load_nii(str(sub / "out_subcortical_seg_prec.nii.gz")).data
        assert out.shape == SHAPE and out.max() <= 14
        raw = views.segment_views(nets, np.roll(phantom, i, 0), (1, 1, 1),
                                  size=SIZE)
        want = ref_post.keep_components(raw, np.ones(SHAPE, bool))
        assert np.array_equal(out, want)
        assert np.array_equal(out, post_process_segmentation(
            None, raw, atlas_mask=np.ones(SHAPE, bool), cc_backend="scipy"))


def test_cli_infer_runs_fastsurfer_weights(tmp_path, monkeypatch, params,
                                           phantom):
    monkeypatch.setattr(views, "SIZE", SIZE)
    scans = tmp_path / "scans"
    _write_scans(scans, phantom, 1)
    (tmp_path / "w" / "fs").mkdir(parents=True)
    torch.save(params, str(tmp_path / "w" / "fs" / "fs.pt"))
    cfg = tmp_path / "configuration.cfg"
    cfg.write_text(f"[database]\ninference_folder = {scans}\n"
                   "t1_name = T1.nii.gz\n\n[model]\nname = fs\nmode = cpu\n"
                   "net_verbose = 0\npost_process = False\n")
    assert cli.main(["infer", "--config", str(cfg), "--weights-path",
                     str(tmp_path / "w")]) == 0
    out = load_nii(str(scans / "s00" / "out_subcortical_rawseg.nii.gz"))
    assert out.data.shape == SHAPE and out.data.dtype == np.uint8


@pytest.mark.parametrize("key,value", [("out_probabilities", True),
                                       ("data_parallel", 2),
                                       ("compute_dtype", "bfloat16"),
                                       ("bugcompat_postprocess_argmax",
                                        True)])
def test_options_the_path_cannot_run_raise(params, key, value):
    with pytest.raises(ValueError, match=key):
        SegmentationEngine(params, Options(mode="cpu", **{key: value}))


def test_fastsurfer_state_dict_loads_strictly():
    """A state dict under FastSurfer's own names (the benchmark's list of
    them, written independently of the module) loads strictly; one key
    missing or one too many refuses."""
    cfg = dict(num_filters=8, kernel_h=5, num_channels=7)
    shapes = leaf_shapes(cfg, 79)
    assert {"encode1.conv0.weight", "encode1.bn0.running_mean",
            "encode1.prelu.weight", "decode1.bn3.running_var",
            "classifier.conv.weight"} <= set(shapes)
    sd = {k: (torch.zeros(s, dtype=torch.int64) if k.endswith("tracked")
              else torch.rand(s)) for k, s in shapes.items()}
    net = FastSurferCNN.from_params(sd, SPEC, "cpu")
    assert set(net.state_dict()) == set(sd)
    assert fastsurfer.spec_of(sd) == SPEC
    with pytest.raises(RuntimeError):
        FastSurferCNN.from_params({k: v for k, v in sd.items()
                                   if k != "encode2.prelu.weight"}, SPEC,
                                  "cpu")
    with pytest.raises(RuntimeError):
        FastSurferCNN.from_params(dict(sd, extra=torch.zeros(1)), SPEC, "cpu")
