"""PyTorch port: SwinUNETR and its sliding-window path
(``models/swinunetr.py``, ``engine/swinunetr.py``) on the CPU, seeded, at a
small spec (12 features, 5^3 windows, 64^3 roi), against the plain
reference ``benchmark/reference/swinunetr.py``:

- the window partition and its reverse, the shift mask and the relative
  position index, on grids that pad, shift and clip;
- PatchMerging (MONAI's v1 slice order), a Swin block (unshifted, shifted
  and padded, clipped), both kinds of residual block, and the whole net's
  logits (a stage that pads, shifted blocks that mask, a last stage that
  clips its window), where the TF32 control does not pass;
- ``window_starts`` on 181 / 217 / 181 and on a side under the roi, the
  Gaussian, the normalisation and the blended logits; the labels against
  the reference's post-process of the program's raw labels;
- MONAI-named state dicts loading with ``strict=True``;
- ``test_scan``, ``segment_folder`` (serial and pipelined) and ``cli
  infer`` on a SwinUNETR ``.pt``; the options the path cannot run raise;
- the spans, their attributes and ``WINDOWS``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import swinunetr as ref  # noqa: E402
from subcort_tpu_torch import cli  # noqa: E402
from subcort_tpu_torch.config import Options  # noqa: E402
from subcort_tpu_torch.engine import SegmentationEngine, infer  # noqa: E402
from subcort_tpu_torch.engine import swinunetr  # noqa: E402
from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii  # noqa: E402
from subcort_tpu_torch.models import swinunetr as model  # noqa: E402
from subcort_tpu_torch.models.swinunetr import (SwinUNETR,  # noqa: E402
                                                SwinUNETRSpec, init_params,
                                                num_params, spec_of)
from subcort_tpu_torch.utils import runtime  # noqa: E402

torch.set_num_threads(1)

SPEC = SwinUNETRSpec(feature_size=12, window_size=5)
ROI = 64
# x pads 60 to 64 (1 window); y: 3 windows; z: 2 windows
SHAPE = (60, 100, 70)
# the program against the reference, relative to the largest logit
TOL = 1e-5


@pytest.fixture(autouse=True)
def small_windows(monkeypatch):
    """The path's windows at the small spec: 64^3, two a batch."""
    monkeypatch.setattr(swinunetr, "ROI", ROI)
    monkeypatch.setattr(swinunetr, "SW_BATCH_SIZE", 2)


@pytest.fixture(scope="module")
def params():
    """Seeded weights with every LayerNorm and bias off its initial value
    and bias tables at unit scale, so that none of them is the identity."""
    g = torch.Generator().manual_seed(29)
    p = init_params(SPEC, torch.Generator().manual_seed(3))
    for k, v in p.items():
        if k.endswith("relative_position_bias_table"):
            p[k] = torch.randn(v.shape, generator=g)
        elif v.dim() == 1:
            p[k] = v + 0.1 * torch.randn(v.shape, generator=g)
    return p


@pytest.fixture(scope="module")
def net(params):
    return SwinUNETR.from_params(params, "cpu")


@pytest.fixture(scope="module")
def phantom():
    rng = np.random.default_rng(5)
    image = np.zeros(SHAPE, np.int16)
    x, y, z = np.ogrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    head = ((x - 30) / 26.0) ** 2 + ((y - 50) / 44.0) ** 2 \
        + ((z - 35) / 30.0) ** 2 < 1
    image[head] = (rng.random(int(head.sum())) * 800 + 100).astype(np.int16)
    return image


def _close(got, want, tol=TOL):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) <= tol * scale


# ------------------------------------------------------------ windows
@pytest.mark.parametrize("side,w", [((10, 15, 5), (5, 5, 5)),
                                    ((4, 6, 8), (4, 3, 2))])
def test_window_partition_and_reverse(side, w):
    x = torch.randn((2,) + side + (3,))
    parts = model.window_partition(x, w)
    assert parts.shape == (2 * np.prod(side) // np.prod(w), np.prod(w), 3)
    want = torch.cat([torch.stack(ref.windows(x[i:i + 1], w))
                      for i in range(2)])
    assert torch.equal(parts, want)
    assert torch.equal(model.window_reverse(parts, w, (2,) + side), x)


@pytest.mark.parametrize("padded,w,shift", [
    ((35, 35, 35), (5, 5, 5), (2, 2, 2)),
    ((10, 20, 4), (5, 5, 4), (2, 2, 0)),
    ((21, 21, 21), (7, 7, 7), (3, 3, 3))])
def test_shift_mask_matches_reference(padded, w, shift):
    got = model.shift_mask(padded, w, shift, "cpu")
    want = ref.region_mask(padded, w, shift, "cpu")
    assert torch.equal(got, want)
    assert set(got.unique().tolist()) == {0.0, -100.0}


@pytest.mark.parametrize("window", [3, 5, 7])
def test_relative_position_index_matches_reference(window):
    got = model.relative_position_index(window)
    assert torch.equal(got, torch.from_numpy(ref.rel_index(window)))
    # (dx + w - 1)(2w - 1)^2 + (dy + w - 1)(2w - 1) + (dz + w - 1)
    m = 2 * window - 1
    assert int(got[0, -1]) == 0 and int(got[-1, 0]) == m ** 3 - 1
    assert int(got[0, 0]) == (window - 1) * (m * m + m + 1)


def test_a_clipped_window_reads_the_sliced_index():
    """A window of n < w^3 tokens takes the first n rows and columns of
    the configured window's index, not its own geometry's."""
    attn = model.WindowAttention(12, 3, 5)
    full = model.relative_position_index(5)
    bias = attn.bias(8)
    table = attn.relative_position_bias_table
    assert torch.equal(bias, table[full[:8, :8].reshape(-1)].view(
        8, 8, 3).permute(2, 0, 1))
    assert not torch.equal(full[:8, :8], model.relative_position_index(2))


# ------------------------------------------------------------ layers
def test_patch_merging_matches_reference(params):
    m = model.PatchMerging(12)
    key = "swinViT.layers1.0.downsample"
    m.load_state_dict({k[len(key) + 1:]: v for k, v in params.items()
                       if k.startswith(key)})
    x = torch.randn(1, 9, 8, 7, 12)
    with torch.no_grad():
        got = m(x)
    assert got.shape == (1, 5, 4, 4, 24)
    assert torch.equal(got, ref.merge(params, key, x, "float32"))
    assert model.MERGE_OFFSETS[5] == model.MERGE_OFFSETS[2]


@pytest.mark.parametrize("side,shifted", [((12, 12, 12), False),
                                          ((12, 12, 12), True),
                                          ((12, 6, 4), True)])
def test_swin_block_matches_reference(params, side, shifted):
    """A block whose grid pads (12 -> 15), shifts, and clips an axis."""
    i = int(shifted)
    key = f"swinViT.layers1.0.blocks.{i}"
    blk = model.SwinTransformerBlock(12, 3, 5, shifted, 4.0)
    blk.load_state_dict({k[len(key) + 1:]: v for k, v in params.items()
                         if k.startswith(key)})
    x = torch.randn((1,) + side + (12,))
    w, shift = model.window_and_shift(side, 5, 2 if shifted else 0)
    padded = [-(-s // a) * a for s, a in zip(side, w)]
    mask = model.shift_mask(padded, w, shift, "cpu") if any(shift) else None
    with torch.no_grad():
        got = blk(x, mask)
        want = ref.block(params, key, x, 3, 5, shifted, "float32")
        low = ref.block(params, key, x, 3, 5, shifted, "tf32")
    # the block's update, which the residual would hide
    assert _close(got - x, want - x)
    assert not _close(low - x, want - x)


@pytest.mark.parametrize("name,c_in,c_out", [("encoder1.layer", 1, 12),
                                             ("encoder2.layer", 12, 12)])
def test_res_block_matches_reference(params, name, c_in, c_out):
    """With its 1x1 residual (widths differ) and without."""
    blk = model.UnetResBlock(c_in, c_out)
    blk.load_state_dict({k[len(name) + 1:]: v for k, v in params.items()
                         if k.startswith(name)})
    assert blk.residual == (c_in != c_out)
    x = torch.randn(2, c_in, 16, 12, 8)
    with torch.no_grad():
        assert _close(blk(x), ref.res_block(params, name, x, "float32"))


@pytest.mark.parametrize("shape", [(64, 64, 64), (64, 64, 32)])
def test_network_matches_reference(net, params, shape):
    """64^3: stage sides 32, 16, 8 pad to 35, 20, 10 and shifted blocks
    mask; the last stage's 4 < 5 clips its window (and 64 x 64 x 32 clips
    one axis sooner)."""
    x = torch.randn((1, 1) + shape, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = net(x)
        want = ref.forward(params, x)
        low = ref.forward(params, x, "tf32")
    assert got.shape == (1, 15) + shape
    assert _close(got, want)
    assert not _close(low, want, 1e-4)


def test_the_published_widths():
    spec = SwinUNETRSpec()
    assert (spec.feature_size, spec.depths, spec.num_heads,
            spec.window_size, spec.patch_size, spec.mlp_ratio) == (
        48, (2, 2, 2, 2), (3, 6, 12, 24), 7, 2, 4.0)
    assert num_params(spec) == 62_187_345
    assert spec_of(init_params(SPEC)) == SPEC


# ------------------------------------------------------------ the scan
def test_window_starts():
    assert swinunetr.axis_starts(181) == [0, 53]
    assert swinunetr.axis_starts(217) == [0, 64, 89]
    assert swinunetr.axis_starts(128) == [0]
    starts = swinunetr.window_starts((181, 217, 181))
    assert len(starts) == 12 and starts[:3] == [(0, 0, 0), (0, 0, 53),
                                                (0, 64, 0)]
    assert swinunetr.window_starts((100, 128, 129)) == [(0, 0, 0),
                                                        (0, 0, 1)]
    for s in (100, 128, 129, 181, 192, 217, 256):
        assert swinunetr.axis_starts(max(s, 128)) == ref.starts(
            max(s, 128), 128, 0.5)
    assert ref.window_count((181, 217, 181)) == 12


def test_gaussian_matches_reference():
    got = swinunetr.gaussian(128)
    want = torch.from_numpy(ref.weights(128))
    assert got.shape == (128, 128, 128)
    assert float(got.max()) == 1.0
    assert float(got.min()) == float(torch.tensor(1e-3))
    assert torch.allclose(got, want, rtol=1e-6, atol=0)
    # sigma 16 about the centre 63.5
    p = torch.tensor([63.0, 64.0, 0.0])
    g = torch.exp(-(p - 63.5) ** 2 / 512)
    assert torch.allclose(got[63, 64, 63:65], (g[0] * g[1] * g[:2]
                                               / g[0] ** 3))


def test_normalisation_matches_reference(phantom):
    got = swinunetr.normalize(torch.from_numpy(phantom))
    want = torch.from_numpy(ref.normalize(phantom))
    assert torch.equal(got == 0, torch.from_numpy(phantom == 0))
    assert torch.allclose(got, want, rtol=0, atol=2e-7)
    assert torch.equal(swinunetr.normalize(torch.zeros(4, 4, 4,
                                                       dtype=torch.int16)),
                       torch.zeros(4, 4, 4))
    flat = torch.full((3, 3, 3), 7, dtype=torch.int16)
    assert torch.equal(swinunetr.normalize(flat), torch.zeros(3, 3, 3))


def test_blended_logits_and_labels_match_reference(net, params, phantom):
    logits = swinunetr.blended_logits(net, phantom, (1, 1, 1), "cpu")
    want = ref.blended_logits(params, phantom, "cpu", ROI, 0.5)
    assert logits.shape == (15,) + SHAPE
    assert _close(logits, want)
    assert ref.logit_gap(want, logits.argmax(0)) <= 1e-5
    labels = swinunetr.segment_swinunetr(net, phantom, (1, 1, 1), "cpu")
    assert labels.shape == SHAPE and labels.dtype == np.uint8
    assert np.array_equal(labels, ref.labels(logits))
    raw = swinunetr.segment_swinunetr(net, phantom, (1, 1, 1), "cpu",
                                      post_process=False)
    assert np.array_equal(raw, ref.labels(logits, post_process=False))
    assert len(np.unique(raw)) > 3
    on_device = swinunetr.segment_swinunetr(net, phantom, (1, 1, 1), "cpu",
                                            cc_backend="device")
    assert np.array_equal(on_device, labels)


def test_the_path_refuses(net, phantom):
    with pytest.raises(ValueError, match="1 mm"):
        swinunetr.segment_swinunetr(net, phantom, (1, 1, 1.5), "cpu")
    with pytest.raises(ValueError, match="256"):
        swinunetr.segment_swinunetr(net, np.zeros((300, 8, 8), np.int16),
                                    (1, 1, 1), "cpu")
    with pytest.raises(ValueError, match="the net is on"):
        swinunetr.segment_swinunetr(net, phantom, (1, 1, 1), "meta")


# ------------------------------------------------------------ loading
def test_monai_named_state_dict_loads_strictly(params):
    monai = dict(params)
    for k in params:
        if k.endswith("relative_position_bias_table"):
            monai[k.replace("bias_table", "index")] = \
                model.relative_position_index(5)
    net = SwinUNETR(SPEC)
    net.load_state_dict(monai, strict=True)
    assert set(net.state_dict()) == set(params)
    assert "encoder1.layer.conv3.conv.weight" in params
    assert "encoder2.layer.conv3.conv.weight" not in params
    assert all(k in params for k in (
        "swinViT.layers1.0.blocks.0.attn.qkv.weight",
        "swinViT.layers4.0.downsample.reduction.weight",
        "decoder5.transp_conv.conv.weight", "out.conv.conv.weight",
        "out.conv.conv.bias"))
    bad = dict(monai)
    key = "swinViT.layers1.0.blocks.0.attn.relative_position_index"
    bad[key] = monai[key].flip(0)
    with pytest.raises(ValueError, match="index"):
        SwinUNETR(SPEC).load_state_dict(bad, strict=True)
    extra = dict(params, stray=torch.zeros(1))
    with pytest.raises(RuntimeError):
        SwinUNETR(SPEC).load_state_dict(extra, strict=True)


# ------------------------------------------------------------ the engine
def _folder(root, image, n=2):
    for i in range(n):
        sub = root / f"s{i}"
        sub.mkdir(parents=True)
        save_nii(NiftiImage(np.roll(image, i, 1), np.eye(4)),
                 str(sub / "T1.nii.gz"))


@pytest.mark.parametrize("pipelined", [False, True])
def test_scan_through_the_engine(tmp_path, params, net, phantom,
                                 pipelined):
    _folder(tmp_path, phantom)
    engine = SegmentationEngine(params, Options(
        mode="cpu", test_folder=str(tmp_path), net_verbose=0, debug=False,
        folder_pipeline=pipelined))
    assert engine.kind is infer.SWINUNETR
    got = {}
    times = engine.segment_folder(
        on_raw_labels=lambda s, lab: got.__setitem__(s, lab.copy()))
    assert sorted(times) == sorted(got) == ["s0", "s1"]
    for i in range(2):
        out = load_nii(str(tmp_path / f"s{i}" /
                           "out_subcortical_seg_prec.nii.gz")).data
        want = swinunetr.segment_swinunetr(net, np.roll(phantom, i, 1),
                                           (1, 1, 1), "cpu")
        assert np.array_equal(out, want)
        assert np.array_equal(got[f"s{i}"], want)
    infer.test_scan(engine.net, str(tmp_path / "s0" / "T1.nii.gz"),
                    Options(mode="cpu", net_verbose=0, debug=False,
                            post_process=False))
    raw = load_nii(str(tmp_path / "s0" /
                       "out_subcortical_rawseg.nii.gz")).data
    assert np.array_equal(raw, swinunetr.segment_swinunetr(
        net, phantom, (1, 1, 1), "cpu", post_process=False))


def test_cli_infer_runs_swinunetr_weights(tmp_path, params, net, phantom):
    _folder(tmp_path / "scans", phantom, 1)
    (tmp_path / "w" / "sw").mkdir(parents=True)
    torch.save(params, str(tmp_path / "w" / "sw" / "sw.pt"))
    cfg = tmp_path / "configuration.cfg"
    cfg.write_text(f"[database]\ninference_folder = {tmp_path / 'scans'}\n"
                   "t1_name = T1.nii.gz\n\n[model]\nname = sw\nmode = cpu\n"
                   "net_verbose = 0\ndebug = False\n")
    assert cli.main(["infer", "--config", str(cfg), "--weights-path",
                     str(tmp_path / "w")]) in (0, None)
    out = load_nii(str(tmp_path / "scans" / "s0" /
                       "out_subcortical_seg_prec.nii.gz")).data
    assert np.array_equal(out, swinunetr.segment_swinunetr(
        net, phantom, (1, 1, 1), "cpu"))


@pytest.mark.parametrize("key,value", [("out_probabilities", True),
                                       ("data_parallel", 2),
                                       ("compute_dtype", "bfloat16"),
                                       ("bugcompat_postprocess_argmax",
                                        True)])
def test_options_the_path_cannot_run_raise(params, key, value):
    with pytest.raises(ValueError, match="SwinUNETR's path"):
        SegmentationEngine(params, Options(mode="cpu", **{key: value}))


def test_one_dispatch_over_four_kinds(params):
    assert infer.KINDS.index(infer.SWINUNETR) == \
        infer.KINDS.index(infer.TRIPLANAR) - 1
    assert infer.kind_of_params(params) is infer.SWINUNETR
    assert infer.kind_of_net(SwinUNETR(SPEC, device="meta")) is \
        infer.SWINUNETR
    assert not model.is_swinunetr_params({"down0.conv0.weight": 0})


# ------------------------------------------------------------ spans
def test_spans_their_attributes_and_windows(net, phantom):
    """One ``swinunetr.segment`` root; upload, normalize, a forward and a
    blend per batch (6 windows at batch 2), the labels and the read-back
    under it, in order; every forward's encoder and decoder milliseconds
    set; ``WINDOWS`` up by 6."""
    before = swinunetr.WINDOWS
    runtime.clear_records()
    try:
        with runtime.recording():
            labels = swinunetr.segment_swinunetr(
                net, phantom, (1, 1, 1), "cpu", cc_backend="device")
        recs = runtime.records()
    finally:
        runtime.clear_records()
    assert swinunetr.WINDOWS - before == 6
    root = [r for r in recs if r.name == "swinunetr.segment"]
    assert len(root) == 1
    kids = sorted((r for r in recs if r.parent == root[0].id),
                  key=lambda r: r.start_ns)
    assert [r.name for r in kids] == [
        "swinunetr.upload", "swinunetr.normalize"] + [
        "swinunetr.forward", "swinunetr.blend"] * 3 + [
        "swinunetr.labels", "swinunetr.readback"]
    assert all(r.request == root[0].request for r in recs)
    by = {}
    for r in kids:
        by.setdefault(r.name, []).append(r)
    assert [r.attrs["windows"] for r in by["swinunetr.forward"]] == [2] * 3
    assert all(r.attrs["encoder_ms"] > 0 and r.attrs["decoder_ms"] > 0
               for r in by["swinunetr.forward"])
    assert by["swinunetr.upload"][0].attrs["bytes"] == phantom.nbytes
    assert by["swinunetr.normalize"][0].attrs["voxels"] == phantom.size
    assert by["swinunetr.readback"][0].attrs["bytes"] == labels.nbytes
    filt = [r for r in recs if r.name == "postprocess.filter"]
    assert len(filt) == 1 and filt[0].parent == by["swinunetr.labels"][0].id
    assert filt[0].attrs == {"voxels": phantom.size, "on_card": 0}


def test_nothing_records_untraced(net, phantom):
    runtime.clear_records()
    swinunetr.segment_swinunetr(net, phantom, (1, 1, 1), "cpu")
    assert not [r for r in runtime.records()
                if r.name.startswith("swinunetr.")]
