"""The benchmark's frozen copies equal the program's originals on fixed
inputs, and its FLOP counts give the published numbers."""

import json

import numpy as np
import torch
from tiny import ROOT

from benchmark import frozen, harness, weights


def test_make_scan_is_the_programs():
    from subcort_tpu_torch.bench.scan import make_scan
    want = make_scan(np.random.default_rng(7))
    got = frozen.make_scan(np.random.default_rng(7))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(frozen.candidates(got[2])) == 204_403


def test_slab_flops_is_the_programs():
    from subcort_tpu_torch.models.fcn import slab_flops
    image, _, roi = frozen.make_scan(np.random.default_rng(0))
    c = frozen.candidates(roi)
    lo, dims = frozen.bbox_of(c, image.shape)
    assert dims == (80, 96, 80) and list(lo) == [53, 67, 55]
    assert frozen.slab_flops(dims, len(c)) == 780_233_270_760
    assert frozen.slab_flops(dims, len(c)) == slab_flops(dims, m_rows=len(c))
    cfg = json.load(open(ROOT / "benchmark/configs/triplanar_dense.json"))
    flops = harness.load_module(ROOT / "benchmark/configs/triplanar_dense.py")
    assert flops.scan_flops(cfg, c, image.shape) == 780_233_270_760


def test_bbox_and_split_are_the_programs():
    from subcort_tpu_torch.engine.infer import _bbox_of
    from subcort_tpu_torch.engine.train import train_split_stratified
    rng = np.random.default_rng(3)
    c = rng.integers(0, 60, (500, 3)).astype(np.int32)
    for got, want in zip(frozen.bbox_of(c, (64, 70, 66)),
                         _bbox_of(c, (64, 70, 66))):
        np.testing.assert_array_equal(got, want)
    labels = rng.integers(0, 15, 1000)
    for got, want in zip(frozen.train_split_stratified(labels, 0.25),
                         train_split_stratified(labels, 0.25)):
        np.testing.assert_array_equal(got, want)


def test_gather_bytes_are_the_programs():
    from subcort_tpu_torch.ops.gather_kernel import (gather_roofline_bytes,
                                                     window_index)
    gen = torch.Generator().manual_seed(1)
    shape = (3, 52, 60, 50)
    c = torch.stack([torch.randint(0, 3, (300,), generator=gen)]
                    + [torch.randint(0, s - 32, (300,), generator=gen)
                       for s in shape[1:]], 1).int()
    assert torch.equal(frozen.window_index(c, shape), window_index(c, shape))
    assert frozen.gather_roofline_bytes(c, shape) == \
        gather_roofline_bytes(c, shape)


def test_patch_and_train_flops():
    cfg = json.load(open(ROOT / "benchmark/configs/triplanar_patch.json"))
    flops = harness.load_module(ROOT / "benchmark/configs/triplanar_patch.py")
    assert frozen.patch_forward_flops() == (35_407_800, 972_000)
    assert flops.forward_flops(cfg) == 35_407_800
    assert flops.train_flops_per_sample(cfg) == 105_251_400
    assert weights.n_leaves(cfg) == 883_455
