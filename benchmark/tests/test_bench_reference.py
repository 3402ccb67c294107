"""The plain references agree with the program at a small size on the CPU:
the network in inference and in a train step, and the post-process."""

import json

import numpy as np
import pytest
import torch
from tiny import NARROW, ROOT

from benchmark import frozen, weights
from benchmark.drivers.scan_loop import spec_of
from benchmark.reference import postprocess, triplanar


@pytest.fixture(scope="module")
def cfg():
    with open(ROOT / "benchmark/configs/triplanar_patch.json") as fh:
        return dict(json.load(fh), **NARROW)


def test_inference_matches_the_program(cfg):
    from subcort_tpu_torch.engine.infer import segment_volume
    from subcort_tpu_torch.models import TriPlanarNet
    image, atlas, roi = frozen.make_scan(np.random.default_rng(4),
                                         (40, 48, 40))
    centers = frozen.candidates(roi, 2)
    p = weights.make_weights(cfg, 11, "cpu")
    net = TriPlanarNet.from_params(p, spec_of(cfg), "cpu")
    logits = triplanar.scan_logits(p, cfg, image, atlas, centers, "cpu")
    for engine in ("fcn", "patch"):
        labels, _ = segment_volume(net, image, atlas, centers, engine=engine)
        got = labels[centers[:, 0], centers[:, 1], centers[:, 2]]
        assert (got == logits.argmax(1)).mean() > 0.999


def test_train_steps_match_the_program(cfg):
    from subcort_tpu_torch.engine.train import DeviceAdam, train_step
    from subcort_tpu_torch.models import TriPlanarNet
    gen = torch.Generator().manual_seed(2)
    vols = torch.randn((2, 52, 56, 52), generator=gen)
    c = torch.stack([torch.randint(0, 2, (24,), generator=gen)]
                    + [torch.randint(0, s, (24,), generator=gen)
                       for s in (20, 24, 20)], 1).int()
    labels = torch.randint(0, 15, (24,), generator=gen)
    priors = torch.rand((24, 15), generator=gen)
    p = weights.make_weights(cfg, 12, "cpu")
    net = TriPlanarNet.from_params(p, spec_of(cfg), "cpu", trainable=True)
    opt = DeviceAdam(net.parameters())
    drop = torch.Generator().manual_seed(99)
    batches = [(c[:12], labels[:12], priors[:12]),
               (c[12:], labels[12:], priors[12:])]
    losses = []
    for cc, ll, pp in batches:
        views = triplanar.gather(vols, cc)
        losses.append(float(train_step(net, opt, views, ll, pp, drop)))
    ref_losses, _, after = triplanar.train_steps(
        p, cfg, vols, batches, torch.Generator().manual_seed(99))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    state = net.state_dict()
    for k, v in after[-1].items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_post_process_matches_the_program():
    from subcort_tpu_torch.engine.postprocess import post_process_segmentation
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 15, (30, 32, 28)).astype(np.uint8)
    labels[rng.random(labels.shape) < 0.6] = 0
    roi = np.zeros(labels.shape, bool)
    roi[8:20, 10:24, 6:18] = True
    want = post_process_segmentation(None, labels, atlas_mask=roi)
    np.testing.assert_array_equal(postprocess.keep_components(labels, roi),
                                  want)


def test_tf32_rounds_ten_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0 + 2 ** -12])
    got = triplanar.to_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]
