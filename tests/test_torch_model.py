"""PyTorch port: the tri-planar CNN, its importers and device selection.

Params come from the JAX package's ``init_params(jax.random.key(7))`` and
cross over through ``params_from_jax``; inputs are numpy from a seed.
Tolerance: probabilities within 1e-5 absolute — both sides run float32 on
the CPU and differ only in summation order (the reference runs its convs
at ``Precision.HIGHEST``, and the port runs full float32).
"""

import numpy as np
import pytest
import jax
import torch

import lasagne_oracle as oracle
from subcort_tpu.models import apply as jax_apply
from subcort_tpu.models import init_params as jax_init_params
from subcort_tpu.models.importer import save_theano_checkpoint
from subcort_tpu_torch.config import Options, select_device
from subcort_tpu_torch.models import (TriPlanarNet, init_params,
                                      load_theano_checkpoint, num_params,
                                      params_from_jax)

torch.set_num_threads(1)

PROBS_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax.random.key(7))


def _batch(rng, n=64):
    views = [rng.standard_normal((n, 32, 32)).astype(np.float32)
             for _ in range(3)]
    atlas = rng.random((n, 15)).astype(np.float32)
    atlas /= atlas.sum(1, keepdims=True)
    return views, atlas


def _port_probs(params, views, atlas, **kw):
    net = TriPlanarNet.from_params(params, device="cpu")
    with torch.inference_mode():
        out = net(*(torch.from_numpy(v) for v in views),
                  torch.from_numpy(atlas), **kw)
    return out.numpy()


def assert_labels_match(labels, ref_probs, atol=PROBS_ATOL):
    """Labels equal the reference's argmax. A voxel may differ only where
    the reference's top-2 margin is below ``atol`` — a tie within the
    probability tolerance — and the failure message shows those margins."""
    want = np.asarray(ref_probs).argmax(1)
    diff = np.asarray(labels) != want
    if diff.any():
        top2 = np.sort(np.asarray(ref_probs)[diff], axis=1)[:, -2:]
        margins = top2[:, 1] - top2[:, 0]
        assert (margins < atol).all(), (
            f"{int(diff.sum())} labels differ; reference top-2 margins "
            f"there: {margins}")


def test_init_params_count_and_shapes(jax_params):
    """883,455 parameters, and the same keys and shapes as the JAX
    package's init after conversion."""
    params = init_params(generator=torch.Generator().manual_seed(0))
    assert num_params(params) == 883_455
    bridged = params_from_jax(jax_params)
    assert params.keys() == bridged.keys()
    for k in params:
        assert params[k].shape == bridged[k].shape, k
    # Lasagne init: Glorot weights inside their limit, the rest constant
    w = params["axial.conv2.weight"]
    assert w.abs().max() <= np.sqrt(6.0 / (20 * 9 + 20 * 9))
    assert (params["prelu_f1"] == 0.25).all()
    assert (params["coronal.bn3.inv_std"] == 1).all()
    again = init_params(generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(params[k], again[k]) for k in params)


@pytest.mark.parametrize("return_logits", [False, True])
def test_model_matches_jax_apply(jax_params, rng, return_logits):
    """64 random patch batches through both packages."""
    views, atlas = _batch(rng)
    batch = {"axial": views[0], "coronal": views[1], "sagittal": views[2],
             "atlas": atlas}
    want = np.asarray(jax_apply(jax_params, batch,
                                return_logits=return_logits))
    got = _port_probs(params_from_jax(jax_params), views, atlas,
                      return_logits=return_logits)
    assert got.shape == (64, 15) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_ATOL)
    assert_labels_match(got.argmax(1), want)


def test_theano_checkpoint_matches_lasagne_oracle(jax_params, rng, tmp_path):
    """A reference-format pickle (written by the JAX package's exporter)
    loads into the port, equals the JAX bridge exactly, and runs to the
    numpy Lasagne oracle's probabilities."""
    path = tmp_path / "net.pkl"
    save_theano_checkpoint(jax_params, str(path))
    params = load_theano_checkpoint(str(path))
    bridged = params_from_jax(jax_params)
    assert params.keys() == bridged.keys()
    for k in params:
        assert torch.equal(params[k], bridged[k]), k
    views, atlas = _batch(rng, n=16)
    raw = oracle.load_raw(str(path))
    want = oracle.forward(raw, *(v[:, None] for v in views), atlas)
    got = _port_probs(params, views, atlas)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_ATOL)
    assert_labels_match(got.argmax(1), want)


def test_net_build_draws_no_global_randomness():
    torch.manual_seed(3)
    before = torch.get_rng_state()
    TriPlanarNet.from_params(init_params(
        generator=torch.Generator().manual_seed(1)), device="cpu")
    assert torch.equal(torch.get_rng_state(), before)


@pytest.mark.parametrize("mode", ["cpu", "CPU", "cpu0"])
def test_select_device_cpu(mode):
    assert select_device(Options(mode=mode)) == torch.device("cpu")


@pytest.mark.parametrize("mode", ["tpu", "gpu", "cuda", "cuda1"])
def test_select_device_cuda_never_falls_back(mode):
    """Asking for CUDA without a usable device raises; it never returns
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        select_device(Options(mode=mode))


def test_from_params_without_a_device_asks_for_the_card():
    """``from_params`` with no device builds on ``select_device(Options())``,
    cuda:0; without a CUDA device it raises and never falls back to the
    CPU."""
    params = init_params(generator=torch.Generator().manual_seed(1))
    if torch.cuda.is_available():
        net = TriPlanarNet.from_params(params)
        assert next(net.parameters()).device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        TriPlanarNet.from_params(params)

