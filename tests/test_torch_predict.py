"""PyTorch port: the ``net.predict_proba`` / ``net.predict`` migration shims
and the prior-vector gather, against the JAX package's, on the CPU.

The port's ``predict_proba``, ``predict`` and ``predict_proba_chunked``
(``models/triplanar.py``) and ``SegmentationEngine.predict_proba`` /
``predict`` take the JAX package's batches: the framework's keys
(axial/coronal/sagittal/atlas) or the reference's ``in1..in4``, patches as
(N, H, W), (N, H, W, 1) or the reference's (N, 1, H, W). Probabilities
within 1e-5 of the JAX package's ``predict_proba_chunked`` (float32 on both
sides, summation order apart); the last chunk is short instead of padded,
which changes nothing. ``gather_atlas_vectors`` is array-equal to the JAX
package's and to the host twin ``_atlas_vectors_host``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subcort_tpu.models import init_params as jax_init_params
from subcort_tpu.models import predict as jax_predict
from subcort_tpu.models import predict_proba_chunked as jax_predict_chunked
from subcort_tpu.ops.patches import \
    gather_atlas_vectors as jax_gather_atlas_vectors
from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine import SegmentationEngine
from subcort_tpu_torch.engine.infer import _atlas_vectors_host
from subcort_tpu_torch.models import (TriPlanarNet, params_from_jax, predict,
                                      predict_proba, predict_proba_chunked)
from subcort_tpu_torch.ops import gather_atlas_vectors

torch.set_num_threads(1)

N, CHUNK = 50, 24  # three chunks, the last one short
PROBS_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax.random.key(7))


@pytest.fixture(scope="module")
def net(jax_params):
    return TriPlanarNet.from_params(params_from_jax(jax_params),
                                    device="cpu")


def _batch(layout, keys, seed=0):
    rng = np.random.default_rng(seed)
    views = [rng.standard_normal((N, 32, 32)).astype(np.float32)
             for _ in range(3)]
    atlas = rng.random((N, 15)).astype(np.float32)
    atlas /= atlas.sum(1, keepdims=True)
    shaped = {"NHW": lambda v: v, "NHWC": lambda v: v[..., None],
              "NCHW": lambda v: v[:, None]}[layout]
    names = (("axial", "coronal", "sagittal", "atlas") if keys == "framework"
             else ("in1", "in2", "in3", "in4"))
    return dict(zip(names, [shaped(v) for v in views] + [atlas]))


@pytest.mark.parametrize("layout,keys", [("NHW", "framework"),
                                         ("NHWC", "reference"),
                                         ("NCHW", "reference"),
                                         ("NCHW", "framework")])
def test_predict_shims_match_jax(net, jax_params, layout, keys):
    batch = _batch(layout, keys)
    want = np.asarray(jax_predict_chunked(jax_params, batch, chunk=CHUNK))
    got = predict_proba_chunked(net, batch, chunk=CHUNK)
    assert got.shape == (N, 15) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROBS_ATOL)
    whole = predict_proba(net, batch)
    np.testing.assert_allclose(whole.numpy(), got.numpy(), rtol=0, atol=1e-6)
    labels = predict(net, batch)
    want_labels = np.asarray(jax_predict(
        jax_params, {k: jnp.asarray(v) for k, v in
                     _batch("NHW", "framework").items()}))
    assert labels.dtype == torch.int64
    np.testing.assert_array_equal(labels.numpy(), want_labels)


def test_engine_predict_shims(jax_params):
    """``SegmentationEngine.predict_proba`` returns numpy rows equal to the
    module shim's, ``predict`` their argmax; a missing input names its
    keys."""
    engine = SegmentationEngine(params_from_jax(jax_params),
                                Options(mode="cpu"))
    batch = _batch("NCHW", "reference", seed=1)
    probs = engine.predict_proba(batch)
    assert isinstance(probs, np.ndarray) and probs.shape == (N, 15)
    want = np.asarray(jax_predict_chunked(jax_params, batch))
    np.testing.assert_allclose(probs, want, rtol=0, atol=PROBS_ATOL)
    np.testing.assert_array_equal(engine.predict(batch), probs.argmax(1))
    del batch["in4"]
    with pytest.raises(KeyError, match="atlas"):
        engine.predict(batch)


def test_gather_atlas_vectors_matches_jax_and_host_twin():
    rng = np.random.default_rng(3)
    atlas = rng.random((12, 14, 10, 15)).astype(np.float32)
    atlas[rng.random(atlas.shape[:3]) < 0.3] = 0.0  # outside every structure
    centers = np.stack([rng.integers(0, s, 200) for s in atlas.shape[:3]],
                       1).astype(np.int32)
    got = gather_atlas_vectors(torch.from_numpy(atlas),
                               torch.from_numpy(centers))
    want = jax_gather_atlas_vectors(jnp.asarray(atlas), jnp.asarray(centers))
    assert got.shape == (200, 15) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  _atlas_vectors_host(atlas, centers))
    empty = (atlas[tuple(centers.T)].sum(1) == 0)
    assert empty.any() and (got.numpy()[empty, 14] == 1).all()
