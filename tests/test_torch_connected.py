"""PyTorch port: on-device connected components (``ops/connected.py``)
and the post-process's ``cc_backend = "device"``, on the CPU.

The port's ``label_components_device`` against scipy's labeling and the
JAX package's ``label_components_device`` on the same seeded masks:
labels array-equal (both densify in the scan order of each component's
minimum index, as scipy numbers them), counts equal. The serpentine mask of
tests/test_parallel.py exceeds a small sweep budget (warn, fall back to
scipy) and converges with a larger one. ``post_process_segmentation`` is
array-equal between the two backends and to the JAX package's.
"""

import warnings

import numpy as np
import pytest
import torch

from subcort_tpu.engine.postprocess import \
    post_process_segmentation as jax_post_process
from subcort_tpu.ops.connected import \
    label_components_device as jax_label_device
from subcort_tpu_torch.engine.postprocess import post_process_segmentation
from subcort_tpu_torch.ops.connected import (_propagate_min,
                                             label_components_device,
                                             label_components_np)

torch.set_num_threads(1)

CPU = torch.device("cpu")
# one shape for every mask the JAX package labels: each new shape costs
# its jitted 32-sweep loop a compile of about half a minute
SHAPE = (24, 26, 22)


def _serpentine_mask(shape=(2, 10, 10)):
    """tests/test_parallel.py's snake: one 1-voxel-wide component whose
    graph diameter is about its voxel count."""
    m = np.zeros(shape, bool)
    for row in range(shape[1]):
        if row % 2 == 0:
            m[0, row, :] = True
        else:
            m[0, row, -1 if (row // 2) % 2 == 0 else 0] = True
    return m


@pytest.mark.parametrize("seed,p", [(0, 0.12), (1, 0.18), (2, 0.3),
                                    (3, 0.5)])
def test_device_cc_matches_scipy_and_jax(seed, p):
    mask = np.random.default_rng(seed).random(SHAPE) < p
    got, n = label_components_device(mask, device=CPU)
    want, n_np = label_components_np(mask)
    jax_lab, n_jax = jax_label_device(mask)
    assert got.dtype == np.int32 and n == n_np == n_jax > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_lab))


@pytest.mark.parametrize("fill", [False, True])
def test_device_cc_empty_and_full(fill):
    mask = np.full(SHAPE, fill)
    lab, n = label_components_device(mask, device="cpu")
    assert n == int(fill) and (lab == int(fill)).all()
    want, n_jax = jax_label_device(mask)
    assert n_jax == n
    np.testing.assert_array_equal(lab, np.asarray(want))


def test_device_cc_serpentine_exceeds_cap_falls_back():
    """Four sweeps cannot cross the ~100-voxel snake: the converged flag
    is False, and the labeling warns and falls back to scipy."""
    mask = _serpentine_mask()
    _, converged = _propagate_min(torch.from_numpy(mask),
                                  sweeps_per_check=2, max_checks=2)
    assert converged is False
    with pytest.warns(UserWarning, match="sweep cap"):
        lab, n = label_components_device(mask, sweeps_per_check=2,
                                         max_checks=2, device=CPU)
    lab_np, n_np = label_components_np(mask)
    assert n == n_np == 1
    np.testing.assert_array_equal(lab, lab_np)


def test_device_cc_serpentine_converges_with_budget():
    mask = _serpentine_mask()
    roots, converged = _propagate_min(torch.from_numpy(mask),
                                      sweeps_per_check=32, max_checks=8)
    assert converged is True
    assert roots.dtype == torch.int32
    assert set(np.unique(roots.numpy())) == {-1, int(np.flatnonzero(mask)[0])}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        lab, n = label_components_device(mask, device=CPU)
    assert n == 1
    np.testing.assert_array_equal(lab > 0, mask)


def test_device_cc_default_device_is_the_card():
    """``device=None`` means the card: without one it raises from
    select_device, never labels on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        label_components_device(np.ones((4, 4, 4), bool))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_post_process_device_backend_matches_scipy_and_jax(seed):
    """Noisy labels with stray islands, an atlas mask that one class
    misses (its largest component wins): both backends and the JAX
    package's device backend give the same volume. The labels reach every
    face, so the post-process's foreground crop is the whole volume."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 6, SHAPE).astype(np.uint8)
    labels[rng.random(labels.shape) < 0.55] = 0
    labels[labels == 5] = 0
    labels[1:3, 1:3, 1:3] = 5  # a class that never touches the atlas
    labels[[0, -1]] = 1
    labels[:, [0, -1]] = 1
    mask = np.zeros(labels.shape, bool)
    mask[6:14, 5:15, 4:12] = True
    device = post_process_segmentation("", labels, atlas_mask=mask,
                                       cc_backend="device", device=CPU)
    scipy = post_process_segmentation("", labels, atlas_mask=mask)
    want = jax_post_process("", labels, atlas_mask=mask,
                            cc_backend="device")
    assert (device != 0).any()
    np.testing.assert_array_equal(device, scipy)
    np.testing.assert_array_equal(device, want)


def test_post_process_unknown_backend_raises():
    labels = np.ones((4, 4, 4), np.uint8)
    with pytest.raises(ValueError, match="cc_backend"):
        post_process_segmentation("", labels, atlas_mask=labels,
                                  cc_backend="cupy")


def test_label_components_np_reexported_by_postprocess():
    from subcort_tpu_torch.engine import postprocess
    assert postprocess.label_components_np is label_components_np
