"""PyTorch port: on-device connected components (``ops/connected.py``)
and the post-process's ``cc_backend = "device"``, on the CPU.

The component filter's plain version (``filter_components`` on CPU
tensors) and ``post_process_segmentation(cc_backend="device",
device="cpu")`` against the host's scipy filter and the JAX package's
post-process, on noisy labels, ties of overlap and of size (the first in
raster order wins), an absent class and a serpentine; ``"auto"`` resolves
to scipy on the CPU.

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
from subcort_tpu_torch.engine import postprocess
from subcort_tpu_torch.engine.postprocess import (post_process_segmentation,
                                                  resolve_cc_backend)
from subcort_tpu_torch.ops import connected
from subcort_tpu_torch.ops.connected import (_propagate_min,
                                             filter_components,
                                             filter_components_plain,
                                             label_components_device,
                                             label_components_np)
from subcort_tpu_torch.utils import runtime

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


# ------------------------------------------------------- the component filter
def _filter_case(case):
    """(labels uint8, atlas bool, keep) of one case of the filter, in
    SHAPE; keep: None, or the voxels of the case's constructed classes
    that must survive (a bool volume, False elsewhere)."""
    rng = np.random.default_rng(11)
    labels = np.zeros(SHAPE, np.uint8)
    atlas = np.zeros(SHAPE, bool)
    atlas[6:18, 5:20, 4:16] = True
    keep = None
    if case == "noisy":
        labels = rng.integers(0, 15, SHAPE).astype(np.uint8)
        labels[rng.random(SHAPE) < 0.5] = 0
    elif case == "overlap_tie":
        # class 3: two components with 4 atlas voxels each; the first in
        # raster order is the smaller and wins
        labels[6, 5:7, 4:6] = 3             # 4 voxels, all in the atlas
        labels[10, 18:21, 14:18] = 3        # 12 voxels, 4 in the atlas
        labels[14, 8, 8] = 3                # 1 atlas voxel
        keep = np.zeros(SHAPE, bool)
        keep[6, 5:7, 4:6] = True
    elif case == "size_tie":
        # class 4 misses the atlas: two components of 6 voxels tie as the
        # largest and the first wins; class 5 misses it too, its largest
        # comes last
        atlas[:] = False
        atlas[0, 0, 0] = True
        labels[2, 2, 2:8] = 4
        labels[20, 2:8, 20] = 4
        labels[9, 9, 9:12] = 4
        labels[1, 20, 1] = 5
        labels[22, 10:17, 3] = 5
        keep = np.zeros(SHAPE, bool)
        keep[2, 2, 2:8] = True
        keep[22, 10:17, 3] = True
    elif case == "absent_class":
        # classes 1, 2 and 9 only; 20 and 255 are no class (num_classes 15)
        labels = rng.choice(np.array([0, 1, 2, 9], np.uint8), SHAPE,
                            p=[0.6, 0.2, 0.1, 0.1])
        labels[3, 3, 3] = 20
        labels[4, 4, 4] = 255
    elif case == "serpentine":
        # one 1-voxel-wide snake of class 2 over a whole plane (a graph
        # diameter of about 280 voxels) touching the atlas at its far end
        # only, against a bar of class 2 with no atlas voxel; noise of
        # class 6 elsewhere
        atlas[:] = False
        snake = np.zeros(SHAPE[1:], bool)
        for row in range(0, SHAPE[1], 2):
            snake[row, :] = True
            if row + 1 < SHAPE[1]:
                snake[row + 1, -1 if (row // 2) % 2 == 0 else 0] = True
        labels[0][snake] = 2
        atlas[0, -1, -3:] = True
        labels[5, 3:20, 7] = 2
        labels[8:] = np.where(rng.random((SHAPE[0] - 8,) + SHAPE[1:]) < 0.3,
                              6, 0)
        keep = np.zeros(SHAPE, bool)
        keep[0][snake] = True
    return labels, atlas, keep


@pytest.mark.parametrize("case", ["noisy", "overlap_tie", "size_tie",
                                  "absent_class", "serpentine"])
def test_filter_components_plain_matches_scipy_and_jax(case):
    """The plain filter and the post-process's device backend on the CPU
    keep the voxels that the host's scipy filter and the JAX package's
    post-process keep."""
    labels, atlas, keep = _filter_case(case)
    want = postprocess._filter_components(labels, atlas, 15)
    got = filter_components(torch.from_numpy(labels),
                            torch.from_numpy(atlas), 15)
    assert got.dtype == torch.uint8 and got.shape == labels.shape
    np.testing.assert_array_equal(got.numpy(), want)
    before = connected.FILTER_LAUNCHES
    device = post_process_segmentation("", labels, atlas_mask=atlas,
                                       cc_backend="device", device=CPU)
    assert connected.FILTER_LAUNCHES == before  # the plain version
    jax = jax_post_process("", labels, atlas_mask=atlas)
    np.testing.assert_array_equal(device, post_process_segmentation(
        "", labels, atlas_mask=atlas, cc_backend="scipy"))
    np.testing.assert_array_equal(device, jax)
    np.testing.assert_array_equal(device, want)
    assert (device != 0).any()
    if keep is not None:
        constructed = np.isin(labels, np.unique(labels[keep]))
        np.testing.assert_array_equal((device != 0) & constructed, keep)
    if case == "absent_class":
        assert set(np.unique(device)) <= {0, 1, 2, 9}
    # a caller's flipped views (negative strides) filter alike
    flipped = post_process_segmentation("", labels[::-1, :, ::-1],
                                        atlas_mask=atlas[::-1, :, ::-1],
                                        cc_backend="device", device=CPU)
    np.testing.assert_array_equal(flipped, postprocess._filter_components(
        labels[::-1, :, ::-1], atlas[::-1, :, ::-1], 15))


def test_filter_components_plain_past_its_cap_falls_back():
    """Two sweeps cannot cross the snake: the plain filter warns and
    returns the scipy filter's result."""
    labels, atlas, _ = _filter_case("serpentine")
    with pytest.warns(UserWarning, match="sweep cap"):
        got = filter_components_plain(torch.from_numpy(labels),
                                      torch.from_numpy(atlas), 15,
                                      sweeps_per_check=1, max_checks=2)
    np.testing.assert_array_equal(
        got.numpy(), postprocess._filter_components(labels, atlas, 15))


def test_cc_backend_auto_is_scipy_on_the_cpu():
    """``"auto"`` resolves to scipy on a CPU device (and, without a card,
    for ``device=None``), and to the device on a CUDA device; the
    post-process's default records ``postprocess.filter`` off the card."""
    assert resolve_cc_backend("auto", CPU) == "scipy"
    assert resolve_cc_backend("auto", "cuda:0") == "device"
    assert resolve_cc_backend("auto", "cuda:0", num_classes=300) == "scipy"
    assert resolve_cc_backend("device", CPU) == "device"
    if not torch.cuda.is_available():
        assert resolve_cc_backend("auto") == "scipy"
    labels, atlas, _ = _filter_case("noisy")
    runtime.clear_records()
    with runtime.recording():
        got = post_process_segmentation("", labels, atlas_mask=atlas,
                                        device=CPU)
        post_process_segmentation("", labels, atlas_mask=atlas,
                                  cc_backend="device", device=CPU)
    recs = [r for r in runtime.records() if r.name == "postprocess.filter"]
    assert [r.attrs for r in recs] == [{"voxels": labels.size,
                                         "on_card": 0}] * 2
    np.testing.assert_array_equal(
        got, postprocess._filter_components(labels, atlas, 15))
