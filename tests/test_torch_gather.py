"""PyTorch port: the tri-planar gather (plain version, CUDA wrapper, build).

The port's plain gather is held bit-equal to the JAX package's Pallas
kernel (interpret mode, as tests/test_pallas_gather.py runs it on the CPU)
and to its numpy twin. The CUDA kernel is held bit-equal to the plain
version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from subcort_tpu.engine.train import gather_triplanar_subjects as jax_subjects
from subcort_tpu.ops import pad_volume as jax_pad_volume
from subcort_tpu.ops.pallas_gather import (BLOCK, gather_triplanar_pallas,
                                           make_view_volumes,
                                           make_view_volumes_subjects)
from subcort_tpu.ops.patches import gather_triplanar_np
from subcort_tpu_torch.ops import gather_kernel
from subcort_tpu_torch.ops.gather_kernel import gather_triplanar_cuda
from subcort_tpu_torch.ops.patches import (gather_triplanar,
                                           gather_triplanar_subjects,
                                           pad_volume)
from subcort_tpu_torch.utils import build

torch.set_num_threads(1)

# the corners of tests/test_pallas_gather.py::test_pallas_gather_border_centers
BORDER_SHAPE = (34, 33, 35)
BORDER_CORNERS = [[0, 0, 0], [33, 32, 34], [0, 32, 17], [33, 0, 0]]


def _case(kind, rng):
    if kind == "random":
        vol = rng.standard_normal((40, 36, 28)).astype(np.float32)
        centers = np.stack([rng.integers(0, s, 512) for s in vol.shape],
                           axis=1).astype(np.int32)
    else:
        vol = rng.standard_normal(BORDER_SHAPE).astype(np.float32)
        centers = np.asarray(BORDER_CORNERS * (BLOCK // 4), np.int32)
    return vol, centers


def _subject_case(rng, S=3, shape=(40, 36, 28), n=2 * BLOCK):
    vols = rng.standard_normal((S,) + tuple(s + 32 for s in shape))
    centers = np.stack([rng.integers(0, S, n)]
                       + [rng.integers(0, s, n) for s in shape],
                       axis=1).astype(np.int32)
    return vols.astype(np.float32), centers


@pytest.mark.parametrize("kind", ["random", "border"])
def test_plain_gather_matches_pallas_and_numpy(kind, rng):
    """Bit-equal to the numpy twin on every center, and to the Pallas
    kernel (interpret mode, slow: two BLOCKs of centers) on the first."""
    vol, centers = _case(kind, rng)
    got = gather_triplanar(pad_volume(torch.from_numpy(vol)),
                           torch.from_numpy(centers))
    views = make_view_volumes(jax_pad_volume(jnp.asarray(vol)))
    k = min(len(centers), 2 * BLOCK)
    pallas = gather_triplanar_pallas(*views, jnp.asarray(centers[:k]),
                                     interpret=True)
    twin = gather_triplanar_np(vol, centers)
    for g, p, t in zip(got, pallas, twin):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_array_equal(g[:k].numpy(), np.asarray(p))
        np.testing.assert_array_equal(g.numpy(), t)


def test_plain_gather_subjects_matches_train_gather_and_pallas(rng):
    """Subject-stack mode against engine.train.gather_triplanar_subjects
    and the Pallas kernel's plane-stride mode."""
    vols, centers = _subject_case(rng)
    got = gather_triplanar_subjects(torch.from_numpy(vols),
                                    torch.from_numpy(centers))
    want = jax_subjects(jnp.asarray(vols), jnp.asarray(centers))
    views, strides = make_view_volumes_subjects(jnp.asarray(vols))
    pallas = gather_triplanar_pallas(*views, jnp.asarray(centers),
                                     interpret=True, plane_strides=strides)
    for g, w, p in zip(got, want, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))


@pytest.mark.parametrize("mode", ["single", "subjects"])
def test_wrapper_on_cpu_takes_plain_path(mode, rng):
    """A CPU tensor runs the plain version and never counts a launch."""
    if mode == "single":
        vol, centers = _case("random", rng)
        padded = pad_volume(torch.from_numpy(vol))
        want = gather_triplanar(padded, torch.from_numpy(centers))
    else:
        vols, centers = _subject_case(rng)
        padded = torch.from_numpy(vols)
        want = gather_triplanar_subjects(padded, torch.from_numpy(centers))
    before = gather_kernel.LAUNCHES
    got = gather_triplanar_cuda(padded, torch.from_numpy(centers))
    assert gather_kernel.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad", ["dtype", "centers_dtype", "centers_cols",
                                 "noncontiguous", "too_small"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    padded = torch.zeros((40, 40, 40))
    centers = torch.zeros((4, 3), dtype=torch.int32)
    if bad == "dtype":
        padded = padded.double()
    elif bad == "centers_dtype":
        centers = centers.long()
    elif bad == "centers_cols":
        centers = torch.zeros((4, 4), dtype=torch.int32)
    elif bad == "noncontiguous":
        padded = padded.transpose(0, 2)
    else:
        padded = torch.zeros((40, 40, 31))
    with pytest.raises((TypeError, ValueError)):
        gather_triplanar_cuda(padded, centers)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc on PATH nor under CUDA_HOME: the build raises, no stub."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_library("gather_triplanar", [gather_kernel.SOURCE],
                            build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()
