"""PyTorch port: the tri-planar gather (plain version, CUDA wrapper, build).

The port's plain gather is held bit-equal to the JAX package's Pallas
kernel (interpret mode, as tests/test_pallas_gather.py runs it on the CPU)
and to its numpy twin. The CUDA kernel is held bit-equal to the plain
version on the card by tests/test_torch_cuda.py. Here, on the CPU, the
kernel's layouts (``prepare_gather_volume``) are read through a plain
model of its TMA boxes, which pins the coordinate convention the kernel
uses, and the byte count of its bound is held to a brute-force union.
"""

import itertools

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
from subcort_tpu_torch.ops.gather_kernel import (GatherVolume,
                                                 gather_roofline_bytes,
                                                 gather_triplanar_cuda,
                                                 prepare_gather_volume,
                                                 window_index)
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


@pytest.mark.parametrize("prepared", [False, True],
                         ids=["padded", "prepared"])
@pytest.mark.parametrize("mode", ["single", "subjects"])
def test_wrapper_on_cpu_takes_plain_path(mode, prepared, rng):
    """A CPU tensor, padded or laid out by prepare_gather_volume, runs the
    plain version and never counts a launch."""
    if mode == "single":
        vol, centers = _case("random", rng)
        padded = pad_volume(torch.from_numpy(vol))
        want = gather_triplanar(padded, torch.from_numpy(centers))
    else:
        vols, centers = _subject_case(rng)
        padded = torch.from_numpy(vols)
        want = gather_triplanar_subjects(padded, torch.from_numpy(centers))
    before = gather_kernel.LAUNCHES
    volume = prepare_gather_volume(padded) if prepared else padded
    got = gather_triplanar_cuda(volume, torch.from_numpy(centers))
    assert gather_kernel.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# unpadded extents whose padded Y' and Z' (73, 65) are not multiples of 4
ODD_SHAPE = (36, 41, 33)
ODD_CORNERS = [[x, y, z] for x in (0, ODD_SHAPE[0] - 1)
               for y in (0, ODD_SHAPE[1] - 1) for z in (0, ODD_SHAPE[2] - 1)]

# the kernel's tensor maps (csrc/gather_triplanar.cu): for each window,
# (layout, box, origin, shift), innermost coordinate first; c = (s, x, y,
# z). A box starts its innermost dim on a 4-float boundary and is 36 wide;
# the window is its rows' floats [shift, shift + 32).
MAPS = {
    "axial": ("zxy", (36, 32, 1, 1),
              lambda s, x, y, z: (y & ~3, x, z + 16, s), lambda c: c[2] & 3),
    "coronal": ("xyz", (36, 1, 32, 1),
                lambda s, x, y, z: (z & ~3, y + 16, x, s), lambda c: c[3] & 3),
    "sagittal": ("xyz", (36, 32, 1, 1),
                 lambda s, x, y, z: (z & ~3, y, x + 16, s), lambda c: c[3] & 3),
}


def _tma_box(layout: torch.Tensor, extents, box, origin) -> torch.Tensor:
    """A tiled TMA load as plain indexing: the box of a 4-D map over
    ``layout`` (outermost dim first; ``extents`` the map's dims, innermost
    first), landed row-major in shared memory as (32, 36): zero where the
    box leaves the map (TMA's bounds fill), which only the innermost dim
    may do, past the window."""
    for o, b, e in zip(origin[1:], box[1:], extents[1:]):
        assert 0 <= o and o + b <= e, "a window left its map"
    assert origin[0] % 4 == 0 and origin[0] + 32 <= extents[0]
    o0, o1, o2, o3 = origin
    b0, b1, b2, b3 = box
    out = torch.zeros((b3, b2, b1, b0), dtype=layout.dtype)
    inner = layout[o3:o3 + b3, o2:o2 + b2, o1:o1 + b1,
                   o0:min(o0 + b0, extents[0])]
    out[..., :inner.shape[-1]] = inner
    return out.reshape(32, 36)


def _read_boxes(vol: GatherVolume, centers: np.ndarray):
    s_, xp, yp, zp = vol.shape
    extents = {"xyz": (zp, yp, xp, s_), "zxy": (yp, xp, zp, s_)}
    out = []
    for name in ("axial", "coronal", "sagittal"):
        layout_name, box, origin, shift = MAPS[name]
        layout = getattr(vol, layout_name)
        windows = []
        for c in centers.tolist():
            c = ([0] if len(c) == 3 else []) + c
            rows = _tma_box(layout, extents[layout_name], box, origin(*c))
            windows.append(rows[:, shift(c):shift(c) + 32])
        out.append(torch.stack(windows))
    return out


@pytest.mark.parametrize("mode", ["single", "subjects"])
def test_prepared_layouts_read_by_the_kernels_boxes(mode, rng):
    """prepare_gather_volume rounds Z' and Y' up to 4 floats with zeros,
    keeps the volume's values in both layouts, and the kernel's box table
    read over them is bit-equal to the plain gather, corners included."""
    vol = rng.standard_normal(ODD_SHAPE).astype(np.float32)
    padded = pad_volume(torch.from_numpy(vol))
    centers = np.concatenate([np.stack([rng.integers(0, s, 40)
                                        for s in ODD_SHAPE], 1),
                              ODD_CORNERS]).astype(np.int32)
    if mode == "subjects":
        padded = torch.stack([padded, -padded, 2 * padded])
        centers = np.concatenate([rng.integers(0, 3, (len(centers), 1)),
                                  centers], 1).astype(np.int32)
    prepared = prepare_gather_volume(padded)
    s_ = 3 if mode == "subjects" else 1
    assert prepared.shape == (s_, 68, 73, 65)
    assert tuple(prepared.xyz.shape) == (s_, 68, 73, 68)
    assert tuple(prepared.zxy.shape) == (s_, 65, 68, 76)
    assert prepared.xyz.is_contiguous() and prepared.zxy.is_contiguous()
    stack = padded if mode == "subjects" else padded[None]
    assert torch.equal(prepared.xyz[..., :65], stack)
    assert torch.equal(prepared.zxy[..., :73], stack.permute(0, 3, 1, 2))
    assert not prepared.xyz[..., 65:].any()
    assert not prepared.zxy[..., 73:].any()
    assert torch.equal(prepared.padded(), padded)
    c = torch.from_numpy(centers)
    want = (gather_triplanar_subjects(padded, c) if mode == "subjects"
            else gather_triplanar(padded, c))
    for g, w in zip(_read_boxes(prepared, centers), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["single", "subjects"])
def test_roofline_bytes_match_a_brute_force_union(mode, rng):
    """Distinct touched voxels x 4 bytes + 12,288 written bytes a center,
    against a Python set of every voxel each window reads; window_index
    is the gather itself."""
    shape = (6, 5, 7)
    padded = torch.from_numpy(rng.standard_normal(
        tuple(d + 32 for d in shape)).astype(np.float32))
    centers = np.stack([rng.integers(0, d, 9) for d in shape], 1)
    if mode == "subjects":
        padded = torch.stack([padded, padded + 1])
        centers = np.concatenate([rng.integers(0, 2, (9, 1)), centers], 1)
    centers = np.concatenate([centers, centers[:2]]).astype(np.int32)
    touched = set()
    for row in centers.tolist():
        s_, (x, y, z) = (row[0] if len(row) == 4 else 0), row[-3:]
        for i, j in itertools.product(range(32), range(32)):
            touched |= {(s_, x + i, y + j, z + 16), (s_, x + i, y + 16, z + j),
                        (s_, x + 16, y + i, z + j)}
    c = torch.from_numpy(centers)
    assert gather_roofline_bytes(c, padded.shape) == (
        4 * len(touched) + 12288 * len(centers))
    assert gather_roofline_bytes(c[:0], padded.shape) == 0
    taken = padded.take(window_index(c, padded.shape))
    want = (gather_triplanar_subjects(padded, c) if mode == "subjects"
            else gather_triplanar(padded, c))
    for k, w in enumerate(want):
        assert torch.equal(taken[:, k], w)


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
