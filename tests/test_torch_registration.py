"""PyTorch port: the registration subsystem (``registration/``: resampling
backend, 12-dof affine, ``register_masks``, atlas assets) against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port, the port on ``"cpu"``; each tolerance is
stated where it is used. Sizes are those of tests/test_registration.py
(36x40x34 to 48x52x44). The FFD and its cost pieces are in
tests/test_torch_ffd.py.
"""

import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from subcort_tpu.io import load_nii as jax_load_nii
from subcort_tpu.registration import atlas as jax_atlas
from subcort_tpu.registration import jax_affine, jax_backend, jax_ffd
from subcort_tpu.registration import register_masks as jax_register_masks
from subcort_tpu_torch.config import Options
from subcort_tpu_torch.engine.data import _configured_register
from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii
from subcort_tpu_torch.registration import (RegistrationError, atlas,
                                            load_cpp_grid,
                                            register_masks,
                                            resample_through_affine,
                                            resample_through_cpp,
                                            torch_affine, torch_backend)
from subcort_tpu_torch.registration.driver import (DEFAULT_ATLAS_DIR,
                                                   _resolve_atlas_dir)
from subcort_tpu_torch.registration.torch_backend import CppGrid
from subcort_tpu_torch.utils import runtime

torch.set_num_threads(1)

# the iteration counts of a level held to the JAX package's: 1, the card's
# eager warm-up, the first that replays a captured iteration, and 5
LEVEL_ITERS = [1, torch_backend.WARMUP_ITERS, torch_backend.WARMUP_ITERS + 1,
               5]

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
needs_native = pytest.mark.skipif(
    not os.path.exists(os.path.join(TOOLS, "reg_resample")),
    reason="native tools not built (cd native && make)")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _save(tmp_path, name, data, affine=None):
    p = str(tmp_path / name)
    save_nii(NiftiImage(np.asarray(data, np.float32), affine), p)
    return p


def _close_grad(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# -------------------------------------------------------- resampling backend
def test_bspline_weights_and_axis_matrices_match():
    """rtol 1e-5, atol 1e-6; both ``vox_offset`` values, per-axis spacing."""
    t = np.linspace(0.0, 1.0, 23, dtype=np.float32)
    np.testing.assert_allclose(
        torch_backend._bspline_weights(_t(t)).numpy(),
        np.asarray(jax_backend._bspline_weights(jnp.asarray(t))),
        rtol=1e-5, atol=1e-6)
    for n, sp, nc, off in ((36, 6.0, 10, 0.0), (18, 3.0, 10, 0.25),
                           (12, 2.5, 9, 0.0), (181, 10.0, 22, 0.0),
                           (90, 5.0, 22, 0.25)):
        got = torch_backend._bspline_axis_matrix(n, sp, nc, off,
                                                 "cpu").numpy()
        want = np.asarray(jax_backend._bspline_axis_matrix(n, sp, nc, off))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("shape,spacing,off", [
    ((20, 22, 18), 4.0, 0.0), ((20, 22, 9), (5.0, 4.0, 2.0), 0.0),
    ((10, 11, 9), 2.0, 0.25)])
def test_bspline_dense_disp_and_world_coords_match(shape, spacing, off):
    """rtol 1e-5, atol 1e-6 (atol 1e-4 on world coordinates near 100)."""
    rng = np.random.default_rng(0)
    full = tuple(2 * s for s in shape) if off else shape
    sp_full = tuple(2 * s for s in torch_backend.spacing3(spacing)) \
        if off else spacing
    nc = jax_ffd._grid_counts(full, sp_full)
    disp = rng.standard_normal(nc + (3,)).astype(np.float32)
    got = torch_backend.bspline_dense_disp(_t(disp), spacing, shape, off)
    want = jax_backend.bspline_dense_disp(jnp.asarray(disp), spacing, shape,
                                          off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    aff = np.diag([1.0, 1.2, 3.0, 1.0]) + 0.0
    aff[:3, :3] += rng.standard_normal((3, 3)) * 0.05
    aff[:3, 3] = [-90.0, 126.0, -72.0]
    got = torch_backend._ref_world_coords(shape, aff, "cpu")
    want = jax_backend._ref_world_coords(shape, aff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("channels", [0, 15])
def test_trilinear_matches_inside_border_and_outside(channels):
    """3-D and 15-channel volumes; coordinates inside, on the border, on
    integer positions and outside: atol 1e-5 of the value range."""
    rng = np.random.default_rng(1)
    shape = (9, 8, 7)
    vol = rng.random(shape + ((channels,) if channels else ())
                     ).astype(np.float32)
    lo, hi = -2.0, np.asarray(shape) + 1.0
    coords = rng.uniform(lo, hi, (400, 3)).astype(np.float32)
    border = np.array([[0, 0, 0], [8, 7, 6], [8.0, 3.5, 6.0], [-1, 0, 0],
                       [9, 7, 6], [-0.5, 2.0, 3.0], [8.5, 7.5, 6.5],
                       [4, 4, 4], [-1.0001, 3, 3]], np.float32)
    coords = np.concatenate([coords, border])
    got = torch_backend._trilinear(_t(vol), _t(coords)).numpy()
    want = np.asarray(jax_backend._trilinear(jnp.asarray(vol),
                                             jnp.asarray(coords)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[-1] == 0).all() and (got[-6] == 0).all()  # outside: zeros


def test_trilinear_gradient_flows_through_the_coordinates_only():
    """The floating image carries no gradient, so autograd builds no
    scatter into it; the coordinates' gradient equals the JAX one."""
    rng = np.random.default_rng(2)
    vol = rng.random((9, 8, 7)).astype(np.float32)
    coords = rng.uniform(-1.0, 8.0, (200, 3)).astype(np.float32)
    c = _t(coords).requires_grad_(True)
    v = _t(vol)
    torch_backend._trilinear(v, c).sum().backward()
    assert v.grad is None and not v.requires_grad
    want = jax.grad(lambda q: jax_backend._trilinear(
        jnp.asarray(vol), q).sum())(jnp.asarray(coords))
    _close_grad(c.grad.numpy(), want, 1e-4)


@pytest.fixture(scope="module")
def oblique_case():
    """A 15-channel floating volume on an oblique, anisotropic grid, a
    reference grid of another shape, a 12-dof affine and a smooth control
    grid."""
    rng = np.random.default_rng(3)
    flo = ndimage.gaussian_filter(rng.random((20, 22, 18, 15)),
                                  (1.5, 1.5, 1.5, 0)).astype(np.float32)
    _, flo_affine, _ = atlas.apply_degradation(
        np.ones((2, 2, 2), np.float32), np.eye(4), "oblique", rng)
    ref_shape = (18, 20, 12)
    ref_affine = np.diag([1.0, 1.0, 1.5, 1.0])
    ref_affine[:3, 3] = [-2.0, 3.0, 4.0]
    A = np.eye(4)
    A[:3, :3] += rng.standard_normal((3, 3)) * 0.04
    A[:3, 3] = [1.5, -1.0, 0.5]
    spacing = (4.0, 4.0, 8.0 / 3.0)
    nc = jax_ffd._grid_counts(ref_shape, spacing)
    disp = ndimage.gaussian_filter(rng.standard_normal(nc + (3,)) * 4.0,
                                   (1, 1, 1, 0)).astype(np.float32)
    return flo, flo_affine, ref_shape, ref_affine, A, disp, spacing


@pytest.mark.parametrize("ndim", [3, 4])
def test_resamplers_match(oblique_case, ndim):
    """resample_through_affine and resample_through_cpp: atol 1e-5 of the
    value range (values lie in [0, 1])."""
    flo, flo_affine, ref_shape, ref_affine, A, disp, spacing = oblique_case
    flo = flo if ndim == 4 else flo[..., 0]
    got = resample_through_affine(flo, flo_affine, A, ref_shape, ref_affine,
                                  device="cpu")
    want = jax_backend.resample_through_affine(flo, flo_affine, A, ref_shape,
                                               ref_affine)
    assert got.shape == ref_shape + flo.shape[3:] and got.dtype == np.float32
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5)
    got = resample_through_cpp(flo, flo_affine,
                               CppGrid(disp, spacing, ref_affine), ref_shape,
                               ref_affine, device="cpu")
    want = jax_backend.resample_through_cpp(
        flo, flo_affine, jax_backend.CppGrid(jnp.asarray(disp), spacing,
                                             ref_affine),
        ref_shape, ref_affine)
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_resamplers_without_a_device_ask_for_the_card(oblique_case):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    flo, flo_affine, ref_shape, ref_affine, A, disp, spacing = oblique_case
    with pytest.raises(RuntimeError, match="CUDA"):
        resample_through_affine(flo, flo_affine, A, ref_shape, ref_affine)
    with pytest.raises(RuntimeError, match="CUDA"):
        resample_through_cpp(flo, flo_affine,
                             CppGrid(disp, spacing, ref_affine), ref_shape,
                             ref_affine)


def test_downsample2_numpy_and_tensor_with_the_affine_rule():
    rng = np.random.default_rng(4)
    vol = rng.random((9, 10, 7)).astype(np.float32)
    aff = np.diag([1.0, 1.0, 3.0, 1.0])
    aff[:3, 3] = [5.0, -3.0, 2.0]
    want, want_a = jax_backend.downsample2(vol, aff)
    got, got_a = torch_backend.downsample2(vol, aff)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_a, want_a)
    ten, ten_a = torch_backend.downsample2(_t(vol), aff)
    assert ten.shape == (4, 5, 3)
    np.testing.assert_allclose(ten.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(ten_a, want_a)


def test_load_cpp_grid_rejects_zero_spacing(tmp_path):
    disp = np.zeros((6, 6, 6, 1, 3), np.float32)
    affine = np.eye(4)
    affine[:3, 1] = 0.0  # zero column => spacing_y == 0
    p = str(tmp_path / "notagrid.nii")
    save_nii(NiftiImage(disp, affine), p)
    with pytest.raises(ValueError, match="zero spacing"):
        load_cpp_grid(p, np.eye(4))
    q = _save(tmp_path, "vol.nii.gz", np.zeros((4, 4, 4)))
    with pytest.raises(ValueError, match="not a SUBCORT_CPP control grid"):
        load_cpp_grid(q, np.eye(4))


@needs_native
def test_resamplers_match_cpp_tool(tmp_path, rng):
    """The port's resamplers against tools/reg_resample, at the JAX tests'
    own tolerances (tests/test_registration.py:280,299)."""
    def run(tool, *args):
        r = subprocess.run([os.path.join(TOOLS, tool), *args],
                           capture_output=True, text=True)
        assert r.returncode == 0, f"{tool} failed: {r.stderr}"

    vol = ndimage.gaussian_filter(rng.random((18, 20, 16)), 1).astype(np.float32)
    ref = _save(tmp_path, "ref.nii.gz", np.zeros((18, 20, 16)))
    flo = _save(tmp_path, "flo.nii.gz", vol)
    A = np.eye(4)
    A[:3, 3] = [0.7, -1.2, 0.4]
    aff = str(tmp_path / "a.txt")
    np.savetxt(aff, A)
    out = str(tmp_path / "o.nii.gz")
    run("reg_resample", "-ref", ref, "-flo", flo, "-aff", aff, "-res", out)
    got = resample_through_affine(vol, np.eye(4), A, (18, 20, 16), np.eye(4),
                                  device="cpu")
    np.testing.assert_allclose(got, load_nii(out).data, atol=2e-4)

    base = ndimage.gaussian_filter(rng.random((30, 30, 26)) * 100, 2).astype(np.float32)
    shifted = ndimage.shift(base, (1.0, 0.0, -0.5), order=1)
    ref_p = _save(tmp_path, "ref2.nii.gz", base)
    flo_p = _save(tmp_path, "flo2.nii.gz", shifted)
    np.savetxt(aff, np.eye(4))
    cpp_p = str(tmp_path / "t.nii")
    run("reg_f3d", "-ref", ref_p, "-flo", flo_p, "-aff", aff, "-cpp", cpp_p,
        "-sx", "8", "-maxit", "6")
    run("reg_resample", "-ref", ref_p, "-flo", flo_p, "-trans", cpp_p,
        "-res", out)
    got = resample_through_cpp(shifted, np.eye(4),
                               load_cpp_grid(cpp_p, np.eye(4)), base.shape,
                               np.eye(4), device="cpu")
    np.testing.assert_allclose(got, load_nii(out).data, atol=5e-3, rtol=1e-3)


# ------------------------------------------------------------------- affine
def test_affine_from_params_and_moments_match():
    """_affine_from_params atol 1e-6; _moments equal (both numpy)."""
    rng = np.random.default_rng(5)
    center = np.array([31.0, -12.5, 40.25], np.float32)
    for _ in range(3):
        pn = rng.standard_normal(12).astype(np.float32)
        got = torch_affine._affine_from_params(_t(pn), _t(center)).numpy()
        want = np.asarray(jax_affine._affine_from_params(
            jnp.asarray(pn), jnp.asarray(center)))
        np.testing.assert_allclose(got, want, atol=1e-6 * 40)
        np.testing.assert_allclose(got[:3, :3], want[:3, :3], atol=1e-6)
    np.testing.assert_array_equal(torch_affine._PSCALE, jax_affine._PSCALE)
    vol = rng.random((12, 14, 10)).astype(np.float32)
    aff = np.diag([1.0, 2.0, 1.5, 1.0])
    aff[:3, 3] = [3.0, -1.0, 2.0]
    for got, want in zip(torch_affine._moments(vol, aff),
                         jax_affine._moments(vol, aff)):
        np.testing.assert_array_equal(got, want)


def _blob_volume(rng, shape=(48, 52, 44), n=10):
    vol = np.zeros(shape, np.float32)
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                             indexing="ij"), -1).astype(np.float32)
    for _ in range(n):
        c = rng.uniform(12, np.asarray(shape) - 12)
        r = rng.uniform(3.0, 7.0)
        vol += np.exp(-((g - c) ** 2).sum(-1) / (2 * r * r)).astype(np.float32)
    return (vol / vol.max() * 100).astype(np.float32)


def _make_affine_case(rng, shape, rot_deg=0.0, scale=(1, 1, 1), shear=0.0,
                      trans=(0, 0, 0), noise=0.0):
    """tests/test_registration.py's (A_true, ref, flo) with
    flo_world = A_true @ ref_world on identity voxel->world affines."""
    vol = _blob_volume(rng, shape)
    rz = np.deg2rad(rot_deg)
    c, s = np.cos(rz), np.sin(rz)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    Sh = np.eye(3)
    Sh[0, 1] = shear
    M = R @ Sh @ np.diag(scale)
    center = np.asarray(shape) / 2.0
    A = np.eye(4)
    A[:3, :3] = M
    A[:3, 3] = center - M @ center + np.asarray(trans)
    Ainv = np.linalg.inv(A)
    flo = ndimage.affine_transform(vol, Ainv[:3, :3], offset=Ainv[:3, 3],
                                   order=1).astype(np.float32)
    if noise:
        flo = flo + rng.normal(0, noise * 100, flo.shape).astype(np.float32)
    return A, vol, flo


_AFFINE_CASES = {
    "rot10": dict(rot_deg=10.0, trans=(2.0, 1.0, -1.0)),
    "scale": dict(scale=(1.10, 0.92, 1.05), trans=(1.0, 0.0, 0.0)),
    "shear": dict(shear=0.08, trans=(0.0, 1.5, 0.0)),
    "full_noisy": dict(rot_deg=8.0, scale=(1.08, 0.95, 1.0), shear=0.05,
                       trans=(2.5, -1.5, 1.0), noise=0.01),
}


def _rel_mse(res, ref):
    inner = (slice(10, -10),) * 3
    return float(((res[inner] - ref[inner]) ** 2).mean()
                 / (ref[inner] ** 2).mean())


@pytest.mark.parametrize("case", sorted(_AFFINE_CASES))
def test_affine_recovers_full_affine(rng, case):
    """The recovery battery of tests/test_registration.py:220 for the
    port: rel_mse < 0.05 and under half the unregistered one."""
    _, ref, flo = _make_affine_case(rng, (48, 52, 44), **_AFFINE_CASES[case])
    A = torch_affine.register_affine_torch(ref, flo, np.eye(4), np.eye(4),
                                           cost="ssd", device="cpu")
    assert A.dtype == np.float64 and A.shape == (4, 4)
    res = resample_through_affine(flo, np.eye(4), A, ref.shape, np.eye(4),
                                  device="cpu")
    rel, before = _rel_mse(res, ref), _rel_mse(flo, ref)
    assert rel < 0.05, f"{case}: rel_mse {rel:.4f} (unregistered {before:.4f})"
    assert rel < before * 0.5, f"{case}: no real improvement"


@pytest.fixture(scope="module")
def affine_level():
    """The middle pyramid level (24x26x22) of the full_noisy case, from
    parameters a little off the moments initialisation."""
    rng = np.random.default_rng(1234)
    _, ref, flo = _make_affine_case(rng, (48, 52, 44),
                                    **_AFFINE_CASES["full_noisy"])
    ref_c, ra = jax_backend.downsample2(ref, np.eye(4))
    flo_c, fa = jax_backend.downsample2(flo, np.eye(4))
    c_r, _ = jax_affine._moments(ref, np.eye(4))
    pn = (np.random.default_rng(6).standard_normal(12) * 0.3
          ).astype(np.float32)
    return (pn, c_r.astype(np.float32), ref_c, flo_c, ra.astype(np.float32),
            np.linalg.inv(fa).astype(np.float32))


def _jax_affine_loss(center, ref, flo, ref_affine, flo_inv, cost, nbins=32):
    """jax_affine._optimize_level's loss_fn, from the JAX package's pieces."""
    center, ref, flo, ref_affine, flo_inv = map(
        jnp.asarray, (center, ref, flo, ref_affine, flo_inv))
    ref_world = jax_backend._ref_world_coords(ref.shape, ref_affine)
    if cost == "nmi":
        rlo, rhi = ref.min(), ref.max()
        ref01 = jnp.clip((ref - rlo) / jnp.maximum(rhi - rlo, 1e-8), 0.0, 1.0)
        flo_lo = jnp.minimum(flo.min(), 0.0)
        fscale = 1.0 / jnp.maximum(jnp.maximum(flo.max(), 0.0) - flo_lo, 1e-8)
    ones = jnp.ones_like(flo)

    def loss_fn(q):
        A = jax_affine._affine_from_params(q, center)
        fw = (jnp.einsum("ij,xyzj->xyzi", A[:3, :3], ref_world,
                         precision=jax_backend._EXACT) + A[:3, 3])
        fw1 = jnp.concatenate([fw, jnp.ones(fw.shape[:-1] + (1,))], -1)
        fv = jnp.einsum("ij,xyzj->xyzi", flo_inv[:3, :], fw1,
                        precision=jax_backend._EXACT)
        warped = jax_backend._trilinear(flo, fv)
        inb = jax.lax.stop_gradient(jax_backend._trilinear(ones, fv))
        if cost == "nmi":
            w01 = jnp.clip((warped - flo_lo) * fscale, 0.0, 1.0)
            return 2.0 - jax_ffd._nmi(ref01, w01, nbins)
        num = jnp.sum(inb * (warped - ref) ** 2)
        return num / jnp.maximum(jnp.sum(inb), 1.0)

    return loss_fn


@pytest.mark.parametrize("iters", LEVEL_ITERS)
@pytest.mark.parametrize("cost,dof", [("ssd", 6), ("ssd", 12), ("nmi", 6),
                                      ("nmi", 12)])
def test_affine_level_loss_gradient_and_five_adam_steps_match(affine_level,
                                                              cost, dof,
                                                              iters):
    """One loss and gradient of an affine level (loss rtol 1e-5; gradient
    rtol 1e-3, atol scaled by the largest |gradient|), then a level of
    ``iters`` Adam steps (1, the card's warm-up count, one more, and 5):
    parameters within 1e-4 of the JAX ones and every loss within rtol
    1e-4, the rigid phase's six masked parameters unmoved."""
    pn, center, ref, flo, ra, finv = affine_level
    want, wgrad = jax.value_and_grad(
        _jax_affine_loss(center, ref, flo, ra, finv, cost))(jnp.asarray(pn))
    args = [jnp.asarray(a) for a in (pn, center, ref, flo, ra, finv)]
    _, first = jax_affine._optimize_level(*args, 1, 0.05, cost=cost, dof=dof)
    np.testing.assert_allclose(float(want), float(first[0]), rtol=1e-5)

    tensors = [_t(a) for a in (center, ref, flo, ra, finv)]
    q = _t(pn).requires_grad_(True)
    got = torch_affine._level_loss(*tensors, cost)(q)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close_grad(q.grad.numpy(), wgrad, 1e-3)

    want_p, want_l = jax_affine._optimize_level(*args, iters, 0.05,
                                                cost=cost, dof=dof)
    got_p, got_l = torch_affine._optimize_level(_t(pn), *tensors, iters,
                                                0.05, cost=cost, dof=dof)
    assert got_l.shape == (iters,)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-4)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-4)
    if dof == 6:
        np.testing.assert_array_equal(got_p.numpy()[6:], pn[6:])
        assert (got_p.numpy()[:6] != pn[:6]).all()


@pytest.mark.parametrize("cost,dof", [("ssd", 12), ("nmi", 6)])
def test_affine_level_iteration_reads_nothing_back(affine_level, monkeypatch,
                                                   cost, dof):
    """An affine level's iteration runs with every Tensor method that reads
    a value back to the host raising (tests/test_torch_ffd.py's guard): the
    iteration that the card captures and replays takes no host input.
    Parameters and losses equal the unguarded level's."""
    from test_torch_ffd import guard_host_reads

    args = [_t(a) for a in affine_level]
    want = torch_affine._optimize_level(*args, 3, 0.05, cost=cost, dof=dof)
    calls = guard_host_reads(monkeypatch, torch_affine)
    got = torch_affine._optimize_level(*args, 3, 0.05, cost=cost, dof=dof)
    assert len(calls) == 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cost", ["ssd", "nmi"])
def test_affine_whole_run_matches_jax(cost):
    """register_affine on the synthetic template under a known 12-dof
    misalignment: matrix entries and translations (mm) within 1e-2 of the
    JAX package's, the warped images' mean squared difference under 1% of
    the image's variance, and the final SSD within 2%."""
    rng = np.random.default_rng(8)
    vol = _blob_volume(rng, (36, 40, 34), n=8)
    kw = dict(rot_deg=6.0, scale=(1.05, 0.96, 1.02), trans=(1.5, -1.0, 0.5))
    _, ref, flo = _make_affine_case(np.random.default_rng(8), (36, 40, 34),
                                    **kw)
    del vol
    if cost == "nmi":
        flo = (flo ** 2 / float(flo.max())).astype(np.float32)
    run = dict(cost=cost, iters=(60, 30, 10))
    got = torch_affine.register_affine_torch(ref, flo, device="cpu", **run)
    want = jax_affine.register_affine_jax(ref, flo, **run)
    np.testing.assert_allclose(got, want, atol=1e-2)
    eye = np.eye(4)
    a = resample_through_affine(flo, eye, got, ref.shape, eye, device="cpu")
    b = resample_through_affine(flo, eye, want, ref.shape, eye, device="cpu")
    assert float(((a - b) ** 2).mean()) < 0.01 * float(flo.var())
    if cost == "ssd":
        np.testing.assert_allclose(((a - ref) ** 2).mean(),
                                   ((b - ref) ** 2).mean(), rtol=0.02)
    with pytest.raises(ValueError, match="cost"):
        torch_affine.register_affine_torch(ref, flo, cost="ncc", device="cpu")


# ----------------------------------------------------------- register_masks
FILES = ("transf.txt", "transform.nii", "rT1_template.nii.gz",
         "rT1d_template.nii.gz", "MNI_sub_probabilities.nii.gz",
         "MNI_subcortical_mask.nii.gz")


def _overlap(probs, want):
    inter = ((probs[..., :14] > 0.2) & (want > 0.2)).sum()
    union = ((probs[..., :14] > 0.2) | (want > 0.2)).sum()
    return inter / max(union, 1)


def _structure_dice(a, b):
    dices = []
    for s in range(14):
        p, g = a[..., s] > 0.5, b[..., s] > 0.5
        denom = int(p.sum()) + int(g.sum())
        dices.append(2.0 * int((p & g).sum()) / denom if denom else 0.0)
    return float(np.mean(dices))


def test_register_masks_torch_backend(tmp_path):
    """backend='torch' on the CPU with no native tools (tools_dir points at
    an empty directory): the whole file set, majority prior overlap
    (tests/test_registration.py:436), the stage cache, and priors that
    agree with the JAX backend's on the same scan (structure Dice >= 0.95
    between the two). While spans record, the call is a
    ``register.masks`` span over its stages, whose spans (with their IO,
    mask and ``register.level`` children) sum to the call; a cached call
    opens no stage."""
    atlas_dir = str(tmp_path / "atlases")
    template, at = atlas.make_synthetic_atlas(atlas_dir, shape=(36, 40, 34))
    shift = (1.5, -1.0, 0.5)
    subject = ndimage.shift(template, shift, order=1).astype(np.float32)
    (tmp_path / "subj").mkdir()
    scan = _save(tmp_path / "subj", "T1.nii.gz", subject)
    (tmp_path / "jax").mkdir()
    jscan = _save(tmp_path / "jax", "T1.nii.gz", subject)

    runtime.clear_records()
    with runtime.recording():
        seconds = register_masks(scan, atlas_dir=atlas_dir, backend="torch",
                                 device="cpu",
                                 tools_dir=str(tmp_path / "no_tools_here"))
    recs = runtime.records()
    report = runtime.self_seconds(recs)
    stages = ["register.affine", "register.ffd", "register.io",
              "register.mask", "register.prior_warp"]
    assert sorted(report) == sorted(stages + ["register.level",
                                              "register.masks"])
    assert all(report[k] > 0 for k in stages)
    inside = sum(v for k, v in report.items() if k != "register.masks")
    assert 0.95 * seconds <= inside <= seconds
    assert {r.request for r in recs} == {recs[-1].request}
    # on the CPU no stage reads the device's peak memory
    assert not any("peak_bytes" in r.attrs for r in recs)
    tmp = tmp_path / "subj" / "tmp"
    for f in FILES:
        assert (tmp / f).exists(), f
    probs = load_nii(str(tmp / "MNI_sub_probabilities.nii.gz")).data
    assert probs.shape == subject.shape + (15,)
    want = np.stack([ndimage.shift(at[..., c], shift, order=1)
                     for c in range(14)], -1)
    assert _overlap(probs, want) > 0.5
    assert load_nii(str(tmp / "MNI_subcortical_mask.nii.gz")).data.sum() > 0
    assert np.loadtxt(str(tmp / "transf.txt")).shape == (4, 4)
    grid = load_cpp_grid(str(tmp / "transform.nii"), np.eye(4))
    np.testing.assert_allclose(torch_backend.spacing3(grid.spacing), 10.0,
                               rtol=1e-5)

    # stage cache: a second call is a no-op
    runtime.clear_records()
    with runtime.recording():
        assert register_masks(scan, atlas_dir=atlas_dir, backend="torch",
                              device="cpu") < 1.0
    assert [r.name for r in runtime.records()] == ["register.masks"]
    runtime.clear_records()

    jax_register_masks(jscan, atlas_dir=atlas_dir, backend="jax",
                       tools_dir=str(tmp_path / "no_tools_here"))
    jprobs = jax_load_nii(str(
        tmp_path / "jax" / "tmp" / "MNI_sub_probabilities.nii.gz")).data
    assert _structure_dice(probs, jprobs) >= 0.95


@needs_native
@pytest.mark.parametrize("per_channel", [False, True])
def test_register_masks_native_backend(tmp_path, per_channel):
    """backend='native' (the opt-in) drives the C++ tools unchanged,
    tests/test_registration.py:375 for the port's ``register_masks``; the
    ``per_channel`` loop of the reference gives the same priors."""
    atlas_dir = str(tmp_path / "atlases")
    template, at = atlas.make_synthetic_atlas(atlas_dir, shape=(40, 44, 38))
    shift = (2.0, -1.0, 1.0)
    subject = ndimage.shift(template, shift, order=1).astype(np.float32)
    (tmp_path / "subj").mkdir()
    scan = _save(tmp_path / "subj", "T1.nii.gz", subject)
    register_masks(scan, atlas_dir=atlas_dir, per_channel=per_channel,
                   backend="native")
    tmp = tmp_path / "subj" / "tmp"
    for f in FILES:
        assert (tmp / f).exists(), f
    probs = load_nii(str(tmp / "MNI_sub_probabilities.nii.gz")).data
    want = np.stack([ndimage.shift(at[..., c], shift, order=1)
                     for c in range(14)], -1)
    assert _overlap(probs, want) > 0.5
    assert register_masks(scan, atlas_dir=atlas_dir, backend="native") < 1.0
    # the on-device resampler reads the native tool's transform.nii
    grid = load_cpp_grid(str(tmp / "transform.nii"), np.eye(4))
    mine = resample_through_cpp(at, np.eye(4), grid, subject.shape,
                                np.eye(4), device="cpu")
    np.testing.assert_allclose(mine, probs, atol=5e-3, rtol=1e-3)


def test_register_masks_anisotropic_and_remapped(tmp_path):
    """tests/test_registration.py:344 and :441 for the port's backend: a
    clinical-style 1x1x3 mm subject, and the default NMI cost on an
    intensity-remapped subject, each with majority prior overlap."""
    atlas_dir = str(tmp_path / "atlases")
    template, at = atlas.make_synthetic_atlas(atlas_dir, shape=(40, 44, 36))
    shift = (2.0, -1.0, 0.0)
    shifted = ndimage.shift(template, shift, order=1)
    (tmp_path / "aniso").mkdir()
    scan = _save(tmp_path / "aniso", "T1.nii.gz",
                 shifted[:, :, ::3].astype(np.float32),
                 affine=np.diag([1.0, 1.0, 3.0, 1.0]))
    register_masks(scan, atlas_dir=atlas_dir, backend="torch", device="cpu")
    probs = load_nii(str(
        tmp_path / "aniso" / "tmp" / "MNI_sub_probabilities.nii.gz")).data
    assert probs.shape == (40, 44, 12, 15)
    want = np.stack([ndimage.shift(at[..., c], shift, order=1)[:, :, ::3]
                     for c in range(14)], -1)
    assert _overlap(probs, want) > 0.5, "anisotropic: overlap too low"
    grid = load_cpp_grid(str(tmp_path / "aniso" / "tmp" / "transform.nii"),
                         np.diag([1.0, 1.0, 3.0, 1.0]))
    np.testing.assert_allclose(torch_backend.spacing3(grid.spacing),
                               (10.0, 10.0, 10.0 / 3.0), rtol=1e-5)

    subject = (shifted ** 2 / float(shifted.max())).astype(np.float32)
    (tmp_path / "remap").mkdir()
    scan = _save(tmp_path / "remap", "T1.nii.gz", subject)
    register_masks(scan, atlas_dir=atlas_dir, backend="torch", device="cpu")
    probs = load_nii(str(
        tmp_path / "remap" / "tmp" / "MNI_sub_probabilities.nii.gz")).data
    want = np.stack([ndimage.shift(at[..., c], shift, order=1)
                     for c in range(14)], -1)
    assert _overlap(probs, want) > 0.5, "the default cost lost the remap"


def test_register_masks_refusals(tmp_path, monkeypatch):
    """A missing atlas raises RegistrationError; backend='jax' raises a
    ValueError that names 'torch'; an unknown backend or similarity
    raises ValueError before any work; the default backend is 'torch', and
    without a device it asks for the card."""
    scan_dir = tmp_path / "s"
    scan_dir.mkdir()
    scan = _save(scan_dir, "T1.nii.gz", np.ones((8, 8, 8)))
    monkeypatch.delenv("SUBCORT_ATLAS_DIR", raising=False)
    assert not os.path.exists(DEFAULT_ATLAS_DIR)
    with pytest.raises(RegistrationError, match="atlas assets not found"):
        register_masks(scan, atlas_dir=str(tmp_path / "nope"),
                       backend="torch", device="cpu")
    shutil.rmtree(str(scan_dir / "tmp"), ignore_errors=True)
    with pytest.raises(ValueError, match="'torch'"):
        register_masks(scan, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="reg_backend"):
        register_masks(scan, backend="ants", device="cpu")
    with pytest.raises(ValueError, match="reg_similarity"):
        register_masks(scan, backend="torch", similarity="ncc", device="cpu")
    assert not (scan_dir / "tmp").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            register_masks(scan)
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_backend.bspline_axis_matrices((8, 8, 8), 4.0, (5, 5, 5))
        assert not (scan_dir / "tmp").exists()

    # the environment variable is the second stop of the resolution order
    atlas_dir = str(tmp_path / "atlases")
    atlas.make_synthetic_atlas(atlas_dir, shape=(8, 8, 8))
    monkeypatch.setenv("SUBCORT_ATLAS_DIR", atlas_dir)
    assert _resolve_atlas_dir(None) == atlas_dir
    assert _resolve_atlas_dir(str(tmp_path / "nope")) == atlas_dir


def test_configured_register_binds_cfg_knobs():
    """[tpu] reg_backend/reg_similarity must reach register_masks when the
    engine registers on demand, with the device ``options.mode`` names
    (tests/test_registration.py:557)."""
    seen = {}

    def fake_register(path, backend=None, similarity=None, device=None):
        seen.update(path=path, backend=backend, similarity=similarity,
                    device=device)
        return 0.0

    opts = Options(mode="cpu")
    opts["reg_backend"] = "torch"
    opts["reg_similarity"] = "ssd"
    _configured_register(fake_register, opts)("/some/T1.nii.gz")
    assert seen == {"path": "/some/T1.nii.gz", "backend": "torch",
                    "similarity": "ssd", "device": torch.device("cpu")}
    _configured_register(fake_register, opts, "meta")("/other.nii.gz")
    assert seen["device"] == "meta"
    # the native backend needs no device, and asks for none
    _configured_register(fake_register, Options(
        reg_backend="native"))("/some/T1.nii.gz")
    assert seen["backend"] == "native" and seen["device"] is None
    # the default is the on-device backend on the card ``mode`` names
    assert Options().reg_backend == "torch"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _configured_register(fake_register, Options())("/some/T1.nii.gz")


# -------------------------------------------------------------------- atlas
def test_atlas_validation_and_install_match(tmp_path):
    src = tmp_path / "src"
    tmpl, at = atlas.make_synthetic_atlas(str(src), shape=(24, 26, 22))
    tp = str(src / "T1_template.nii.gz")
    ap = str(src / "atlas_subcortical_MNI.nii.gz")
    got_t, got_a = atlas.validate_atlas_assets(tp, ap)
    want_t, want_a = jax_atlas.validate_atlas_assets(tp, ap)
    np.testing.assert_array_equal(got_t.data, want_t.data)
    np.testing.assert_array_equal(got_a.data, want_a.data)

    cases = {
        r"\(X, Y, Z, 15\)": _save(tmp_path, "bad14.nii.gz", at[..., :14]),
        "grid": _save(tmp_path, "off.nii.gz", at[:-2]),
        r"\[0, 1\]": _save(tmp_path, "scaled.nii.gz", at * 255.0),
        "channel 14": _save(tmp_path, "rolled.nii.gz", np.roll(at, 1, axis=3)),
        "not found": str(tmp_path / "absent.nii.gz"),
    }
    for match, bad in cases.items():
        with pytest.raises(atlas.AtlasValidationError, match=match):
            atlas.validate_atlas_assets(tp, bad)
        with pytest.raises(jax_atlas.AtlasValidationError, match=match):
            jax_atlas.validate_atlas_assets(tp, bad)

    # a trailing singleton template is squeezed and installed as 3-D
    t4 = _save(tmp_path, "t4.nii.gz", tmpl[..., None])
    dest = atlas.install_atlas(t4, ap, dest_dir=str(tmp_path / "port"))
    jdest = jax_atlas.install_atlas(t4, ap, dest_dir=str(tmp_path / "jax"))
    for name in ("T1_template.nii.gz", "atlas_subcortical_MNI.nii.gz"):
        got = load_nii(os.path.join(dest, name))
        want = jax_load_nii(os.path.join(jdest, name))
        assert got.data.dtype == want.data.dtype == np.float32
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.affine, want.affine)
    assert load_nii(os.path.join(dest, "T1_template.nii.gz")).data.ndim == 3
    assert _resolve_atlas_dir(dest) == dest


@pytest.mark.parametrize("kind", ("clean",) + atlas.DEGRADATIONS)
def test_apply_degradation_matches(kind):
    """Every degradation, array-equal to the JAX package's from one seed."""
    assert atlas.DEGRADATIONS == jax_atlas.DEGRADATIONS
    base = np.zeros((20, 22, 18), np.float32)
    base[4:16, 5:17, 4:14] = 600.0
    base[8:12, 9:13, 7:11] = 900.0
    got = atlas.apply_degradation(base, np.eye(4), kind,
                                  np.random.default_rng(9), strength=0.8)
    want = jax_atlas.apply_degradation(base, np.eye(4), kind,
                                       np.random.default_rng(9), strength=0.8)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    with pytest.raises(ValueError, match="unknown degradation"):
        atlas.apply_degradation(base, np.eye(4), "solarize",
                                np.random.default_rng(9))


@pytest.mark.parametrize("kind", ["oblique", "combined"])
def test_make_degraded_subject_matches(tmp_path, kind):
    kw = dict(shape=(24, 26, 22), seed=1)
    sub = atlas.make_degraded_subject(str(tmp_path / "port"),
                                      str(tmp_path / "port_atlases"), kind,
                                      **kw)
    jsub = jax_atlas.make_degraded_subject(str(tmp_path / "jax"),
                                           str(tmp_path / "jax_atlases"),
                                           kind, **kw)
    for name in ("T1.nii.gz", "gt_15_classes.nii.gz"):
        got = load_nii(os.path.join(sub, name))
        want = jax_load_nii(os.path.join(jsub, name))
        assert got.data.dtype == want.data.dtype, name
        np.testing.assert_array_equal(got.data, want.data, err_msg=name)
        np.testing.assert_array_equal(got.affine, want.affine)
    assert not os.path.exists(os.path.join(sub, "tmp"))
