"""PyTorch port: the FFD registration (``registration/torch_ffd.py``) and
its cost pieces against the JAX package's ``registration/jax_ffd.py``.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port, the port on ``"cpu"``; each tolerance is
stated where it is used. Sizes are those of tests/test_jax_ffd.py
(36x36x32). The loss of one optimiser level is rebuilt here from the JAX
package's own pieces as ``jax_ffd._optimize_level`` composes them, and is
first held to that function's own first loss.
"""

import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import ndimage

from subcort_tpu.io import load_nii as jax_load_nii
from subcort_tpu.registration import jax_backend, jax_ffd
from subcort_tpu_torch.io import NiftiImage, save_nii
from subcort_tpu_torch.config import exact_float32
from subcort_tpu_torch.registration import (load_cpp_grid,
                                            resample_through_affine,
                                            resample_through_cpp, torch_ffd)
from subcort_tpu_torch.registration.torch_backend import (WARMUP_ITERS,
                                                          CppGrid,
                                                          _resample_affine,
                                                          _resample_cpp,
                                                          downsample2,
                                                          linear_schedule,
                                                          spacing3)

torch.set_num_threads(1)

SHAPE = (36, 36, 32)
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close_grad(got, want, rtol):
    """Gradients agree within ``rtol``, the absolute slack scaled by the
    largest |gradient|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def warped_pair():
    """tests/test_jax_ffd.py's pair: smoothed noise and the same under a
    1.2-voxel sinusoidal warp along x."""
    rng = np.random.default_rng(7)
    base = ndimage.gaussian_filter(rng.random(SHAPE) * 100, 2).astype(np.float32)
    base[:4] = 0
    base[-4:] = 0
    gx = 1.2 * np.sin(np.linspace(0, np.pi, 36))[:, None, None]
    coords = np.stack(np.meshgrid(*[np.arange(s) for s in base.shape],
                                  indexing="ij"), 0).astype(np.float64)
    coords[0] += gx
    flo = ndimage.map_coordinates(base, coords, order=1).astype(np.float32)
    return base, flo


@pytest.fixture(scope="module")
def remapped_pair(warped_pair):
    ref, flo = warped_pair
    fmax = flo.max()
    flo_remap = ((fmax - flo) ** 2 / fmax).astype(np.float32)
    ref_remap = ((fmax - ref) ** 2 / fmax).astype(np.float32)
    return ref, flo_remap, ref_remap


def _mse(a, b):
    return float(((a - b) ** 2)[4:-4].mean())


# ------------------------------------------------------------ cost pieces
@pytest.mark.parametrize("shape,spacing", [
    ((36, 36, 32), 6.0), ((36, 36, 12), (9.0, 9.0, 3.0)),
    ((181, 217, 181), 10.0), ((20, 18, 16), (4.0, 2.5, 2.0))])
def test_grid_counts_and_spacing3(shape, spacing):
    assert torch_ffd._grid_counts(shape, spacing) == \
        jax_ffd._grid_counts(shape, spacing)
    assert spacing3(spacing) == jax_backend.spacing3(spacing)
    with pytest.raises(ValueError, match="spacing"):
        spacing3((1.0, 2.0))


def test_soft_hist_weights_match_and_rows_sum_to_one():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(500), [0.0, 1.0, 0.5]]).astype(np.float32)
    got = torch_ffd._soft_hist_weights(_t(x), 32).numpy()
    want = np.asarray(jax_ffd._soft_hist_weights(jnp.asarray(x), 32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("chunk", [1 << 12, 1 << 17])
def test_nmi_value_and_gradient_match(warped_pair, chunk):
    """Value rtol 1e-5; gradient with respect to the warped image rtol
    1e-4, atol scaled by the largest |gradient|. 41,472 voxels: 11 chunks
    of 4,096 (the last padded), or one padded chunk."""
    ref, flo = warped_pair
    r01 = (ref - ref.min()) / (ref.max() - ref.min())
    w01 = np.clip(flo / flo.max(), 0.0, 1.0)
    want, wgrad = jax.value_and_grad(
        lambda w: jax_ffd._nmi(jnp.asarray(r01), w, 32, chunk))(
            jnp.asarray(w01))
    w = _t(w01).requires_grad_(True)
    got = torch_ffd._nmi(_t(r01), w, 32, chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close_grad(w.grad.numpy(), wgrad, 1e-4)
    # the hoisted reference weights give the same histogram
    hoisted = torch_ffd._nmi(_t(r01), _t(w01), 32, chunk,
                             ref_weights=torch_ffd._ref_hist_weights(
                                 _t(r01), 32, chunk))
    assert hoisted.item() == got.item()


def test_bending_and_jacobian_match():
    rng = np.random.default_rng(1)
    d = rng.standard_normal((9, 8, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(float(torch_ffd._bending(_t(d))),
                               float(jax_ffd._bending(jnp.asarray(d))),
                               rtol=1e-5)
    dd = (rng.standard_normal((12, 11, 10, 3)) * 0.3).astype(np.float32)
    A = (np.diag([1.0, 1.0, 3.0]) + rng.standard_normal((3, 3)) * 0.05
         ).astype(np.float32)
    got = torch_ffd._jac_det_rel(_t(dd), _t(A)).numpy()
    want = np.asarray(jax_ffd._jac_det_rel(jnp.asarray(dd), jnp.asarray(A)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_jacobian_stats_detects_folds():
    """tests/test_jax_ffd.py's folded grid: an identity grid has
    det(J)/det(A) == 1; d_x = -2x reverses space."""
    shape, spacing = (20, 18, 16), 4.0
    nc = tuple(int(np.ceil((s - 1) / spacing)) + 4 for s in shape)
    disp = np.zeros(nc + (3,), np.float32)
    stats = torch_ffd.jacobian_stats(CppGrid(disp, spacing, np.eye(4)),
                                     shape, device="cpu")
    assert abs(stats["min_jac"] - 1.0) < 1e-4
    assert stats["neg_fraction"] == 0.0
    fold = disp.copy()
    fold[..., 0] = -2.0 * ((np.arange(nc[0]) - 1) * spacing)[:, None, None]
    stats = torch_ffd.jacobian_stats(CppGrid(fold, spacing, np.eye(4)),
                                     shape, device="cpu")
    want = jax_ffd.jacobian_stats(
        jax_backend.CppGrid(fold, spacing, np.eye(4)), shape)
    assert stats["min_jac"] < 0.0 and stats["neg_fraction"] > 0.9
    np.testing.assert_allclose(stats["min_jac"], want["min_jac"], rtol=1e-5)
    np.testing.assert_allclose(stats["neg_fraction"], want["neg_fraction"],
                               rtol=1e-6)


# ------------------------------------------------------ one optimiser level
def _level_inputs(ref, flo, seed=3):
    """The coarse level of register_ffd on the pair (half resolution,
    vox_offset 0.25), from control values a little off the identity so
    that bending, data term and hinge all pull."""
    spacing = (3.0, 3.0, 3.0)  # 6 mm on the half-resolution level
    nc = jax_ffd._grid_counts(ref.shape, (6.0, 6.0, 6.0))
    rng = np.random.default_rng(seed)
    d_aff = np.zeros(nc + (3,), np.float32)
    disp = (rng.standard_normal(nc + (3,)) * 3.0).astype(np.float32)
    ref_c, ra = downsample2(ref, np.eye(4))
    flo_c, fa = downsample2(flo, np.eye(4))
    return (disp, d_aff, ref_c, flo_c, ra.astype(np.float32),
            np.linalg.inv(fa).astype(np.float32), spacing)


def _jax_level_loss(d_aff, ref, flo, ref_affine, flo_inv, spacing, be, cost,
                    nbins, jw, vox_offset):
    """jax_ffd._optimize_level's loss_fn, from the JAX package's pieces."""
    d_aff, ref, flo, ref_affine, flo_inv = map(
        jnp.asarray, (d_aff, ref, flo, ref_affine, flo_inv))
    shape = ref.shape
    ref_world = jax_backend._ref_world_coords(shape, ref_affine)
    if cost == "nmi":
        rlo, rhi = ref.min(), ref.max()
        ref01 = jnp.clip((ref - rlo) / jnp.maximum(rhi - rlo, 1e-8), 0.0, 1.0)
        flo_lo = jnp.minimum(flo.min(), 0.0)
        fscale = 1.0 / jnp.maximum(jnp.maximum(flo.max(), 0.0) - flo_lo, 1e-8)
    jw_eff = jw * (jnp.mean(ref * ref) if cost == "ssd" else 1.0)

    def loss_fn(d):
        dd = jax_ffd._dense_disp(d, spacing, shape, vox_offset)
        fw = ref_world + dd
        fw1 = jnp.concatenate([fw, jnp.ones(fw.shape[:-1] + (1,))], -1)
        fv = jnp.einsum("ij,xyzj->xyzi", flo_inv[:3, :], fw1,
                        precision=jax_backend._EXACT)
        warped = jax_backend._trilinear(flo, fv)
        if cost == "nmi":
            w01 = jnp.clip((warped - flo_lo) * fscale, 0.0, 1.0)
            data = 2.0 - jax_ffd._nmi(ref01, w01, nbins)
        else:
            data = jnp.mean((warped - ref) ** 2)
        loss = data + be * jax_ffd._bending(d - d_aff) / d.size
        detrel = jax_ffd._jac_det_rel(dd, ref_affine[:3, :3])
        return loss + jw_eff * jnp.mean(jax.nn.relu(0.5 - detrel) ** 2)

    return loss_fn


@pytest.mark.parametrize("iters", [1, WARMUP_ITERS, WARMUP_ITERS + 1, 5])
@pytest.mark.parametrize("cost,be", [("ssd", 0.05), ("nmi", 5e-4)])
def test_level_loss_gradient_and_five_adam_steps_match(warped_pair, cost, be,
                                                       iters):
    """One loss and gradient of an FFD level with the hinge on (loss rtol
    1e-5; gradient rtol 1e-3, atol scaled by the largest |gradient|), then
    a level of ``iters`` Adam steps (1, the card's warm-up count, the
    first count that replays a captured iteration there, and 5): control
    values within 1e-4 of the JAX ones (SSD; NMI as stated below), every
    loss within rtol 1e-4."""
    ref, flo = warped_pair
    disp, d_aff, ref_c, flo_c, ra, finv, spacing = _level_inputs(ref, flo)
    kw = dict(cost=cost, nbins=32, jw=1.0, vox_offset=0.25)
    jloss = _jax_level_loss(d_aff, ref_c, flo_c, ra, finv, spacing, be, **kw)
    want, wgrad = jax.value_and_grad(jloss)(jnp.asarray(disp))
    # the rebuilt loss is the one jax_ffd._optimize_level descends
    _, first = jax_ffd._optimize_level(
        *map(jnp.asarray, (disp, d_aff, ref_c, flo_c, ra, finv)),
        spacing, 1, be, 0.4, **kw)
    np.testing.assert_allclose(float(want), float(first[0]), rtol=1e-5)

    tensors = [_t(a) for a in (d_aff, ref_c, flo_c, ra, finv)]
    loss_fn = torch_ffd._level_loss(*tensors, spacing, be, **kw)
    d = _t(disp).requires_grad_(True)
    got = loss_fn(d)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close_grad(d.grad.numpy(), wgrad, 1e-3)
    # the hinge is live on this input, so the comparison covers it
    dd = jax_ffd._dense_disp(jnp.asarray(disp), spacing, ref_c.shape, 0.25)
    assert float(jax_ffd._jac_det_rel(dd, jnp.asarray(ra)[:3, :3]).min()) < 0.5

    want_d, want_l = jax_ffd._optimize_level(
        *map(jnp.asarray, (disp, d_aff, ref_c, flo_c, ra, finv)),
        spacing, iters, be, 0.4, **kw)
    got_d, got_l = torch_ffd._optimize_level(_t(disp), *tensors, spacing,
                                             iters, be, 0.4, **kw)
    assert got_l.shape == (iters,)
    # Adam divides each control's step by its own gradient scale, so a
    # control whose NMI gradient is near zero (~1e-9, float32 rounding of
    # the histogram) moves by that rounding: under NMI 99% of the controls
    # hold 1e-4 and all hold 5e-3, 1.25% of one 0.4 mm step
    diff = np.abs(got_d.numpy() - np.asarray(want_d))
    assert float(np.quantile(diff, 0.99)) <= 1e-4
    assert float(diff.max()) <= (1e-4 if cost == "ssd" else 5e-3)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-4)


@pytest.mark.parametrize("iters", [1, 15, 60])
def test_learning_rate_of_first_and_last_step(iters):
    """Step i (from 0) of a level uses lr * (1 - 0.9 i / iters), optax's
    linear_schedule(lr, 0.1 lr, iters), from an int step and from the
    level's float32 step count on its device."""
    sched = optax.linear_schedule(0.4, 0.04, max(iters, 1))
    for i in (0, iters - 1, iters):
        np.testing.assert_allclose(linear_schedule(0.4, i, iters),
                                   float(sched(i)), rtol=1e-6)
        on_device = linear_schedule(0.4, torch.tensor(float(i)), iters)
        assert on_device.dtype == torch.float32
        np.testing.assert_allclose(float(on_device), float(sched(i)),
                                   rtol=1e-6)
    assert linear_schedule(0.4, 0, iters) == 0.4


# what reads a tensor's value back to the host
HOST_READS = ("item", "__float__", "__int__", "__bool__", "tolist", "cpu",
              "numpy")


def guard_host_reads(monkeypatch, module):
    """Wrap ``module.run_level`` so that each call of a level's iteration
    runs with the Tensor methods of :data:`HOST_READS` raising. Returns the
    list that counts those calls."""
    real, calls = module.run_level, []

    def raiser(name):
        def read(*args, **kwargs):
            raise AssertionError(f"the iteration read a tensor back: {name}")
        return read

    def run_level(step, iters, device, **kw):
        def guarded():
            with pytest.MonkeyPatch.context() as m:
                for name in HOST_READS:
                    m.setattr(torch.Tensor, name, raiser(name))
                with pytest.raises(AssertionError, match="read a tensor"):
                    torch.zeros(()).item()  # the guard is live
                step()
            calls.append(1)
        real(guarded, iters, device, **kw)

    monkeypatch.setattr(module, "run_level", run_level)
    return calls


@pytest.mark.parametrize("cost,be", [("ssd", 0.05), ("nmi", 5e-4)])
def test_level_iteration_reads_nothing_back(warped_pair, monkeypatch, cost,
                                            be):
    """An FFD level's iteration (the hinge on) runs with every Tensor
    method that reads a value back to the host raising: the iteration that
    the card captures and replays takes no host input. Controls and losses
    equal the unguarded level's."""
    ref, flo = warped_pair
    disp, d_aff, ref_c, flo_c, ra, finv, spacing = _level_inputs(ref, flo)
    args = [_t(a) for a in (disp, d_aff, ref_c, flo_c, ra, finv)]
    kw = dict(cost=cost, nbins=32, jw=1.0, vox_offset=0.25)
    want = torch_ffd._optimize_level(*args, spacing, 3, be, 0.4, **kw)
    calls = guard_host_reads(monkeypatch, torch_ffd)
    got = torch_ffd._optimize_level(*args, spacing, 3, be, 0.4, **kw)
    assert len(calls) == 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ----------------------------------------------------------- whole runs
@pytest.fixture(scope="module")
def ssd_runs(warped_pair):
    ref, flo = warped_pair
    kw = dict(spacing_mm=6.0, iters=(40, 8), be=0.02)
    return (torch_ffd.register_ffd_torch(ref, flo, device="cpu", **kw),
            jax_ffd.register_ffd_jax(ref, flo, **kw))


def _port_warp(flo, grid, shape):
    return resample_through_cpp(flo, np.eye(4), grid, shape, np.eye(4),
                                device="cpu")


def test_ffd_ssd_run_matches_jax_and_reduces_mismatch(warped_pair, ssd_runs):
    """Final loss within 2% of the JAX package's at both levels; the two
    warped images' mean squared difference under 1% of the image's
    variance; and tests/test_jax_ffd.py's own assertions for the port."""
    ref, flo = warped_pair
    (grid, losses), (jgrid, jlosses) = ssd_runs
    for got, want in zip(losses, jlosses):
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got[-1], np.asarray(want)[-1], rtol=0.02)
    warped = _port_warp(flo, grid, ref.shape)
    jwarped = _port_warp(flo, CppGrid(np.array(jgrid.disp), jgrid.spacing,
                                      jgrid.ref_affine), ref.shape)
    assert float(((warped - jwarped) ** 2).mean()) < 0.01 * float(ref.var())
    assert losses[0][-1] < losses[0][0] * 0.7
    before = float(((flo - ref) ** 2)[4:-4].mean())
    after = float(((warped - ref) ** 2)[4:-4].mean())
    assert after < before * 0.6


def test_ffd_recovered_warp_is_diffeomorphic(warped_pair, ssd_runs):
    ref, _ = warped_pair
    stats = torch_ffd.jacobian_stats(ssd_runs[0][0], ref.shape, device="cpu")
    assert stats["min_jac"] > 0.0, stats
    assert stats["neg_fraction"] == 0.0, stats


def test_ffd_nmi_recovers_under_intensity_remap(remapped_pair):
    """NMI recovers the alignment of a remapped pair to under 0.05x the
    mismatch before, within 2% of the JAX package's final loss; SSD chases
    the intensity mismatch, folds, and the fold guard warns."""
    ref, flo_remap, ref_remap = remapped_pair
    before = _mse(flo_remap, ref_remap)
    kw = dict(spacing_mm=6.0, iters=(60, 10), cost="nmi")
    grid, losses = torch_ffd.register_ffd_torch(ref, flo_remap, device="cpu",
                                                **kw)
    _, jlosses = jax_ffd.register_ffd_jax(ref, flo_remap, **kw)
    np.testing.assert_allclose(losses[1][-1], np.asarray(jlosses[1])[-1],
                               rtol=0.02)
    assert _mse(_port_warp(flo_remap, grid, ref.shape), ref_remap) \
        < before * 0.05

    with pytest.warns(RuntimeWarning, match="transform folds"):
        grid_ssd, _ = torch_ffd.register_ffd_torch(
            ref, flo_remap, spacing_mm=6.0, iters=(60, 10), cost="ssd",
            device="cpu")
    assert _mse(_port_warp(flo_remap, grid_ssd, ref.shape), ref_remap) > before


def test_ffd_rejects_unknown_cost(warped_pair):
    ref, flo = warped_pair
    with pytest.raises(ValueError, match="cost"):
        torch_ffd.register_ffd_torch(ref, flo, cost="ncc", device="cpu")


def test_ffd_without_a_device_asks_for_the_card(warped_pair):
    """``device=None`` is the default card: without one it raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ref, flo = warped_pair
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_ffd.register_ffd_torch(ref, flo, iters=(1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_ffd.jacobian_stats(CppGrid(np.zeros((5, 5, 5, 3), np.float32),
                                         4.0, np.eye(4)), (8, 8, 8))


# ------------------------------------------------------ the resamplers' layout
@pytest.mark.parametrize("channels", [0, 15], ids=["3d", "4d15"])
@pytest.mark.parametrize("kind", ["cpp", "affine"])
def test_resamplers_return_file_order(kind, channels):
    """``resample_through_cpp`` and ``resample_through_affine`` hand back
    the reference grid's (X, Y, Z[, C]) shape F-contiguous (NIfTI's byte
    order), with values bit-equal to their device programs' tensors read
    back as they are."""
    rng = np.random.default_rng(5)
    flo = rng.random((20, 18, 16) + ((channels,) if channels else ())
                     ).astype(np.float32)
    flo_affine = np.diag([1.1, 0.9, 1.2, 1.0])
    ref_shape, ref_affine = (17, 19, 14), np.diag([1.0, 1.0, 1.3, 1.0])
    flo_inv = np.linalg.inv(flo_affine)
    if kind == "cpp":
        spacing = (5.0, 5.0, 4.0)
        disp = (rng.standard_normal(
            torch_ffd._grid_counts(ref_shape, spacing) + (3,)) * 1.5
                ).astype(np.float32)
        got = resample_through_cpp(flo, flo_affine,
                                   CppGrid(disp, spacing, ref_affine),
                                   ref_shape, ref_affine, device="cpu")
        program, args = _resample_cpp, (disp, spacing, flo_inv, ref_affine,
                                        ref_shape)
    else:
        A = np.eye(4)
        A[:3, :3] += rng.standard_normal((3, 3)) * 0.04
        A[:3, 3] = [1.5, -1.0, 0.5]
        got = resample_through_affine(flo, flo_affine, A, ref_shape,
                                      ref_affine, device="cpu")
        program, args = _resample_affine, (A, flo_inv, ref_affine, ref_shape)
    with torch.no_grad(), exact_float32():
        want = program(torch.from_numpy(flo), *args).numpy()
    assert want.flags.c_contiguous
    assert got.shape == want.shape == ref_shape + want.shape[3:]
    assert got.dtype == np.float32 and got.flags.f_contiguous
    assert float(np.abs(want).max()) > 0.1
    assert got.tobytes() == want.tobytes()


# ------------------------------------------------- the transform.nii contract
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cpp_grid_round_trips_across_packages(tmp_path, writer):
    """A grid on a 1x1x3 mm reference written by one package and read by
    the other: displacements equal, the sform within 1e-6, per-axis
    spacing recovered."""
    rng = np.random.default_rng(2)
    ref_affine = np.diag([1.0, 1.0, 3.0, 1.0])
    ref_affine[:3, 3] = [-4.0, 2.5, 7.0]
    spacing = (9.0, 9.0, 3.0)
    disp = rng.standard_normal(
        jax_ffd._grid_counts((36, 36, 12), spacing) + (3,)).astype(np.float32)
    path = str(tmp_path / "transform.nii")
    other = str(tmp_path / "other.nii")
    torch_ffd.save_cpp_grid(CppGrid(disp, spacing, ref_affine), path)
    jax_ffd.save_cpp_grid(jax_backend.CppGrid(disp, spacing, ref_affine),
                          other)
    np.testing.assert_allclose(jax_load_nii(path).affine,
                               jax_load_nii(other).affine, atol=1e-6)
    np.testing.assert_array_equal(jax_load_nii(path).data,
                                  jax_load_nii(other).data)
    if writer == "port":
        got = jax_backend.load_cpp_grid(path, ref_affine)
    else:
        got = load_cpp_grid(other, ref_affine)
        assert isinstance(got.disp, np.ndarray)
    np.testing.assert_array_equal(np.asarray(got.disp), disp)
    np.testing.assert_allclose(spacing3(got.spacing), spacing, rtol=1e-5)
    np.testing.assert_array_equal(got.ref_affine, ref_affine)


@pytest.mark.skipif(not os.path.exists(os.path.join(TOOLS, "reg_resample")),
                    reason="native tools not built (cd native && make)")
def test_ffd_transform_consumable_by_cpp_tool(warped_pair, ssd_runs, tmp_path):
    """The port's transform.nii through tools/reg_resample agrees with the
    port's own resampler, at tests/test_jax_ffd.py:181's tolerances."""
    ref, flo = warped_pair
    cpp = str(tmp_path / "transform.nii")
    torch_ffd.save_cpp_grid(ssd_runs[0][0], cpp)
    ref_p, flo_p = str(tmp_path / "ref.nii.gz"), str(tmp_path / "flo.nii.gz")
    save_nii(NiftiImage(ref), ref_p)
    save_nii(NiftiImage(flo), flo_p)
    out = str(tmp_path / "out.nii.gz")
    r = subprocess.run([os.path.join(TOOLS, "reg_resample"), "-ref", ref_p,
                        "-flo", flo_p, "-trans", cpp, "-res", out],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    got = _port_warp(flo, load_cpp_grid(cpp, np.eye(4)), ref.shape)
    np.testing.assert_allclose(jax_load_nii(out).data, got, atol=5e-3,
                               rtol=1e-3)
