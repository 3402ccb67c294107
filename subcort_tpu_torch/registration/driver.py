"""Registration orchestrator (layer L2; port of
subcort_tpu/registration/driver.py).

Reference counterpart: ``register_masks`` (cnn_cort/base.py:483-551), the
subprocess pipeline that registers the MNI template onto a subject T1 and
warps the 15-channel probabilistic subcortical atlas into subject space.
The file/cache contract is preserved exactly:

    <scan_dir>/tmp/transf.txt                  affine (reg_aladin)
    <scan_dir>/tmp/rT1_template.nii.gz         affinely resampled template
    <scan_dir>/tmp/transform.nii               B-spline control grid (reg_f3d)
    <scan_dir>/tmp/rT1d_template.nii.gz        deformably resampled template
    <scan_dir>/tmp/MNI_sub_probabilities.nii.gz  (X,Y,Z,15) priors
    <scan_dir>/tmp/MNI_subcortical_mask.nii.gz   dilated binary ROI

with the same stage-wise idempotence (each stage skipped when its product
exists: a killed run resumes, base.py:508,516,526). The C++ tools live in
``tools/`` (built from ``native/``) and speak the same CLI as NiftyReg.

Atlas assets (``T1_template.nii.gz``, ``atlas_subcortical_MNI.nii.gz``
(X,Y,Z,15), channel 14 = background) are external data: the reference
ships them via git-LFS. Their directory is resolved from, in order: the
``atlas_dir`` argument, ``$SUBCORT_ATLAS_DIR``,
``subcort_tpu_torch/atlases/``.

Backends: ``"torch"`` (the default) runs the affine, the FFD and the prior
warp on ``device``, which is the card unless the caller names another;
``"native"`` is the opt-in that drives the C++ tools on the CPU end to end
(the JAX package's default, and the one default the port changes). The JAX
package's ``"jax"`` backend does not exist here and raises: an option is
never rerouted silently.

Improvements over the reference, each behind a flag:
- the 15 prior channels are warped in ONE 4D resample instead of 15
  single-channel subprocess round-trips (``per_channel=True`` restores the
  reference's loop);
- the binary ROI mask sums channels 0:14; the reference sums 0:13,
  excluding structure 13: ``bugcompat_mask_channels`` (default True, to
  match the shipped masks) reproduces that.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import numpy as np
import torch
from scipy import ndimage

from subcort_tpu_torch.config import resolve_device
from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii
from subcort_tpu_torch.registration.torch_affine import register_affine_torch
from subcort_tpu_torch.registration.torch_backend import (
    load_cpp_grid, resample_through_affine, resample_through_cpp)
from subcort_tpu_torch.registration.torch_ffd import (register_ffd_torch,
                                                      save_cpp_grid)
from subcort_tpu_torch.utils.runtime import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_DIR = os.path.dirname(_PKG_DIR)
DEFAULT_TOOLS_DIR = os.path.join(_REPO_DIR, "tools")
DEFAULT_ATLAS_DIR = os.path.join(_PKG_DIR, "atlases")

TEMPLATE_NAME = "T1_template.nii.gz"
ATLAS_NAME = "atlas_subcortical_MNI.nii.gz"

BACKENDS = ("native", "torch")
SIMILARITIES = ("ssd", "nmi")


class RegistrationError(RuntimeError):
    pass


def check_registration(backend: str, similarity: str) -> None:
    """Raise ``ValueError`` for a registration backend or cost the port
    lacks: the one validator of ``reg_backend`` and ``reg_similarity``."""
    if backend == "jax":
        raise ValueError(
            "reg_backend 'jax' belongs to the JAX package; the port's "
            "on-device backend is 'torch' (or 'native' for the C++ tools)")
    if backend not in BACKENDS:
        raise ValueError(f"reg_backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if similarity not in SIMILARITIES:
        raise ValueError(f"reg_similarity must be one of {SIMILARITIES}, "
                         f"got {similarity!r}")


def _resolve_atlas_dir(atlas_dir: str | None) -> str:
    for cand in (atlas_dir, os.environ.get("SUBCORT_ATLAS_DIR"), DEFAULT_ATLAS_DIR):
        if cand and os.path.exists(os.path.join(cand, TEMPLATE_NAME)):
            return cand
    raise RegistrationError(
        "atlas assets not found (T1_template.nii.gz / "
        "atlas_subcortical_MNI.nii.gz). They are external data (git-LFS in "
        "the reference). Set SUBCORT_ATLAS_DIR or pass atlas_dir; for tests "
        "use subcort_tpu_torch.registration.atlas.make_synthetic_atlas().")


def _run(cmd: list[str]) -> None:
    r = subprocess.run(cmd, stdout=subprocess.DEVNULL,
                       stderr=subprocess.PIPE, text=True)
    if r.returncode != 0:
        raise RegistrationError(f"{cmd[0]} failed ({r.returncode}): {r.stderr[-800:]}")


@contextlib.contextmanager
def _stage(name: str, device):
    """One stage of :func:`register_masks` that ran (a cached one opens
    none) as a ``register.<name>`` span: the fit or warp with its
    resample, with the NIfTI reads and writes (:func:`_io`) and the ROI
    mask (:func:`_mask`) as its children, so that its self time is the
    rest. While spans record on a card, the stage resets the device's peak
    memory statistics and keeps the peak as ``peak_bytes``."""
    with span("register." + name) as rec:
        cuda = bool(rec) and device is not None and device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        yield
        if cuda:
            rec.set(peak_bytes=torch.cuda.max_memory_allocated(device))


def _io(fn, *args):
    """``fn(*args)``, a NIfTI read or write, as a ``register.io`` span."""
    with span("register.io"):
        return fn(*args)


def _mask(fn, *args):
    """``fn(*args)``, the ROI mask, as a ``register.mask`` span."""
    with span("register.mask"):
        return fn(*args)


def _roi_mask(s_atlas: np.ndarray, hi: int, dilate_iters: int) -> np.ndarray:
    mask = np.sum(s_atlas[:, :, :, 0:hi], axis=3) > 0
    return ndimage.binary_dilation(mask, iterations=dilate_iters)


def register_masks(input_scan: str, atlas_dir: str | None = None,
                   tools_dir: str | None = None, per_channel: bool = False,
                   bugcompat_mask_channels: bool = True,
                   dilate_iters: int = 5, backend: str = "torch",
                   similarity: str = "nmi", device=None,
                   _eager: bool = False) -> float:
    """Register the MNI atlas into subject space; returns elapsed seconds
    (the reference returns seconds too and the caller prints minutes).

    backend='torch' (the default) is self-contained on ``device``
    (``None``: the default card, which raises without one): a 12-dof gradient-descent affine
    (registration/torch_affine.py) for stage 1, the differentiable B-spline
    FFD (registration/torch_ffd.py) for stage 2, and the one-pass resampler
    for the 15 prior channels, with the same transf.txt / transform.nii
    contracts either way and no dependency on the native toolchain
    (reference counterpart: base.py:510-521). backend='native' is the
    opt-in that runs the C++ tools on the CPU end to end.

    similarity='nmi' (default) or 'ssd' selects the deformable-stage cost.
    The reference's reg_f3d is NiftyReg's NMI-driven FFD (base.py:516-521),
    so NMI is the default here too: registering the MNI *template* onto an
    arbitrary scanner T1 is exactly the cross-protocol intensity situation
    NMI exists for (SSD mis-registers intensity-remapped pairs). SSD
    remains opt-in for same-protocol pairs.

    On the card every optimiser level runs as one captured iteration
    replayed (torch_backend.run_level); ``_eager`` runs them as plain
    loops, for comparisons of the two.

    The call is one ``register.masks`` span; each stage that runs is a
    child (``register.affine``, ``register.ffd``, ``register.prior_warp``:
    :func:`_stage`), its optimiser levels ``register.level`` spans.
    """
    check_registration(backend, similarity)
    with span("register.masks"):
        return _register_masks(input_scan, atlas_dir, tools_dir, per_channel,
                               bugcompat_mask_channels, dilate_iters,
                               backend, similarity, device, _eager)


def _register_masks(input_scan, atlas_dir, tools_dir, per_channel,
                    bugcompat_mask_channels, dilate_iters, backend,
                    similarity, device, _eager) -> float:
    """:func:`register_masks` inside its span."""
    on_device = backend == "torch"
    device = resolve_device(device) if on_device else None
    image_dir, _ = os.path.split(os.path.abspath(input_scan))
    tmp = os.path.join(image_dir, "tmp")
    os.makedirs(tmp, exist_ok=True)
    tools = tools_dir or DEFAULT_TOOLS_DIR
    atlases = _resolve_atlas_dir(atlas_dir)
    template = os.path.join(atlases, TEMPLATE_NAME)
    atlas4d = os.path.join(atlases, ATLAS_NAME)
    s_time = time.time()

    transf = os.path.join(tmp, "transf.txt")
    cpp = os.path.join(tmp, "transform.nii")

    # stage 1: affine (native: block matching; torch: on-device 12-dof descent)
    if not os.path.exists(os.path.join(tmp, "rT1_template.nii.gz")):
        if on_device:
            with _stage("affine", device):
                t1_img = _io(load_nii, input_scan)
                tmpl_img = _io(load_nii, template)
                A = register_affine_torch(
                    np.asarray(t1_img.data, np.float32),
                    np.asarray(tmpl_img.data, np.float32),
                    ref_affine=t1_img.affine, flo_affine=tmpl_img.affine,
                    cost=similarity, device=device, _eager=_eager)
                np.savetxt(transf, A, fmt="%.10g")  # transf.txt contract
                warped = resample_through_affine(
                    np.asarray(tmpl_img.data, np.float32), tmpl_img.affine,
                    A, t1_img.shape, t1_img.affine, device=device)
                _io(save_nii, NiftiImage(warped, t1_img.affine),
                    os.path.join(tmp, "rT1_template.nii.gz"))
        else:
            _run([os.path.join(tools, "reg_aladin"),
                  "-ref", input_scan, "-flo", template,
                  "-aff", transf,
                  "-res", os.path.join(tmp, "rT1_template.nii.gz")])

    # stage 2: deformable (B-spline FFD)
    if not os.path.exists(os.path.join(tmp, "rT1d_template.nii.gz")):
        if on_device:
            with _stage("ffd", device):
                t1_img = _io(load_nii, input_scan)
                tmpl_img = _io(load_nii, template)
                A = np.loadtxt(transf)
                grid, _ = register_ffd_torch(
                    np.asarray(t1_img.data, np.float32),
                    np.asarray(tmpl_img.data, np.float32),
                    ref_affine=t1_img.affine, flo_affine=tmpl_img.affine,
                    init_affine=A, cost=similarity, device=device,
                    _eager=_eager)
                _io(save_cpp_grid, grid, cpp)
                warped = resample_through_cpp(
                    np.asarray(tmpl_img.data, np.float32), tmpl_img.affine,
                    grid, t1_img.shape, t1_img.affine, device=device)
                _io(save_nii, NiftiImage(warped, t1_img.affine),
                    os.path.join(tmp, "rT1d_template.nii.gz"))
        else:
            # pass the cost explicitly: the call's semantics must not depend
            # on the tool's own default (which is also NMI, matching
            # NiftyReg's reg_f3d)
            _run([os.path.join(tools, "reg_f3d"),
                  "-ref", input_scan, "-flo", template,
                  "-aff", transf, "-cpp", cpp,
                  "-res", os.path.join(tmp, "rT1d_template.nii.gz"),
                  "-nmi" if similarity == "nmi" else "-ssd"])

    # stage 3: warp the 15 prior channels + build the binary ROI mask
    prior_path = os.path.join(tmp, "MNI_sub_probabilities.nii.gz")
    if not os.path.exists(prior_path):
        with _stage("prior_warp", device):
            t1 = _io(load_nii, input_scan)
            if on_device:
                atlas_img = _io(load_nii, atlas4d)
                grid = _io(load_cpp_grid, cpp, t1.affine)
                s_atlas = resample_through_cpp(
                    np.asarray(atlas_img.data, np.float32), atlas_img.affine,
                    grid, t1.shape, t1.affine, device=device)
            elif per_channel:
                # reference loop (base.py:530-538): one resample per channel
                atlas_img = load_nii(atlas4d)
                s_atlas = np.zeros(t1.shape + (15,), np.float32)
                for st in range(15):
                    chan = os.path.join(tmp, "tmp.nii.gz")
                    save_nii(NiftiImage(atlas_img.data[:, :, :, st],
                                        atlas_img.affine), chan)
                    _run([os.path.join(tools, "reg_resample"),
                          "-ref", input_scan, "-flo", chan,
                          "-trans", cpp,
                          "-res", os.path.join(tmp, "r_tmp.nii.gz")])
                    s_atlas[:, :, :, st] = load_nii(os.path.join(
                        tmp, "r_tmp.nii.gz")).data.astype(np.float32)
            else:
                _run([os.path.join(tools, "reg_resample"),
                      "-ref", input_scan, "-flo", atlas4d,
                      "-trans", cpp,
                      "-res", os.path.join(tmp, "r_atlas4d.nii.gz")])
                s_atlas = np.asarray(load_nii(
                    os.path.join(tmp, "r_atlas4d.nii.gz")).data, np.float32)

            _io(save_nii, NiftiImage(s_atlas, t1.affine), prior_path)
            hi = 13 if bugcompat_mask_channels else 14  # reference sums 0:13
            dilated = _mask(_roi_mask, s_atlas, hi, dilate_iters)
            _io(save_nii, NiftiImage(dilated.astype(np.float32), t1.affine),
                os.path.join(tmp, "MNI_subcortical_mask.nii.gz"))

    return time.time() - s_time
