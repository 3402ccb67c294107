"""Parameters to and from a Theano/Lasagne checkpoint, or from the JAX
package.

Port of subcort_tpu/models/importer.py. The reference's
checkpoint is a Python-2 pickle of an OrderedDict from Lasagne layer name
to parameter list (``nets/miccai2012_v1/miccai2012_v1.pkl``). Versus the
JAX importer:

- Lasagne ``Conv2DLayer`` has ``flip_filters=True`` (a true convolution)
  and torch convs are cross-correlations, so kernels are still flipped
  spatially; they stay OIHW.
- Lasagne flattens NCHW in (c, h, w) order, as the port does, so the d1
  row permutation of the JAX importer drops.
- Dense weights are Lasagne (in, out); ``nn.Linear`` holds (out, in).

:func:`params_from_jax` is the bridge the parity tests use: it turns the
JAX package's params (nested dicts of arrays; nothing of jax is imported)
into the port's state dict.
"""

from __future__ import annotations

import collections
import pickle
from typing import Any, Mapping

import numpy as np
import torch

from subcort_tpu_torch.models.triplanar import (DEFAULT_SPEC, VIEWS, Params,
                                                TriPlanarSpec)

_REF_VIEW = {"axial": "axial", "coronal": "coronal", "sagittal": "saggital"}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def load_theano_checkpoint(path: str) -> Params:
    """Read a reference-format pickle into the port's state dict.

    Works on the shipped py2 pickle (``encoding='latin1'``) and on pickles
    written by :func:`save_theano_checkpoint` or by the JAX package's
    ``save_theano_checkpoint``.
    Shapes come from the file; the d1 rows need no spec, since both sides
    flatten (c, h, w).
    """
    with open(path, "rb") as fh:
        raw = pickle.load(fh, encoding="latin1")

    params: Params = {}
    for view in VIEWS:
        r = _REF_VIEW[view]
        for i in range(1, 6):
            (w,) = raw[f"{r}_ch_conv{i}"]
            params[f"{view}.conv{i}.weight"] = _t(np.asarray(w)[:, :, ::-1, ::-1])
            for name, v in zip(("beta", "gamma", "mean", "inv_std"),
                               raw[f"{r}_ch_conv{i}_bn"]):
                params[f"{view}.bn{i}.{name}"] = _t(v)
            params[f"{view}.prelu{i}"] = _t(raw[f"{r}_ch_prelu{i}"][0])
        w, b = raw[f"{r}_d1"]
        params[f"{view}.d1.weight"] = _t(np.asarray(w).T)
        params[f"{view}.d1.bias"] = _t(b)
        params[f"{view}.prelu_d1"] = _t(raw[f"{r}_prelu_d1"][0])
    for ours, theirs, prelu in (("fc1", "FC1", "prelu_f1"),
                                ("fc2", "fc_2", "prelu_f2"),
                                ("out", "out_layer", None)):
        w, b = raw[theirs]
        params[f"{ours}.weight"] = _t(np.asarray(w).T)
        params[f"{ours}.bias"] = _t(b)
        if prelu:
            params[prelu] = _t(raw[prelu][0])
    return params


def save_theano_checkpoint(params: Params, path: str) -> None:
    """Write the port's state dict as a reference-format pickle, the inverse
    of :func:`load_theano_checkpoint` (importer.py:113-155): conv kernels
    flipped back to true convolutions, dense weights in Lasagne's (in, out)
    layout, and the reference's parameterless layer keys in the JAX
    package's order, pickle protocol 2. The JAX package's
    ``load_theano_checkpoint`` reads the file, as the reference's tooling
    does."""
    out: "collections.OrderedDict[str, list]" = collections.OrderedDict()

    def np32(key: str, flip: bool = False, transpose: bool = False):
        a = params[key].detach().cpu().numpy().astype(np.float32)
        if flip:
            a = a[:, :, ::-1, ::-1]
        if transpose:
            a = a.T
        return np.ascontiguousarray(a)

    for view, inp in zip(VIEWS, ("in1", "in2", "in3")):
        r = _REF_VIEW[view]
        out[inp] = []
        for i in range(1, 6):
            out[f"{r}_ch_conv{i}"] = [np32(f"{view}.conv{i}.weight",
                                           flip=True)]
            out[f"{r}_ch_conv{i}_bn"] = [np32(f"{view}.bn{i}.{name}") for name
                                         in ("beta", "gamma", "mean",
                                             "inv_std")]
            out[f"{r}_ch_conv{i}_bn_nonlin"] = []
            out[f"{r}_ch_prelu{i}"] = [np32(f"{view}.prelu{i}")]
            if i == 2:
                out[f"{r}_max_pool_1"] = []
            if i == 4:
                out[f"{r}_max_pool_2"] = []
        out[f"{r}_l1drop"] = []
        out[f"{r}_d1"] = [np32(f"{view}.d1.weight", transpose=True),
                          np32(f"{view}.d1.bias")]
        out[f"{r}_prelu_d1"] = [np32(f"{view}.prelu_d1")]

    out["elem_channels"] = []
    out["f1_drop"] = []
    out["FC1"] = [np32("fc1.weight", transpose=True), np32("fc1.bias")]
    out["prelu_f1"] = [np32("prelu_f1")]
    out["f2_drop"] = []
    out["in4"] = []
    out["elem_channels2"] = []
    out["fc_2"] = [np32("fc2.weight", transpose=True), np32("fc2.bias")]
    out["prelu_f2"] = [np32("prelu_f2")]
    out["out_layer"] = [np32("out.weight", transpose=True), np32("out.bias")]

    with open(path, "wb") as fh:
        pickle.dump(out, fh, protocol=2)


def params_from_jax(tree: Mapping[str, Any],
                    spec: TriPlanarSpec = DEFAULT_SPEC) -> Params:
    """The JAX package's params tree -> the port's state dict.

    Conv kernels HWIO -> OIHW (both cross-correlations: no flip); d1 rows
    from the JAX (h, w, c) flatten back to (c, h, w); dense (in, out) ->
    (out, in). Leaves may be jax or numpy arrays.
    """
    side, c5 = spec.branch_side, spec.conv_filters[4]
    params: Params = {}
    for view in VIEWS:
        bp = tree[view]
        for i in range(1, 6):
            w = np.asarray(bp[f"conv{i}"]["w"], np.float32)
            params[f"{view}.conv{i}.weight"] = _t(w.transpose(3, 2, 0, 1))
            for name in ("beta", "gamma", "mean", "inv_std"):
                params[f"{view}.bn{i}.{name}"] = _t(bp[f"bn{i}"][name])
            params[f"{view}.prelu{i}"] = _t(bp[f"prelu{i}"])
        w = np.asarray(bp["d1"]["w"], np.float32)
        w = w.reshape(side, side, c5, -1).transpose(2, 0, 1, 3)
        params[f"{view}.d1.weight"] = _t(w.reshape(spec.branch_flat, -1).T)
        params[f"{view}.d1.bias"] = _t(bp["d1"]["b"])
        params[f"{view}.prelu_d1"] = _t(bp["prelu_d1"])
    h = tree["head"]
    for name in ("fc1", "fc2", "out"):
        params[f"{name}.weight"] = _t(np.asarray(h[name]["w"], np.float32).T)
        params[f"{name}.bias"] = _t(h[name]["b"])
    params["prelu_f1"] = _t(h["prelu_f1"])
    params["prelu_f2"] = _t(h["prelu_f2"])
    return params
