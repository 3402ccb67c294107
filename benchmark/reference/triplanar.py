"""Plain reference of the tri-planar network (cnn_cort/nets.py:159-231, the
published architecture of arXiv:1709.09075) in its own patch formulation.

Plain ``torch`` operations on a dict of leaves, nothing of the program:

    per view, on (N, 1, 32, 32) patches:
      conv 3x3 (no bias) -> BN -> PReLU   x5, 2x2 max-pool after the 2nd and 4th
      dropout 0.5 (training) -> dense 540->180 -> PReLU
    head: concat -> dropout -> FC 540 -> PReLU -> dropout -> concat atlas (15)
          -> FC 270 -> PReLU -> FC 15 (logits)

Lasagne's BN: at inference ``(x - mean) * (inv_std * gamma) + beta`` with
the stored statistics; in training the batch's mean and biased variance over
(N, H, W), ``inv_std = 1 / sqrt(var + eps)``, and afterwards the running
averages ``stored = (1 - alpha) stored + alpha batch`` of mean and inv_std.
Adam is optax's arithmetic (lr 1e-3, b1 0.9, b2 0.999, eps 1e-8). Dropout
is inverted dropout whose masks are Bernoulli draws from the generator of
the run, one draw per dropout layer in the order axial, coronal, sagittal,
head input, head FC (the order of the layers in the architecture above).

``precision`` is ``"float32"`` (TF32 off) or ``"tf32"``, the control: the
operands of every convolution and matrix product rounded to TF32's 10-bit
mantissa, products accumulated in float32, which is what the tensor cores'
TF32 mode computes; the same arithmetic on the CPU and on the card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import frozen

VIEWS = ("axial", "coronal", "sagittal")
POOL_AFTER = (2, 4)
ADAM = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


@contextlib.contextmanager
def full_float32():
    """TF32 off for the block, the flags restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on TF32's 10-bit mantissa (the 13 low bits
    of the significand cleared)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _round_op(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return t
    if precision == "tf32":
        # the rounding's gradient is the identity: TF32 rounds operands
        return t + (to_tf32(t.detach()) - t.detach())
    raise ValueError(f"unknown precision {precision!r}")


def _conv(x, w, precision):
    return F.conv2d(_round_op(x, precision), _round_op(w, precision))


def _linear(x, w, b, precision):
    return F.linear(_round_op(x, precision), _round_op(w, precision), b)


def _prelu(x, a):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return torch.where(x >= 0, x, x * a.view(shape))


def _bn(x, p, key, eps, train, stats):
    gamma, beta = p[key + ".gamma"], p[key + ".beta"]
    if train:
        var, mean = torch.var_mean(x, (0, 2, 3), correction=0)
        inv_std = torch.rsqrt(var + eps)
        stats[key] = (mean.detach(), inv_std.detach())
    else:
        mean, inv_std = p[key + ".mean"], p[key + ".inv_std"]
    return ((x - mean[None, :, None, None])
            * (inv_std * gamma)[None, :, None, None]
            + beta[None, :, None, None])


def _dropout(x, rate, generator):
    keep = 1.0 - rate
    mask = torch.bernoulli(torch.empty(x.shape, device=x.device), keep,
                           generator=generator)
    return torch.where(mask.bool(), x / keep, 0.0)


def forward(p: dict, cfg: dict, views, atlas, *, train: bool = False,
            generator=None, precision: str = "float32"):
    """Logits (N, classes) of three (N, 32, 32) patch stacks and the (N, 15)
    priors; with ``train`` also the BN layers' batch statistics."""
    eps = float(cfg["bn_epsilon"])
    stats = {}
    feats = []
    for view, x in zip(VIEWS, views):
        x = x[:, None]
        for i in range(1, len(cfg["conv_filters"]) + 1):
            x = _conv(x, p[f"{view}.conv{i}.weight"], precision)
            x = _bn(x, p, f"{view}.bn{i}", eps, train, stats)
            x = _prelu(x, p[f"{view}.prelu{i}"])
            if i in POOL_AFTER:
                x = F.max_pool2d(x, 2)
        if train:
            x = _dropout(x, cfg["dropout_conv"], generator)
        x = _linear(x.flatten(1), p[f"{view}.d1.weight"], p[f"{view}.d1.bias"],
                    precision)
        feats.append(_prelu(x, p[f"{view}.prelu_d1"]))
    x = torch.cat(feats, 1)
    if train:
        x = _dropout(x, cfg["dropout_fc"], generator)
    x = _prelu(_linear(x, p["fc1.weight"], p["fc1.bias"], precision),
               p["prelu_f1"])
    if train:
        x = _dropout(x, cfg["dropout_fc"], generator)
    x = torch.cat([x, atlas], 1)
    x = _prelu(_linear(x, p["fc2.weight"], p["fc2.bias"], precision),
               p["prelu_f2"])
    logits = _linear(x, p["out.weight"], p["out.bias"], precision)
    return (logits, stats) if train else logits


# ------------------------------------------------------------------ inference
def quantized_priors(atlas: np.ndarray, centers: np.ndarray,
                     prior_dtype: str) -> np.ndarray:
    """The priors at ``centers``, a row that sums to 0 made background
    (channel 14 = 1), then on the configuration's fixed point: uint16 is
    ``round(p * 65535) / 65535``, uint8 ``round(p * 255) / 255``."""
    rows = atlas[centers[:, 0], centers[:, 1], centers[:, 2]].astype(
        np.float32)
    empty = rows.sum(1) == 0
    rows[empty] = 0.0
    rows[empty, 14] = 1.0
    if prior_dtype == "uint16":
        return (np.round(rows * 65535.0) / 65535.0).astype(np.float32)
    if prior_dtype == "uint8":
        return (np.round(rows * 255.0) / 255.0).astype(np.float32)
    return rows


def normalized_padded(image: np.ndarray) -> np.ndarray:
    """``(x - mean) / std`` over the nonzero voxels' statistics (float64),
    applied in float32 to every voxel, then zero-padded by 16."""
    vol = np.asarray(image)
    nz = vol[vol != 0].astype(np.float64)
    mean, std = nz.mean(), nz.std()
    norm = ((vol.astype(np.float32) - np.float32(mean))
            * np.float32(1.0 / std))
    return np.pad(norm, frozen.HALF)


def gather(padded: torch.Tensor, centers: torch.Tensor):
    """Axial, coronal and sagittal 32x32 windows of each center."""
    idx = frozen.window_index(centers, padded.shape)
    w = padded.reshape(-1)[idx]
    return w[:, 0], w[:, 1], w[:, 2]


@torch.no_grad()
def scan_logits(p: dict, cfg: dict, image: np.ndarray, atlas: np.ndarray,
                centers: np.ndarray, device, precision: str = "float32",
                chunk: int = 8192) -> np.ndarray:
    """(N, classes) float32 logits of the network at every center of one
    scan, patch by patch."""
    padded = torch.from_numpy(normalized_padded(image)).to(device)
    priors = quantized_priors(atlas, centers, cfg["prior_dtype"])
    out = []
    with full_float32():
        for a in range(0, len(centers), chunk):
            c = torch.from_numpy(centers[a:a + chunk]).to(device)
            pr = torch.from_numpy(priors[a:a + chunk]).to(device)
            out.append(forward(p, cfg, gather(padded, c), pr,
                               precision=precision).float().cpu())
    return torch.cat(out).numpy()


# ------------------------------------------------------------------ training
def _adam(p: dict, grads: dict, state: dict, t: int):
    b1, b2 = ADAM["b1"], ADAM["b2"]
    for k, g in grads.items():
        mu, nu = state.setdefault(k, (torch.zeros_like(g), torch.zeros_like(g)))
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        state[k] = (mu, nu)
        mu_hat = mu / (1 - b1 ** t)
        nu_hat = nu / (1 - b2 ** t)
        p[k] = p[k] - ADAM["lr"] * mu_hat / (torch.sqrt(nu_hat) + ADAM["eps"])


def train_steps(p0: dict, cfg: dict, volumes: torch.Tensor, batches,
                generator: torch.Generator, precision: str = "float32"):
    """Train steps on ``batches`` ((centers (B, 4), labels (B,), priors
    (B, 15)) on the device) from leaves ``p0``: per step the gather from
    the padded subject stack ``volumes``, the train-mode forward with
    dropout drawn from ``generator``, mean cross-entropy, backward, Adam,
    then the BN running averages. Returns (the losses, the first step's
    gradients, the leaves after every step)."""
    p = {k: v.detach().clone() for k, v in p0.items()}
    trainable = [k for k in p if not k.endswith((".mean", ".inv_std"))]
    alpha = float(cfg["bn_alpha"])
    state, losses, grad1, after = {}, [], None, []
    with full_float32():
        for t, (centers, labels, priors) in enumerate(batches, start=1):
            views = gather(volumes, centers)
            leaves = {k: (v.requires_grad_(True) if k in trainable else v)
                      for k, v in p.items()}
            logits, stats = forward(leaves, cfg, views, priors, train=True,
                                    generator=generator, precision=precision)
            loss = F.cross_entropy(logits.float(), labels.long())
            grads = torch.autograd.grad(loss, [leaves[k] for k in trainable])
            grads = dict(zip(trainable, grads))
            if grad1 is None:
                grad1 = {k: g.detach().clone() for k, g in grads.items()}
            p = {k: v.detach() for k, v in leaves.items()}
            with torch.no_grad():
                _adam(p, grads, state, t)
                for key, (mean, inv_std) in stats.items():
                    p[key + ".mean"] = (1 - alpha) * p[key + ".mean"] \
                        + alpha * mean
                    p[key + ".inv_std"] = (1 - alpha) * p[key + ".inv_std"] \
                        + alpha * inv_std
            losses.append(float(loss.detach()))
            after.append({k: v.clone() for k, v in p.items()})
    return losses, grad1, after


@torch.no_grad()
def eval_loss(p: dict, cfg: dict, volumes: torch.Tensor, centers, labels,
              priors, chunk: int = 2048) -> float:
    """Mean cross-entropy over the rows with BN's stored statistics."""
    total = 0.0
    with full_float32():
        for a in range(0, len(labels), chunk):
            logits = forward(p, cfg, gather(volumes, centers[a:a + chunk]),
                             priors[a:a + chunk])
            total += float(F.cross_entropy(logits.float(),
                                           labels[a:a + chunk].long(),
                                           reduction="sum"))
    return total / max(len(labels), 1)
