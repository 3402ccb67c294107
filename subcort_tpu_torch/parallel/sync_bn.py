"""The collectives of the data-parallel train step.

The JAX package trains data-parallel under one global-semantics ``jit``
over a sharded batch (subcort_tpu/engine/train.py:486-530): BN batch
statistics, the loss mean and every random draw are over the global batch
of ``batch_size x world`` rows, and XLA inserts the collectives. The port
runs one process per device, so it inserts them itself, here:

- :class:`SyncBatchNorm`: Lasagne's train-mode BN over every rank's rows
  (two all-reduces forward, one backward);
- :func:`local_rows`: a rank's rows ``[r*B, (r+1)*B)`` of a tensor drawn
  for the global batch, so augmentation and dropout draw what one process
  at batch ``B x world`` draws;
- :func:`all_reduce_gradients`: the summed gradients over the world, in one
  flat bucket, divided by it (the mean cross-entropy of the global batch);
- :func:`broadcast_module`: rank 0's parameters and buffers to every rank.

What runs inside the step reads nothing back to the host, takes no host
input but shapes (the BN count is host arithmetic) and allocates its
buffers (the flat gradient bucket) inside the step, so an NCCL rank
captures its step, collectives included, in a CUDA graph and replays it
(``engine/train.py::make_train_multistep``); gloo's collectives cannot be
captured, so its ranks run the step eagerly.

The trainer turns this on for one rank's process with
:func:`data_parallel`; nothing here acts outside that block, so a process
that joined a group for something else (the multi-process folder sweep of
:mod:`~subcort_tpu_torch.parallel.distributed`) trains as one device.
``torch.nn.SyncBatchNorm`` does not serve: it refuses CPU tensors and
keeps running mean and variance, not Lasagne's ``inv_std``.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, NamedTuple, Optional

import torch
import torch.distributed as dist


class DataParallel(NamedTuple):
    """This process's place in the data-parallel step."""
    rank: int
    world: int


_ACTIVE: Optional[DataParallel] = None


@contextlib.contextmanager
def data_parallel(rank: int, world: int):
    """The block runs as rank ``rank`` of ``world`` in the default process
    group, which the caller has joined."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, DataParallel(int(rank), int(world))
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = saved


def active() -> Optional[DataParallel]:
    """The data-parallel context of this process, or None."""
    return _ACTIVE


def global_rows(b: int) -> int:
    """Rows of the global batch of which this rank holds ``b``."""
    return b * _ACTIVE.world if _ACTIVE is not None else b


def local_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous share of ``t`` along ``dim`` (``t`` whole
    outside a data-parallel block)."""
    if _ACTIVE is None:
        return t
    b = t.shape[dim] // _ACTIVE.world
    return t.narrow(dim, _ACTIVE.rank * b, b)


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t)
    return t


def _accumulation_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or ``x``'s dtype where it is wider (float64)."""
    return torch.promote_types(x.dtype, torch.float32)


class SyncBatchNorm(torch.autograd.Function):
    """Lasagne's train-mode BN over the global batch of every rank.

    Forward, in float32 (float64 for float64 ``x``): the per-channel sums are
    all-reduced for the global mean (every rank holds as many rows, so the
    count needs none), then the centred sums of squares for the biased
    variance (not E[x^2] - E[x]^2, which loses digits);
    ``inv_std = rsqrt(var + eps)``. Below float32 the mean and the
    variance round to ``x``'s dtype and ``y`` is taken op by op in it,
    where the single-device branch of ``_BatchNorm`` rounds. Backward
    all-reduces the two per-channel sums (dy, dy * x_hat) of the standard
    BN gradient, in the same width; gamma's and beta's gradients stay this rank's
    sums, reduced with every other gradient by
    :func:`all_reduce_gradients`. Returns (y, mean, inv_std)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        c = x.shape[1]
        # every rank holds the same number of rows, so the global count is
        # known without a collective (and exact, where a float32 sum of
        # counts would round above 2^24)
        count = float(x.numel() // c * _ACTIVE.world)
        acc = _accumulation_dtype(x)
        xa = x.to(acc)
        mean_a = _all_reduce(xa.sum((0, 2, 3))) / count
        centred = xa - mean_a[:, None, None]
        var_a = _all_reduce((centred * centred).sum((0, 2, 3))) / count
        if x.dtype == acc:
            mean, inv_std = mean_a, torch.rsqrt(var_a + eps)
            y = centred * (inv_std * gamma)[:, None, None] + beta[:, None, None]
        else:
            mean, var = mean_a.to(x.dtype), var_a.to(x.dtype)
            inv_std = torch.rsqrt((var + eps).to(acc)).to(x.dtype)
            y = ((x - mean[:, None, None]) * (inv_std * gamma)[:, None, None]
                 + beta[:, None, None])
        ctx.save_for_backward(x, mean, inv_std, gamma)
        ctx.count = count
        ctx.mark_non_differentiable(mean, inv_std)
        return y, mean, inv_std

    @staticmethod
    def backward(ctx, dy, _dmean, _dinv_std):
        x, mean, inv_std, gamma = ctx.saved_tensors
        count = ctx.count
        c = x.shape[1]
        acc = _accumulation_dtype(x)
        g = dy.to(acc)
        istd = inv_std.to(acc)[:, None, None]
        xhat = (x.to(acc) - mean.to(acc)[:, None, None]) * istd
        local = torch.cat([g.sum((0, 2, 3)), (g * xhat).sum((0, 2, 3))])
        dbeta, dgamma = local[:c].clone(), local[c:].clone()
        total = _all_reduce(local)
        scale = (gamma.to(acc)[:, None, None] * istd) / count
        dx = scale * (count * g - total[:c, None, None]
                      - xhat * total[c:, None, None])
        return (dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype),
                None)


def sync_batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float):
    """:class:`SyncBatchNorm` on (N, C, H, W) ``x``: (y, mean, inv_std)."""
    return SyncBatchNorm.apply(x, gamma, beta, eps)


def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Every gradient summed over the world and divided by it, through one
    flat bucket, in place. No-op outside a data-parallel block."""
    if _ACTIVE is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    flat /= _ACTIVE.world
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """``t`` (on this rank's device) averaged over the world; ``t`` itself
    outside a data-parallel block."""
    if _ACTIVE is None:
        return t
    return _all_reduce(t.clone()) / _ACTIVE.world


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the world; ``t`` itself outside a block."""
    if _ACTIVE is None:
        return t
    return _all_reduce(t.clone())


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers into every rank's module, in
    place. No-op outside a data-parallel block."""
    if _ACTIVE is None:
        return
    for t in [*module.parameters(), *module.buffers()]:
        dist.broadcast(t.data, src)
