"""Training harness (port of subcort_tpu/engine/train.py).

Reference counterpart: nolearn ``NeuralNet.fit`` as configured by
``build_model`` (cnn_cort/nets.py:127-255): categorical cross-entropy,
Adam(lr=1e-3 fixed, Lasagne defaults b1=.9 b2=.999 eps=1e-8), TrainSplit
holdout, per-epoch hooks [SaveWeights(only_best), SaveTrainingHistory,
EarlyStopping(patience)]. Quirks kept as the JAX package keeps them:

- the reference never wires ``options['batch_size']`` into NeuralNet, so
  nolearn's default 128 is what actually trains (SURVEY.md §2.3-5); the
  trainer honors ``options['batch_size']``, and ``batch_size=128`` gives
  the reference's behavior;
- nolearn's BatchIterator does not reshuffle between epochs, so
  ``shuffle_each_epoch`` defaults to False;
- ``augment=True`` turns on the reference's defined but unused rotation /
  flip iterator (nets.py:41-124), and ``intensity_augment`` the JAX
  package's intensity augmentation (no reference analogue).

Patches are gathered on the device in every train and eval step from the
resident subject stack, never shipped from the host: on the card by the
hand-written kernel (``ops/csrc/gather_triplanar.cu``, subject-stack
mode) on ``prepare_gather_volume`` layouts made once per ``fit``; on the
CPU by its plain version. The gather is data, outside autograd. BN uses
batch statistics with Lasagne's EMA (alpha 1e-2) on (mean, inv_std),
applied after the optimizer step. The step runs with TF32 off
(``config.exact_float32``), as the reference trains at full float32;
``train_dtype = bfloat16`` runs the forward and backward on a bfloat16
cast of the parameters while the master parameters and Adam's state stay
float32. Randomness (augmentation draws, dropout masks) comes from one
explicit ``torch.Generator`` on the device, never torch's global one.
Adam is :class:`DeviceAdam`: optax's arithmetic, its step count and
learning rate on the device.

``Trainer.fit`` runs its steps through :func:`make_train_multistep`, the
counterpart of the JAX package's ``lax.scan`` of ``steps_per_call``
steps: on the card, in one process or in a data-parallel rank whose group
runs NCCL, one step captured in a CUDA graph and replayed
(:mod:`subcort_tpu_torch.utils.graphs`), the rank's collectives inside
the graph.

History is JSONL plus the reference's ``<name>_history.pkl`` (epoch,
train_loss, valid_loss, valid_accuracy, *_best flags, dur).

Each epoch of ``fit`` is one ``train.epoch`` span, with ``train.rows``,
``train.call`` and ``train.loss_readback`` for each call of steps,
``train.validation`` and ``train.checkpoint`` under it (PERF.md §3).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from subcort_tpu_torch.config import Options, exact_float32, select_device
from subcort_tpu_torch.engine.data import TrainingIndex
from subcort_tpu_torch.models.importer import (load_theano_checkpoint,
                                               save_theano_checkpoint)
from subcort_tpu_torch.models.triplanar import (DEFAULT_SPEC, Params,
                                                TriPlanarNet, TriPlanarSpec,
                                                init_params, update_bn_ema)
from subcort_tpu_torch.ops.gather_kernel import (gather_triplanar_cuda,
                                                 prepare_gather_volume)
from subcort_tpu_torch.ops.patches import Patches
from subcort_tpu_torch.parallel import distributed, sync_bn
from subcort_tpu_torch.parallel.mesh import make_devices, shard_rows
from subcort_tpu_torch.utils.graphs import GraphedStep
from subcort_tpu_torch.utils.runtime import check_nans, span

ADAM = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


class DeviceAdam(torch.optim.Optimizer):
    """Adam with ``optax.adam``'s arithmetic (the JAX package's optimizer):
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, then
    p += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) at step t,
    in float32, over every parameter with a gradient.

    The step count (one for all parameters, ``step`` in each parameter's
    state) and the learning rate (:meth:`set_lr`) are 0-dim float32
    tensors on the parameters' device, so :meth:`step` takes no host input
    and reads nothing back: a CUDA graph can capture it, and a replay uses
    the learning rate of the moment. ``state_dict`` has
    ``torch.optim.Adam``'s layout, and :meth:`load_state_dict` also takes
    one written by ``torch.optim.Adam`` (a step count on the CPU)."""

    def __init__(self, params, lr: float = ADAM["lr"],
                 betas=ADAM["betas"], eps: float = ADAM["eps"]):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        device = self.param_groups[0]["params"][0].device
        self._count = torch.zeros((), dtype=torch.float32, device=device)
        self._lrs = [torch.tensor(g["lr"], dtype=torch.float32,
                                  device=device) for g in self.param_groups]

    def set_lr(self, lr: float) -> None:
        """Every group's learning rate from the next step on."""
        for group, t in zip(self.param_groups, self._lrs):
            group["lr"] = lr
            t.fill_(lr)

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        steps = [st["step"] for st in self.state.values() if "step" in st]
        if steps:
            self._count.copy_(torch.as_tensor(steps[0]))
        else:
            self._count.zero_()
        for st in self.state.values():
            st["step"] = self._count
        for group, t in zip(self.param_groups, self._lrs):
            t.fill_(group["lr"])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("DeviceAdam takes no closure")
        t = self._count + 1.0
        for group, lr in zip(self.param_groups, self._lrs):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(step=self._count,
                                         exp_avg=torch.zeros_like(p),
                                         exp_avg_sq=torch.zeros_like(p))
            grads = [p.grad for p in params]
            mu = [self.state[p]["exp_avg"] for p in params]
            nu = [self.state[p]["exp_avg_sq"] for p in params]
            b1, b2 = group["betas"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1.0 - b2))
            mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(b1, t))
            nu_hat = torch._foreach_div(nu, 1.0 - torch.pow(b2, t))
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mu_hat, denom)
            torch._foreach_mul_(update, -lr)
            torch._foreach_add_(params, update)
        self._count.copy_(t)


# ----------------------------------------------------------------- augmentation
def draw_view_augment(b: int, generator: torch.Generator):
    """The draws of the reference's Rotate_batch_Iterator (nets.py:46-124):
    ``selected`` (b,) bool, exactly ``b // 2`` rows uniformly without
    replacement (nets.py:52), shared by the three views; ``r`` (3, b) int64
    in {0, 1, 2}, drawn independently per view (nets.py:72-78)."""
    device = generator.device
    selected = torch.randperm(b, generator=generator, device=device) < b // 2
    r = torch.randint(0, 3, (3, b), generator=generator, device=device)
    return selected, r


def augment_views(views: Patches, selected: torch.Tensor,
                  r: torch.Tensor) -> Patches:
    """Apply :func:`draw_view_augment`'s draws (train.py:82-107): a selected
    row of view ``v`` becomes [rot180, flip(w), rot180+flip(w)][r[v]] of
    itself; rot180+flip(w) is flip(h). Other rows pass unchanged."""
    out = []
    for view, rv in zip(views, r):
        stacked = torch.stack([view.flip((1, 2)), view.flip(2), view.flip(1)],
                              1)
        aug = stacked[torch.arange(view.shape[0], device=view.device), rv]
        out.append(torch.where(selected[:, None, None], aug, view))
    return tuple(out)


def draw_intensity_augment(shape, strength: float,
                           generator: torch.Generator):
    """The draws of the intensity augmentation (train.py:110-136) for three
    views of ``shape`` (b, p, p): per sample gain ~ U(1 - S/4, 1 + S/4),
    shift ~ U(-S/5, S/5) and sigma ~ U(0, 0.15 S), shared by the views, and
    (3, b, p, p) standard normal noise, one draw per view."""
    b = shape[0]
    device = generator.device
    u = torch.rand((3, b, 1, 1), generator=generator, device=device)
    gain = 1.0 + (u[0] * 0.5 - 0.25) * strength
    shift = (u[1] * 0.4 - 0.2) * strength
    sigma = u[2] * 0.15 * strength
    noise = torch.randn((3,) + tuple(shape), generator=generator,
                        device=device)
    return gain, shift, sigma, noise


def augment_intensity(views: Patches, gain: torch.Tensor, shift: torch.Tensor,
                      sigma: torch.Tensor, noise: torch.Tensor) -> Patches:
    """Apply :func:`draw_intensity_augment`'s draws: per view
    ``view * gain + shift + noise * sigma``."""
    return tuple(v * gain + shift + n * sigma for v, n in zip(views, noise))


# ----------------------------------------------------------------- steps
def _forward(net: TriPlanarNet, views: Patches, atlas: torch.Tensor,
             generator: Optional[torch.Generator],
             compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    if compute_dtype is None:
        return net(*views, atlas, return_logits=True, generator=generator)
    # a cast of every parameter and buffer; the cast's gradient is a cast
    # back, so the float32 master parameters get float32 gradients
    cast = {k: v.to(compute_dtype) for k, v in
            [*net.named_parameters(), *net.named_buffers()]}
    args = tuple(v.to(compute_dtype) for v in (*views, atlas))
    return functional_call(net, cast, args,
                           {"return_logits": True, "generator": generator})


def train_step(net: TriPlanarNet, optimizer: torch.optim.Optimizer,
               views: Patches, labels: torch.Tensor, atlas: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               augment: bool = False, intensity_augment: float = 0.0,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One optimizer step (train.py:173-215) on gathered ``views``:
    augmentation, train-mode forward, mean softmax cross-entropy on float32
    logits, backward, ``optimizer.step()``, then the BN EMA. Returns the
    loss as a 0-dim device tensor (no host sync; with
    ``utils.runtime.enable_nan_checks`` on, a NaN loss raises
    ``FloatingPointError`` before the backward). TF32 is off inside.

    Inside a data-parallel block (:mod:`~subcort_tpu_torch.parallel.sync_bn`)
    this rank's rows are its share of a global batch, and the step is the
    one-process step on that batch: augmentation and dropout drawn for the
    global batch (this rank keeping its rows), BN over every rank's rows,
    and the gradients averaged over the ranks before Adam. The loss
    returned is this rank's rows' mean; the global loss is its mean over
    the ranks."""
    with exact_float32():
        loss = _step_loss(net, optimizer, views, labels, atlas, generator,
                          augment, intensity_augment, compute_dtype)
        check_nans("the train loss", loss)
        _step_update(net, optimizer, loss)
    return loss.detach()


def _step_loss(net, optimizer, views, labels, atlas, generator, augment,
               intensity_augment, compute_dtype) -> torch.Tensor:
    """:func:`train_step` up to the loss: augmentation, cleared
    gradients, the train-mode forward and the cross-entropy."""
    if augment:
        selected, r = draw_view_augment(
            sync_bn.global_rows(len(labels)), generator)
        views = augment_views(views, sync_bn.local_rows(selected),
                              sync_bn.local_rows(r, 1))
    if intensity_augment:
        shape = ((sync_bn.global_rows(views[0].shape[0]),)
                 + tuple(views[0].shape[1:]))
        gain, shift, sigma, noise = draw_intensity_augment(
            shape, intensity_augment, generator)
        views = augment_intensity(
            views, *(sync_bn.local_rows(t) for t in (gain, shift, sigma)),
            sync_bn.local_rows(noise, 1))
    net.train()
    optimizer.zero_grad(set_to_none=True)
    logits = _forward(net, views, atlas, generator, compute_dtype)
    return F.cross_entropy(logits.float(), labels)


def _step_update(net, optimizer, loss: torch.Tensor) -> None:
    """:func:`train_step` from the loss on: backward, the ranks' gradient
    mean, the optimizer's step and the BN EMA."""
    loss.backward()
    sync_bn.all_reduce_gradients(net.parameters())
    optimizer.step()
    update_bn_ema(net)


class TrainMultistep:
    """What :func:`make_train_multistep` returns: a callable that runs K
    train steps from (K, B, ...) stacked inputs, and a context manager
    that releases its CUDA graph on exit (:meth:`close`)."""

    def __init__(self, net: TriPlanarNet, optimizer: DeviceAdam, volume,
                 generator: Optional[torch.Generator], patch: int,
                 steps: int, augment: bool, intensity_augment: float,
                 compute_dtype: Optional[torch.dtype], eager: bool):
        self.net, self.optimizer, self.volume = net, optimizer, volume
        self.generator, self.patch, self.steps = generator, patch, steps
        self.options = (augment, intensity_augment, compute_dtype)
        device = volume.device
        # the step's inputs, loss slots and device step counter: made at
        # the first call, at its batch shape, and kept, because a captured
        # step reads and writes them where they lie
        self.inputs = self.losses = self.slot = None
        self.graphed = None
        if device.type == "cuda" and not eager:
            self.graphed = GraphedStep(
                self.step, device, [] if generator is None else [generator])

    def step(self) -> None:
        """One train step on row ``slot`` of the stacked inputs, its loss
        written to ``losses[slot]`` and ``slot`` advanced: no host input,
        nothing read back, so the card can capture it."""
        centers, labels, atlas = (t.index_select(0, self.slot)[0]
                                  for t in self.inputs)
        views = gather_triplanar_cuda(self.volume, centers, self.patch)
        loss = _step_loss(self.net, self.optimizer, views, labels, atlas,
                          self.generator, *self.options)
        _step_update(self.net, self.optimizer, loss)
        self.losses.index_copy_(0, self.slot, loss.detach().view(1))
        self.slot.add_(1)

    def __call__(self, centers: torch.Tensor, labels: torch.Tensor,
                 atlas: torch.Tensor) -> torch.Tensor:
        k = int(centers.shape[0])
        if not 0 < k <= self.steps or labels.shape[0] != k \
                or atlas.shape[0] != k:
            raise ValueError(f"between 1 and {self.steps} steps of stacked "
                             f"inputs, got {centers.shape[0]}, "
                             f"{labels.shape[0]}, {atlas.shape[0]}")
        given = (centers, labels, atlas)
        if self.inputs is None:
            self.inputs = tuple(torch.empty((self.steps,) + t.shape[1:],
                                            dtype=t.dtype, device=t.device)
                                for t in given)
            self.losses = torch.zeros(self.steps, dtype=torch.float32,
                                      device=centers.device)
            self.slot = torch.zeros(1, dtype=torch.int64,
                                    device=centers.device)
        for buf, t in zip(self.inputs, given):
            if t.shape[1:] != buf.shape[1:] or t.dtype != buf.dtype:
                raise ValueError(f"steps of {tuple(buf.shape[1:])} "
                                 f"{buf.dtype} as at the first call, got "
                                 f"{tuple(t.shape[1:])} {t.dtype}")
            buf[:k].copy_(t)
        self.slot.zero_()
        # autograd's NaN check of anomaly mode reads every backward output
        # back, which a capture refuses: the fit checks the losses instead
        with exact_float32(), torch.autograd.set_detect_anomaly(
                torch.is_anomaly_enabled(), check_nan=False):
            if self.graphed is None:
                for _ in range(k):
                    self.step()
            else:
                self.graphed.run(k)
        return self.losses[:k].clone()

    def close(self) -> None:
        """Release the captured step's graph and its memory pool."""
        if self.graphed is not None:
            self.graphed.close()

    def __enter__(self) -> "TrainMultistep":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_train_multistep(net: TriPlanarNet, optimizer: DeviceAdam, volume,
                         generator: Optional[torch.Generator], patch: int,
                         steps: int, *, augment: bool = False,
                         intensity_augment: float = 0.0,
                         compute_dtype: Optional[torch.dtype] = None,
                         _eager: bool = False) -> TrainMultistep:
    """K optimizer steps per call, the counterpart of the JAX package's
    ``make_train_multistep`` (train.py:234-264, a jitted ``lax.scan``).

    Binds ``net``, its ``optimizer``, the fit's gather ``volume`` (a
    :class:`~subcort_tpu_torch.ops.gather_kernel.GatherVolume` on the card),
    the step ``generator``, the ``patch`` size and :func:`train_step`'s
    options. The callable takes (K, B, 4) int32 centers, (K, B) int64
    labels and (K, B, 15) float32 atlas rows on the volume's device, K from
    1 to ``steps`` and B the same in every call, and runs K steps, each
    :func:`train_step` on its batch gathered from ``volume``; it returns
    the K losses as a (K,) device tensor, reading nothing back.

    On the CPU, and on the card with the private ``_eager`` (the tests and
    the smoke compare the two; ``Trainer.fit`` passes it in a
    data-parallel rank whose gloo collectives a graph cannot capture), a
    plain loop of the step. On the card otherwise, a
    :class:`~subcort_tpu_torch.utils.graphs.GraphedStep`: two eager steps,
    then one step (gather, augmentation, forward, loss, backward, Adam, BN
    EMA; in an NCCL rank also the synced BN's and the gradients'
    all-reduces) captured in a CUDA graph with ``generator`` registered,
    replayed for every later step of every call, so exactly K steps run
    per call. Each step reads its inputs and writes its loss
    through a device step counter. The graph bakes in the addresses of
    the parameters, the gradients, Adam's state and ``volume``'s storage,
    so it lives as long as the multistep object: :meth:`TrainMultistep.
    close` (or leaving its ``with`` block) releases it. A failed capture
    or replay raises; nothing falls back to the loop.

    ``optimizer`` must take no host input in its step (a
    :class:`DeviceAdam`). Autograd's anomaly NaN check is off inside a
    call; the caller checks the returned losses."""
    return TrainMultistep(net, optimizer, volume, generator, patch, steps,
                          augment, intensity_augment, compute_dtype, _eager)


@torch.no_grad()
def eval_step(net: TriPlanarNet, views: Patches, labels: torch.Tensor,
              atlas: torch.Tensor):
    """(cross-entropy sum, correct count) over the batch with BN in
    inference mode (train.py:267-285), as 0-dim device tensors."""
    with exact_float32():
        net.eval()
        logits = net(*views, atlas, return_logits=True)
        loss_sum = F.cross_entropy(logits, labels, reduction="sum")
        correct = (logits.argmax(1) == labels).sum()
    return loss_sum, correct


# ----------------------------------------------------------------- split
def train_split_stratified(labels: np.ndarray, eval_size: float):
    """nolearn TrainSplit semantics (first fold of an unshuffled stratified
    k-fold, k = round(1/eval_size)): per class, the first ~1/k occurrences
    go to validation. Data has already been shuffled once up front
    (base.py:92-103), so this is effectively a random stratified split."""
    if eval_size <= 0:
        return np.arange(len(labels)), np.arange(0)
    k = max(2, int(round(1.0 / eval_size)))
    valid = np.zeros(len(labels), bool)
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        n_valid = int(np.ceil(idx.size / k))
        valid[idx[:n_valid]] = True
    return np.flatnonzero(~valid), np.flatnonzero(valid)


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree


def _to_torch(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return tree


# ----------------------------------------------------------------- trainer
class Trainer:
    """``NeuralNet.fit`` replacement with the reference's epoch protocol.

    Artifacts per experiment (reference: nets/<name>/, nets.py:140-156):
      <weights_path>/<name>/<name>.pkl           best-only weights
                                                 (Theano-compatible pickle)
      <weights_path>/<name>/<name>_history.jsonl per-epoch history
      <weights_path>/<name>/<name>_history.pkl   the same, protocol 2
      <weights_path>/<name>/<name>_state.pkl     resume state: numpy state
                                                 dict, Adam state, epoch,
                                                 best loss and epoch, and
                                                 the generators' states

    The device comes from ``options.mode``. ``params`` is a state dict;
    without one, ``init_params`` draws it from a generator seeded with
    ``options.seed``. ``steps_per_call`` is how many steps run between two
    reads of their losses back to the host.

    Data parallelism (train.py:486-566): ``n_devices`` (default
    ``options.data_parallel``) above 1 trains on the first that many
    devices of ``mode``'s kind (:func:`~subcort_tpu_torch.parallel.mesh.
    make_devices`, which raises :class:`ValueError` when fewer exist), or
    ``devices`` names them (an entry may repeat). :meth:`fit` then starts
    one process per device (:func:`~subcort_tpu_torch.parallel.
    distributed.launch`): every step is the one-process step on the global
    batch of ``batch_size x devices`` rows, each rank gathering its
    ``batch_size`` with the kernel; validation is split over the ranks and
    its sums reduced; only rank 0 writes files; afterwards this trainer
    holds rank 0's final state. Inside a multi-process group made by
    someone else (a multi-host launch) more than one device raises.
    """

    def __init__(self, options: Options, spec: TriPlanarSpec = DEFAULT_SPEC,
                 weights_path: str = "nets", params: Optional[Params] = None,
                 augment: bool = False, shuffle_each_epoch: bool = False,
                 n_devices: Optional[int] = None,
                 lr_schedule: Optional[tuple] = None,
                 steps_per_call: int = 32,
                 intensity_augment: Optional[float] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        if devices is not None:
            self.devices = [torch.device(d) for d in devices]
        else:
            ndev = int(n_devices if n_devices is not None
                       else options["data_parallel"])
            self.devices = (make_devices(ndev, options.mode) if ndev > 1
                            else [select_device(options)])
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"devices of one kind, got {self.devices}")
        if len(self.devices) > 1 and torch.distributed.is_initialized():
            raise ValueError(
                f"training on {len(self.devices)} devices inside an existing "
                "process group (a multi-host launch) is not supported")
        self.options = options
        self.spec = spec
        self.weights_path = weights_path
        self.device = self.devices[0]
        self.augment = augment
        self.intensity_augment = float(
            options.get("intensity_augment", 0.0)
            if intensity_augment is None else intensity_augment)
        self.shuffle_each_epoch = shuffle_each_epoch
        # what a rank needs, besides the state, to rebuild this trainer
        self._config = dict(augment=augment,
                            shuffle_each_epoch=shuffle_each_epoch,
                            lr_schedule=lr_schedule,
                            steps_per_call=steps_per_call,
                            intensity_augment=self.intensity_augment)
        name = options["experiment"]
        self.exp_dir = os.path.join(weights_path, name)
        os.makedirs(self.exp_dir, exist_ok=True)
        self.weights_file = os.path.join(self.exp_dir, f"{name}.pkl")
        self.history_file = os.path.join(self.exp_dir, f"{name}_history.jsonl")
        self.state_file = os.path.join(self.exp_dir, f"{name}_state.pkl")

        # lr: fixed 1e-3 like the reference (nets.py:237). lr_schedule=(start,
        # stop) is the linear decay of the reference's unused AdjustVariable
        # hook (nets.py:25-39) over max_epochs, optax.linear_schedule's law
        self._lr_per_epoch = None
        if lr_schedule is not None:
            start, stop = lr_schedule
            steps = max(1, options["max_epochs"])
            self._lr_per_epoch = [(start - stop) * (1 - min(e, steps) / steps)
                                  + stop for e in range(steps + 1)]
        init_gen = torch.Generator().manual_seed(int(options["seed"]))
        if params is None:
            params = init_params(spec, init_gen)
        self.net = TriPlanarNet.from_params(params, spec, self.device,
                                            trainable=True)
        self.optimizer = self._make_optimizer()
        # the step generator's seed comes from the init stream, so weights
        # and dropout masks never share a stream (jax.random.split's role)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=init_gen)))
        self.shuffle_rng = np.random.default_rng(options["seed"] + 1)
        self.epoch = 0
        self.best_valid_loss = float("inf")
        self.best_epoch = 0
        self.history = []
        self.steps_per_call = max(1, steps_per_call)
        td = str(options["train_dtype"]).strip()
        self.train_dtype = (torch.bfloat16 if td in ("bfloat16", "bf16")
                            else None)
        # after a fit over several devices: each rank's gather launches,
        # and what ran its steps (train_rank's "step")
        self.rank_launches = self.rank_steps = None
        # after a one-process fit on the card: its captured train step
        # (warm-up and replay counts, capture ms); None when it ran eagerly
        self.step_graph = None

        if options.bool("load_weights"):
            self._try_resume()

    def _make_optimizer(self) -> DeviceAdam:
        return DeviceAdam(self.net.parameters(), **ADAM)

    @property
    def params(self) -> Params:
        """The net's state dict, on the CPU."""
        return {k: v.detach().cpu().clone()
                for k, v in self.net.state_dict().items()}

    # -------------------------------------------------------------- persistence
    def state(self) -> dict:
        """What the state file holds: numpy state dict, Adam state, epoch,
        best loss and epoch, and both generators' states."""
        return {
            "params": _to_numpy(self.net.state_dict()),
            "optimizer": _to_numpy(self.optimizer.state_dict()),
            "epoch": self.epoch,
            "best_valid_loss": self.best_valid_loss,
            "best_epoch": self.best_epoch,
            "generator": self.generator.get_state().numpy(),
            "shuffle_rng": self.shuffle_rng.bit_generator.state,
        }

    def _load_state(self, st: dict) -> None:
        self.net.load_state_dict(_to_torch(st["params"]))
        self.optimizer.load_state_dict(_to_torch(st["optimizer"]))
        self.epoch = st["epoch"]
        self.best_valid_loss = st["best_valid_loss"]
        self.best_epoch = st["best_epoch"]
        self.generator.set_state(torch.from_numpy(st["generator"]))
        self.shuffle_rng.bit_generator.state = st["shuffle_rng"]

    def _try_resume(self):
        """Warm start (nets.py:248-253 semantics: silent pass on missing)."""
        if os.path.exists(self.state_file):
            with open(self.state_file, "rb") as fh:
                self._load_state(pickle.load(fh))
            if os.path.exists(self.history_file):
                with open(self.history_file) as fh:
                    self.history = [json.loads(l) for l in fh if l.strip()]
            if self.options["net_verbose"]:
                print(f"    --> resumed at epoch {self.epoch} from {self.state_file}")
        elif os.path.exists(self.weights_file):
            try:
                self.net.load_state_dict(
                    load_theano_checkpoint(self.weights_file))
            except (OSError, EOFError, pickle.UnpicklingError, KeyError,
                    ValueError, RuntimeError):
                return  # reference behavior: a failed warm start is skipped
            self.optimizer = self._make_optimizer()
            if self.options["net_verbose"]:
                print("    --> loading weights from", self.weights_file)

    def _save_state(self):
        tmp = self.state_file + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(self.state(), fh)
        os.replace(tmp, self.state_file)

    @classmethod
    def from_handoff(cls, hand: dict, device: torch.device) -> "Trainer":
        """A rank's trainer on ``device``: the handed-off options, state and
        history of the trainer that started the ranks
        (:func:`~subcort_tpu_torch.parallel.distributed.write_handoff`)."""
        options = dataclasses.replace(hand["options"], load_weights=False)
        trainer = cls(options, hand["spec"], hand["weights_path"],
                      params=_to_torch(hand["state"]["params"]),
                      devices=[device], **hand["config"])
        trainer._load_state(hand["state"])
        trainer.history = list(hand["history"])
        return trainer

    # -------------------------------------------------------------- epoch loop
    def fit(self, index: TrainingIndex, max_epochs: Optional[int] = None,
            _eager: bool = False):
        """Train until max_epochs or early stopping; returns history list.

        Every train step goes through one :func:`make_train_multistep` made
        for the fit, ``steps_per_call`` steps a call: on the card, in one
        process or in a data-parallel rank whose group runs NCCL
        (:func:`~subcort_tpu_torch.parallel.distributed.step_capturable`),
        two eager steps and then the replays of one captured step, the
        rank's collectives inside it, released when the fit ends
        (:attr:`step_graph` then says what ran); on the CPU, and in a rank
        whose gloo collectives a CUDA graph cannot capture, a plain loop,
        as on the card with the private ``_eager`` (for comparisons; over
        several devices every rank takes it). Every rank captures at the
        same step, so its collectives meet their peers'. The losses are
        read back once a call, after their mean over the ranks. With
        ``utils.runtime.enable_nan_checks`` on, a NaN among them raises
        ``FloatingPointError`` naming the first step that had one, after
        the call: up to ``steps_per_call - 1`` steps later than a check
        before each step's backward would."""
        opts = self.options
        max_epochs = max_epochs if max_epochs is not None else opts["max_epochs"]
        if len(self.devices) > 1:
            return self._fit_ranks(index, max_epochs, _eager)
        patience = opts["patience"]
        batch_size = opts["batch_size"]
        dp = sync_bn.active()
        rank, world = (dp.rank, dp.world) if dp is not None else (0, 1)
        writes = rank == 0
        verbose = opts["net_verbose"] and writes
        dev = self.device

        train_idx, valid_idx = train_split_stratified(
            index.labels, opts["train_split"])
        # every rank starts from rank 0's parameters
        sync_bn.broadcast_module(self.net)

        # the index rows and the stack go to the device once per fit, the
        # stack in the gather kernel's layouts
        volume = prepare_gather_volume(torch.from_numpy(
            np.ascontiguousarray(index.volumes, np.float32)).to(dev))
        patch = self.spec.patch_size
        centers = torch.from_numpy(
            np.ascontiguousarray(index.centers, np.int32)).to(dev)
        labels = torch.from_numpy(index.labels.astype(np.int64)).to(dev)
        atlas = torch.from_numpy(
            np.ascontiguousarray(index.atlas, np.float32)).to(dev)
        # validation: each rank takes its contiguous share
        valid = torch.from_numpy(
            valid_idx[shard_rows(len(valid_idx), world)[rank]]).to(dev)
        v_centers, v_labels, v_atlas = centers[valid], labels[valid], atlas[valid]
        # validation is forward-only: large batches
        eval_bs = max(batch_size, 2048)
        # a global step takes batch_size rows from each rank
        step_rows = batch_size * world
        mine = slice(rank * batch_size, (rank + 1) * batch_size)

        multistep = make_train_multistep(
            self.net, self.optimizer, volume, self.generator, patch,
            self.steps_per_call, augment=self.augment,
            intensity_augment=self.intensity_augment,
            compute_dtype=self.train_dtype,
            _eager=_eager or (dp is not None
                              and not distributed.step_capturable(dev)))
        with multistep:
            while self.epoch < max_epochs:
                self.epoch += 1
                with span("train.epoch", f"epoch{self.epoch}"):
                    t0 = time.time()
                    if self._lr_per_epoch is not None:
                        self.optimizer.set_lr(self._lr_per_epoch[min(
                            self.epoch - 1, len(self._lr_per_epoch) - 1)])
                    order = train_idx
                    if self.shuffle_each_epoch:
                        order = self.shuffle_rng.permutation(train_idx)

                    # ---- train epoch: full global batches, the remainder
                    # dropped; steps_per_call steps a call, their losses
                    # read back after it
                    n_steps = len(order) // step_rows
                    with span("train.rows", rows=n_steps * batch_size):
                        rows = torch.from_numpy(
                            order[:n_steps * step_rows].reshape(
                                -1, step_rows)[:, mine].reshape(-1)).to(dev)
                        e_centers, e_labels, e_atlas = (
                            centers[rows], labels[rows], atlas[rows])
                    losses = []
                    for i in range(0, n_steps, self.steps_per_call):
                        k = min(self.steps_per_call, n_steps - i)
                        sl = slice(i * batch_size, (i + k) * batch_size)
                        # the global batch's loss of each step: the mean
                        # over the ranks
                        with span("train.call", steps=k):
                            got = sync_bn.all_reduce_mean(multistep(
                                e_centers[sl].view(k, batch_size, -1),
                                e_labels[sl].view(k, batch_size),
                                e_atlas[sl].view(k, batch_size, -1)))
                        with span("train.loss_readback"):
                            got = got.tolist()
                        nan = next((j for j, v in enumerate(got)
                                    if math.isnan(v)), None)
                        if nan is not None:
                            check_nans(f"the train loss of epoch "
                                       f"{self.epoch}, step {i + nan + 1}",
                                       got[nan])
                        losses.extend(got)
                    train_loss = (
                        float(np.mean(np.asarray(losses, np.float32)))
                        if losses else float("nan"))

                    with span("train.validation", rows=len(v_labels)):
                        vloss, vcorrect = self._validate(
                            volume, patch, v_centers, v_labels, v_atlas,
                            eval_bs, dp)
                    vcount = len(valid_idx)
                    valid_loss = vloss / max(vcount, 1)
                    valid_acc = vcorrect / max(vcount, 1)
                    dur = time.time() - t0

                    improved = valid_loss < self.best_valid_loss
                    if improved:
                        self.best_valid_loss = valid_loss
                        self.best_epoch = self.epoch
                    rec = {
                        "epoch": self.epoch,
                        "train_loss": train_loss,
                        "valid_loss": valid_loss,
                        "valid_accuracy": valid_acc,
                        "train_loss_best": bool(train_loss <= min(
                            [h["train_loss"] for h in self.history]
                            + [train_loss])),
                        "valid_loss_best": bool(improved),
                        "valid_accuracy_best": bool(valid_acc >= max(
                            [h["valid_accuracy"] for h in self.history]
                            + [valid_acc])),
                        "dur": dur,
                    }
                    self.history.append(rec)
                    if writes:
                        self._checkpoint(rec, improved)

                    if verbose:
                        print(f"  epoch {self.epoch:4d}  train_loss "
                              f"{train_loss:.5f}  valid_loss "
                              f"{valid_loss:.5f}  valid_acc {valid_acc:.5f}"
                              f"  {'*' if improved else ' '}  {dur:.1f}s")

                    # EarlyStopping(patience): stop when no improvement for
                    # `patience` (every rank reads the same reduced
                    # valid_loss, so all stop at the same epoch)
                    if self.epoch >= self.best_epoch + patience:
                        if verbose:
                            print(f"  early stopping: best epoch "
                                  f"{self.best_epoch} (valid_loss "
                                  f"{self.best_valid_loss:.5f})")
                        break

        self.step_graph = multistep.graphed
        return self.history

    def _validate(self, volume, patch: int, centers, labels, atlas,
                  eval_bs: int, dp) -> tuple:
        """(cross-entropy sum, correct count) over the validation rows, in
        batches of ``eval_bs`` gathered from ``volume``, summed over the
        ranks."""
        sums, corrects = [], []
        for i in range(0, len(labels), eval_bs):
            sl = slice(i, i + eval_bs)
            views = gather_triplanar_cuda(volume, centers[sl], patch)
            s, c = eval_step(self.net, views, labels[sl], atlas[sl])
            sums.append(s)
            corrects.append(c)
        vloss = sum(torch.stack(sums).tolist()) if sums else 0.0
        vcorrect = int(torch.stack(corrects).sum()) if corrects else 0
        if dp is not None:
            total = sync_bn.all_reduce_sum(torch.tensor(
                [vloss, vcorrect], dtype=torch.float64, device=self.device))
            vloss, vcorrect = float(total[0]), int(total[1])
        check_nans("the validation loss", vloss)
        return vloss, vcorrect

    def _checkpoint(self, rec: dict, improved: bool) -> None:
        """An epoch's writes, as one ``train.checkpoint`` span with the
        bytes written: the weights pickle when validation improved
        (SaveWeights(only_best=True), the reference's format), the history
        JSONL and its reference-format pickle mirror (nolearn
        SaveTrainingHistory, nets.py:156), and the state file."""
        pkl = self.history_file.replace("_history.jsonl", "_history.pkl")
        with span("train.checkpoint") as ck:
            if improved:
                save_theano_checkpoint(self.net.state_dict(),
                                       self.weights_file)
            line = json.dumps(rec) + "\n"
            with open(self.history_file, "a") as fh:
                fh.write(line)
            with open(pkl, "wb") as fh:
                pickle.dump(self.history, fh, protocol=2)
            self._save_state()
            if ck:
                ck.set(bytes=len(line.encode()) + sum(
                    os.path.getsize(f) for f in
                    [pkl, self.state_file]
                    + [self.weights_file] * improved))

    def hand_off(self, workdir: Path, index: TrainingIndex, max_epochs: int,
                 _eager: bool = False) -> None:
        """Write into ``workdir`` what each rank of a fit of this trainer
        reads (:func:`~subcort_tpu_torch.parallel.distributed.train_rank`):
        the index as ``.npy`` files the ranks memory-map, this trainer's
        options, state and history, and whether the ranks run the plain
        loop."""
        distributed.write_handoff(Path(workdir), index, {
            "options": self.options, "spec": self.spec,
            "weights_path": self.weights_path, "config": self._config,
            "state": self.state(), "history": self.history,
            "max_epochs": max_epochs, "eager": _eager})

    def _fit_ranks(self, index: TrainingIndex, max_epochs: int,
                   _eager: bool) -> list:
        """:meth:`fit` over ``self.devices``, one spawned rank each: hand
        the index and this trainer's state to the ranks, join them, then
        take rank 0's final state and history, and every rank's launches
        and what ran its steps (:attr:`rank_launches`,
        :attr:`rank_steps`). The join returns as soon as the last rank
        exits; it waits no longer than ``distributed.FIT_TIMEOUT_S``
        (None, the default: as long as the fit runs)."""
        verbose = self.options["net_verbose"]
        if verbose:
            print(f"--> data-parallel fit: {len(self.devices)} ranks on "
                  f"{[str(d) for d in self.devices]}, backend "
                  f"{distributed.backend_for(self.devices)}")
        with tempfile.TemporaryDirectory(prefix="subcort_ranks_") as work:
            self.hand_off(Path(work), index, max_epochs, _eager)
            distributed.launch(distributed.train_rank, self.devices, (work,),
                               timeout=distributed.FIT_TIMEOUT_S)
            results = []
            for rank in range(len(self.devices)):
                with open(Path(work) / f"rank{rank}.pkl", "rb") as fh:
                    results.append(pickle.load(fh))
        self._load_state(results[0]["state"])
        self.history = results[0]["history"]
        self.rank_launches = [r["launches"] for r in results]
        self.rank_steps = [r["step"] for r in results]
        if verbose:
            for rank, step in enumerate(self.rank_steps):
                print(f"    rank {rank}'s steps: {json.dumps(step)}")
        return self.history
