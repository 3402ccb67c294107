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

History is JSONL plus the reference's ``<name>_history.pkl`` (epoch,
train_loss, valid_loss, valid_accuracy, *_best flags, dur).
"""

from __future__ import annotations

import dataclasses
import json
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
from subcort_tpu_torch.utils.runtime import check_nans

ADAM = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


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
        loss = F.cross_entropy(logits.float(), labels)
        check_nans("the train loss", loss)
        loss.backward()
        sync_bn.all_reduce_gradients(net.parameters())
        optimizer.step()
        update_bn_ema(net)
    return loss.detach()


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
        # after a fit over several devices: each rank's gather launches
        self.rank_launches = None

        if options.bool("load_weights"):
            self._try_resume()

    def _make_optimizer(self) -> torch.optim.Optimizer:
        return torch.optim.Adam(self.net.parameters(), **ADAM)

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
    def fit(self, index: TrainingIndex, max_epochs: Optional[int] = None):
        """Train until max_epochs or early stopping; returns history list."""
        opts = self.options
        max_epochs = max_epochs if max_epochs is not None else opts["max_epochs"]
        if len(self.devices) > 1:
            return self._fit_ranks(index, max_epochs)
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

        while self.epoch < max_epochs:
            self.epoch += 1
            t0 = time.time()
            if self._lr_per_epoch is not None:
                lr = self._lr_per_epoch[min(self.epoch - 1,
                                            len(self._lr_per_epoch) - 1)]
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
            order = train_idx
            if self.shuffle_each_epoch:
                order = self.shuffle_rng.permutation(train_idx)

            # ---- train epoch: full global batches, the remainder dropped;
            # losses read back once per steps_per_call steps
            n_full = (len(order) // step_rows) * step_rows
            rows = torch.from_numpy(order[:n_full].reshape(
                -1, step_rows)[:, mine].reshape(-1)).to(dev)
            e_centers, e_labels, e_atlas = centers[rows], labels[rows], atlas[rows]
            losses, pending = [], []

            def flush():
                # the global batch's loss of each step: the mean over ranks
                losses.extend(sync_bn.all_reduce_mean(
                    torch.stack(pending)).tolist())
                pending.clear()

            for i in range(0, len(rows), batch_size):
                sl = slice(i, i + batch_size)
                views = gather_triplanar_cuda(volume, e_centers[sl], patch)
                pending.append(train_step(
                    self.net, self.optimizer, views, e_labels[sl],
                    e_atlas[sl], self.generator, augment=self.augment,
                    intensity_augment=self.intensity_augment,
                    compute_dtype=self.train_dtype))
                if len(pending) == self.steps_per_call:
                    flush()
            if pending:
                flush()
            train_loss = (float(np.mean(np.asarray(losses, np.float32)))
                          if losses else float("nan"))

            # ---- validation
            sums, corrects = [], []
            for i in range(0, len(v_labels), eval_bs):
                sl = slice(i, i + eval_bs)
                views = gather_triplanar_cuda(volume, v_centers[sl], patch)
                s, c = eval_step(self.net, views, v_labels[sl], v_atlas[sl])
                sums.append(s)
                corrects.append(c)
            vloss = sum(torch.stack(sums).tolist()) if sums else 0.0
            vcorrect = int(torch.stack(corrects).sum()) if corrects else 0
            if dp is not None:
                total = sync_bn.all_reduce_sum(torch.tensor(
                    [vloss, vcorrect], dtype=torch.float64, device=dev))
                vloss, vcorrect = float(total[0]), int(total[1])
            check_nans("the validation loss", vloss)
            vcount = len(valid_idx)
            valid_loss = vloss / max(vcount, 1)
            valid_acc = vcorrect / max(vcount, 1)
            dur = time.time() - t0

            improved = valid_loss < self.best_valid_loss
            if improved:
                self.best_valid_loss = valid_loss
                self.best_epoch = self.epoch
                if writes:
                    # SaveWeights(only_best=True): reference-format pickle
                    save_theano_checkpoint(self.net.state_dict(),
                                           self.weights_file)

            rec = {
                "epoch": self.epoch,
                "train_loss": train_loss,
                "valid_loss": valid_loss,
                "valid_accuracy": valid_acc,
                "train_loss_best": bool(train_loss <= min(
                    [h["train_loss"] for h in self.history] + [train_loss])),
                "valid_loss_best": bool(improved),
                "valid_accuracy_best": bool(valid_acc >= max(
                    [h["valid_accuracy"] for h in self.history] + [valid_acc])),
                "dur": dur,
            }
            self.history.append(rec)
            if writes:
                with open(self.history_file, "a") as fh:
                    fh.write(json.dumps(rec) + "\n")
                # reference-format mirror: nolearn SaveTrainingHistory wrote
                # a pickle of the per-epoch dict list (nets.py:156)
                with open(self.history_file.replace("_history.jsonl",
                                                    "_history.pkl"), "wb") as fh:
                    pickle.dump(self.history, fh, protocol=2)
                self._save_state()

            if verbose:
                print(f"  epoch {self.epoch:4d}  train_loss {train_loss:.5f}  "
                      f"valid_loss {valid_loss:.5f}  valid_acc {valid_acc:.5f}  "
                      f"{'*' if improved else ' '}  {dur:.1f}s")

            # EarlyStopping(patience): stop when no improvement for `patience`
            # (every rank reads the same reduced valid_loss, so all stop at
            # the same epoch)
            if self.epoch >= self.best_epoch + patience:
                if verbose:
                    print(f"  early stopping: best epoch {self.best_epoch} "
                          f"(valid_loss {self.best_valid_loss:.5f})")
                break

        return self.history

    def _fit_ranks(self, index: TrainingIndex, max_epochs: int) -> list:
        """:meth:`fit` over ``self.devices``, one spawned rank each: hand
        the index (``.npy`` files the ranks memory-map) and this trainer's
        state to the ranks, join them, then take rank 0's final state and
        history. The join returns as soon as the last rank exits; it waits
        no longer than ``distributed.FIT_TIMEOUT_S`` (None, the default:
        as long as the fit runs)."""
        if self.options["net_verbose"]:
            print(f"--> data-parallel fit: {len(self.devices)} ranks on "
                  f"{[str(d) for d in self.devices]}, backend "
                  f"{distributed.backend_for(self.devices)}")
        with tempfile.TemporaryDirectory(prefix="subcort_ranks_") as work:
            distributed.write_handoff(Path(work), index, {
                "options": self.options, "spec": self.spec,
                "weights_path": self.weights_path, "config": self._config,
                "state": self.state(), "history": self.history,
                "max_epochs": max_epochs})
            distributed.launch(distributed.train_rank, self.devices, (work,),
                               timeout=distributed.FIT_TIMEOUT_S)
            results = []
            for rank in range(len(self.devices)):
                with open(Path(work) / f"rank{rank}.pkl", "rb") as fh:
                    results.append(pickle.load(fh))
        self._load_state(results[0]["state"])
        self.history = results[0]["history"]
        self.rank_launches = [r["launches"] for r in results]
        return self.history
