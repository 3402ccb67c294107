"""Epochs of ``Trainer.fit`` on an MNI-sized training set.

Traffic parameters (``traffic/<name>.json``):

- ``samples``, ``subjects``, ``shape``: the training set of
  ``frozen.make_index`` drawn from the seed (subjects padded by 16 and kept
  on the device by the trainer, uniform rows, labels and priors);
- ``batch``, ``steps_per_call``, ``train_split``: the trainer's batch (the
  reference's effective 128), steps per dispatch and holdout;
- ``epoch_seconds``: the nominal length of an epoch. The window holds
  ``max(1, round(seconds / epoch_seconds))`` whole epochs, a fixed amount of
  work for a given ``--seconds``.

Set-up builds one trainer on the benchmark's seeded weights, with its step
generator seeded by the benchmark, and drives it through its first steps in
two fits of the same call and feed as the window's, each of one epoch on
its own rows of the window's index, with validation and checkpoint
writes: one of one step, then one of two whole calls of ``steps_per_call``
steps, the first call two eager steps and the captured step's replays,
the second replays alone, as every call of the window after its first.
The window's fit then runs its first epoch (capture included) as set-up,
and the whole epochs that follow: ``train_samples_per_s`` is the trained
rows (not the holdout) of those epochs over their wall time, from the end
of the first epoch's validation to the end of the last's, so that steps,
validation and checkpoint writes are all in it.

The check follows those ``1 + 2 * steps_per_call`` steps with the plain
reference from the same weights, rows and dropout stream: each fit's train
loss (the second's the mean over its two calls), each fit's validation
loss (BN's running averages in eval mode), the first gradient (the
trainer's Adam state after one step, ``mu / (1 - b1)``) and the change of
every leaf after the two calls, each leaf by its norm against the
reference's norm of that leaf or of the median leaf, whichever is larger
(the gradient taken at the median leaf, the change at the worst); and
after the window the trainer's step count against the steps run.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import frozen, weights
from benchmark.drivers.scan_loop import spec_of
from benchmark.reference import triplanar as ref_net

B1 = ref_net.ADAM["b1"]


class StampedList(list):
    """The trainer's history list, stamping the host clock at each epoch's
    record (appended after the epoch's validation, before its writes)."""

    def __init__(self, items=(), on_append=None):
        super().__init__(items)
        self.stamps = []
        self.on_append = on_append

    def __reduce__(self):
        # the trainer pickles its history: write a plain list
        return (list, (list(self),))

    def append(self, item) -> None:
        super().append(item)
        self.stamps.append(time.perf_counter())
        if self.on_append is not None:
            self.on_append(len(self.stamps))


def head_rows(labels: np.ndarray, start: int, steps: int, batch: int,
              split: float) -> slice:
    """The rows ``start:start + n`` of the index whose train split holds
    exactly ``steps`` whole batches and a remainder under one batch."""
    n = int(np.ceil(steps * batch / (1 - split))) + 16
    while True:
        train, _ = frozen.train_split_stratified(labels[start:start + n],
                                                 split)
        if len(train) // batch == steps:
            return slice(start, start + n)
        n += batch // 4 if len(train) // batch < steps else -(batch // 4)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gap(prog: dict, ref: dict, keys, over=max) -> float:
    """Each leaf's |norm(prog) - norm(ref)| over the larger of norm(ref) and
    the median leaf's norm(ref); ``over`` the leaves: the worst (``max``)
    or the median leaf's (``np.median``)."""
    keys = list(keys)
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    median = float(np.median(list(rn.values())))
    return float(over([abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30)
                       for k in keys]))


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from subcort_tpu_torch.config import Options
        from subcort_tpu_torch.engine.data import TrainingIndex
        from subcort_tpu_torch.engine.train import Trainer

        run, cfg, tr = self.run, self.cfg, self.tr
        shape = tuple(tr.get("shape", frozen.MNI_SHAPE))
        batch, split = int(tr["batch"]), float(tr["train_split"])
        t0 = time.perf_counter()
        gen = torch.Generator(device=run.device).manual_seed(run.seed)
        vols, centers, labels, priors = frozen.make_index(
            gen, int(tr["samples"]), int(tr["subjects"]), shape)
        self.volumes = vols
        self.index = TrainingIndex(volumes=vols, centers=centers,
                                   labels=labels, atlas=priors,
                                   subject_names=[f"s{i}" for i in
                                                  range(len(vols))])
        self.head_steps = (1, 2 * int(tr["steps_per_call"]))
        self.heads, start = [], 0
        for k in self.head_steps:
            self.heads.append(head_rows(labels, start, k, batch, split))
            start = self.heads[-1].stop
        run.setup_parts["inputs"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.p0 = weights.make_weights(cfg, run.seed, run.device)
        self.dropout_seed = int(np.random.default_rng([run.seed, 3]).integers(
            2 ** 62))
        mode = ("cpu" if run.device.type == "cpu"
                else f"cuda{run.device.index or 0}")
        self.n_measured = max(1, round(run.seconds
                                       / float(tr["epoch_seconds"])))
        opts = Options(experiment="bench", mode=mode, batch_size=batch,
                       train_split=split, max_epochs=10 ** 6,
                       patience=10 ** 6, net_verbose=0, load_weights=False,
                       debug=False, train_dtype=cfg["train_dtype"],
                       seed=run.seed % 2 ** 31)
        self.trainer = Trainer(opts, spec_of(cfg),
                               weights_path=str(run.workdir / "nets"),
                               params={k: v.clone() for k, v in
                                       self.p0.items()},
                               steps_per_call=int(tr["steps_per_call"]))
        self.trainer.generator.manual_seed(self.dropout_seed)
        run.setup_parts["program"] = time.perf_counter() - t0

        # the first steps: two fits of the window's call and feed; the
        # first builds the gather kernel where the card needs it
        t0 = time.perf_counter()
        tn = self.trainer
        self.head_out = []
        for rows in self.heads:
            index = TrainingIndex(volumes=vols, centers=centers[rows],
                                  labels=labels[rows], atlas=priors[rows],
                                  subject_names=self.index.subject_names)
            rec = tn.fit(index, max_epochs=tn.epoch + 1)[-1]
            state = {k: v.detach().cpu().clone()
                     for k, v in tn.net.state_dict().items()}
            self.head_out.append((rec["train_loss"], rec["valid_loss"],
                                  state))
            if len(self.head_out) == 1:
                names = {id(p): k for k, p in tn.net.named_parameters()}
                self.grad1 = {
                    names[id(p)]: (st["exp_avg"] / (1 - B1)).detach().cpu()
                    for p, st in tn.optimizer.state.items()}
        run.setup_parts["first_steps"] = time.perf_counter() - t0

    # ------------------------------------------------------------ window
    def window(self) -> None:
        run, tn = self.run, self.trainer
        # a traced run traces the second epoch of the fit: from the first
        # epoch's record to the second's
        traced = {1: run.trace.start, 2: run.trace.stop}
        run.trace.outside = "Trainer.fit"
        stamped = StampedList(tn.history,
                              lambda n: traced.get(n, lambda: None)())
        tn.history = stamped
        epochs0 = tn.epoch
        t_fit = time.perf_counter()
        tn.fit(self.index, max_epochs=tn.epoch + 1 + self.n_measured)
        stamps = stamped.stamps
        run.setup_parts["first_epoch"] = stamps[0] - t_fit
        run.window_t0 = stamps[0]
        window_s = stamps[-1] - stamps[0]
        batch = int(self.tr["batch"])
        train, valid = frozen.train_split_stratified(
            self.index.labels, float(self.tr["train_split"]))
        self.steps_per_epoch = len(train) // batch
        steps = self.steps_per_epoch * self.n_measured
        self.steps_run = (sum(self.head_steps)
                          + self.steps_per_epoch * (tn.epoch - epochs0))
        # the trainer's Adam step count (0 if no step reached Adam)
        states = list(tn.optimizer.state_dict()["state"].values())
        self.step_count = float(states[0]["step"]) if states else 0.0
        run.counts.update(attempted=steps, failed=0)
        # what the traced epoch did: its steps and validation rows, and the
        # centers of each gather launch
        run.counts["traced_steps"] = self.steps_per_epoch
        run.counts["traced_train_samples"] = self.steps_per_epoch * batch
        run.counts["traced_eval_samples"] = len(valid)
        if run.traced:
            order = train[:self.steps_per_epoch * batch].reshape(-1, batch)
            eval_bs = max(batch, 2048)
            launches = [self.index.centers[r] for r in order]
            launches += [self.index.centers[valid[a:a + eval_bs]]
                         for a in range(0, len(valid), eval_bs)]
            run.extra["gather_launches"] = launches
            run.extra["gather_padded_shape"] = self.volumes.shape
        run.end_to_end["train_samples_per_s"] = steps * batch / window_s

    def release(self) -> None:
        del self.trainer

    # ------------------------------------------------------------ check
    def reference(self, precision: str = "float32"):
        """The reference's steps of the two fits and their validation
        losses."""
        dev = self.run.device
        batch = int(self.tr["batch"])
        split = float(self.tr["train_split"])
        vols = torch.from_numpy(self.volumes).to(dev)
        batches, valids = [], []
        for rows, k in zip(self.heads, self.head_steps):
            centers, labels, priors = (a[rows] for a in (
                self.index.centers, self.index.labels, self.index.atlas))
            train, valid = frozen.train_split_stratified(labels, split)
            for s in range(k):
                r = train[s * batch:(s + 1) * batch]
                batches.append(tuple(torch.from_numpy(a[r]).to(dev)
                                     for a in (centers, labels, priors)))
            valids.append(tuple(torch.from_numpy(a[valid]).to(dev)
                                for a in (centers, labels, priors)))
        gen = torch.Generator(device=dev).manual_seed(self.dropout_seed)
        p0 = {k: v.to(dev) for k, v in self.p0.items()}
        losses, grad1, after = ref_net.train_steps(p0, self.cfg, vols,
                                                   batches, gen, precision)
        ends = np.cumsum(self.head_steps) - 1
        vloss = [ref_net.eval_loss(after[e], self.cfg, vols, *v)
                 for e, v in zip(ends, valids)]
        tloss = [float(np.mean(losses[a:e + 1]))
                 for a, e in zip(np.r_[0, ends[:-1] + 1], ends)]
        return tloss, vloss, grad1, after[ends[-1]]

    def numbers(self, prog, ref) -> dict:
        """The compared numbers of a side ``prog`` against the reference's
        ``ref``, each (the fits' train losses, their valid losses, the
        first gradient, the leaves after the second fit)."""
        p_t, p_v, p_g, p_end = prog
        r_t, r_v, r_g, r_end = ref
        p0 = {k: v.cpu().double() for k, v in self.p0.items()}
        gnorm = {k: float(torch.linalg.vector_norm(g.double()))
                 for k, g in r_g.items()}
        median = float(np.median(list(gnorm.values())))
        moved = [k for k in p0 if k not in gnorm
                 or gnorm[k] >= 1e-3 * median]
        self.left_out = len(p0) - len(moved)
        g_prog = {k: p_g.get(k, torch.zeros(())).cpu() for k in r_g}
        g_ref = {k: v.cpu() for k, v in r_g.items()}
        self.grad_worst = leaf_gap(g_prog, g_ref, r_g)
        d_prog = {k: p_end[k].cpu().double() - p0[k] for k in moved}
        d_ref = {k: r_end[k].cpu().double() - p0[k] for k in moved}
        self.change_median = leaf_gap(d_prog, d_ref, moved, over=np.median)
        return {
            "loss_step1": rel(p_t[0], r_t[0]),
            "loss_two_calls": rel(p_t[1], r_t[1]),
            "valid_loss": max(rel(a, b) for a, b in zip(p_v, r_v)),
            # by the median leaf: a near-tie moves one leaf's gradient
            # (see PERF.md); a leaf Adam never saw reads as a zero gradient
            "grad_step1": leaf_gap(g_prog, g_ref, r_g, over=np.median),
            "change_two_calls": leaf_gap(d_prog, d_ref, moved),
        }

    def program_side(self):
        return ([h[0] for h in self.head_out], [h[1] for h in self.head_out],
                self.grad1, self.head_out[-1][2])

    def check(self) -> dict:
        numbers = self.numbers(self.program_side(), self.reference())
        numbers["steps_missing"] = abs(self.steps_run - self.step_count)
        return numbers

    def readings(self) -> dict:
        """The check's numbers on the first steps, no window; beside them,
        uncompared, the first gradient at the worst leaf, the change at the
        median leaf and how many leaves the change comparison left out."""
        numbers = self.numbers(self.program_side(), self.reference())
        return dict(numbers, grad_step1_worst=self.grad_worst,
                    change_two_calls_median=self.change_median,
                    leaves_left_out=self.left_out)

    def control(self) -> dict:
        """The control's numbers: the reference computed in TF32 put in the
        program's place."""
        numbers = self.numbers(self.reference("tf32"), self.reference())
        return dict(numbers, grad_step1_worst=self.grad_worst,
                    change_two_calls_median=self.change_median)
