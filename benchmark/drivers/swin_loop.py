"""Closed-loop scans through SwinUNETR's sliding-window path.

Traffic parameters (``traffic/<name>.json``): ``scans`` distinct scans of
``frozen.make_scan`` (int16, 1 mm, ``shape``) drawn from the seed, taken in
turn. The configuration gives the net's widths and the windows (``roi``,
``overlap``, ``sw_batch_size``): the reference takes them from it, the
program has them as the constants of ``engine/swinunetr.py``, which
``benchmark/tests/test_bench_swinunetr.py`` holds equal to them.

The window runs one scan after another, each through ``segment_swinunetr``
(z-score, the 128^3 windows in batches, Gaussian blend, argmax, each
class's largest component on the card, one read-back), for ``--seconds``
and stops after the scan that crosses it: ``scan_s`` is the window over
the scans completed. The program's ``engine.swinunetr.WINDOWS`` before and
after the window gives the windows run in it.

The check, after the window, on its last completed scan of each input:
the program's blended logits ``L`` from its public ``blended_logits``, and
the plain reference's ``L_ref`` from the raw scan
(``reference/swinunetr.py``, one window at a time):

- ``logit_gap``: the largest ``max_k L_ref,k - L_ref,label`` over the
  volume, ``label`` the argmax of the program's ``L`` (its raw labels);
- ``logit_error``: the largest ``|L - L_ref|`` over the volume and the
  classes: the blend moves logits where most labels stay, so the gap
  alone would pass a fault in the weights of the blend;
- ``postprocess_mismatch``: voxels, over the scans, where the window's
  labels differ from the reference's post-process (scipy, each class's
  largest component) of the program's own raw labels;
- ``shape_mismatch``: 1 where the labels do not have the input's shape.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import frozen
from benchmark import weights_swinunetr as weights
from benchmark.reference import swinunetr as ref

ZOOMS = (1.0, 1.0, 1.0)


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from subcort_tpu_torch.engine import swinunetr
        from subcort_tpu_torch.models.swinunetr import SwinUNETR

        run, cfg, tr = self.run, self.cfg, self.tr
        self.swinunetr = swinunetr
        t0 = time.perf_counter()
        shape = tuple(tr.get("shape", frozen.MNI_SHAPE))
        self.scans = [frozen.make_scan(np.random.default_rng([run.seed, i]),
                                       shape)[0]
                      for i in range(int(tr["scans"]))]
        run.setup_parts["inputs"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.roi, self.overlap = int(cfg["roi"][0]), float(cfg["overlap"])
        self.params = weights.make_weights(cfg, run.seed, run.device)
        weights.center(self.params, self.scans[0], run.device, self.roi,
                       self.overlap)
        self.net = SwinUNETR.from_params(self.params, run.device)
        run.setup_parts["program"] = time.perf_counter() - t0

        # warm-up: every scan once, the first twice (cuDNN's algorithm
        # choice, the allocator's pools, the filter kernel's build)
        t0 = time.perf_counter()
        for image in [self.scans[0]] + self.scans:
            self._one(image)
        run.setup_parts["warmup"] = time.perf_counter() - t0
        self.flops_per_scan = run.cell.flops.scan_flops(cfg, shape)

    def _one(self, image):
        with self.run.spans("segment_swinunetr"):
            return self.swinunetr.segment_swinunetr(self.net, image, ZOOMS,
                                                    self.run.device)

    # ------------------------------------------------------------ window
    def window(self) -> None:
        run = self.run
        run.spans.seconds.clear()
        last, flops = {}, 0
        windows0 = self.swinunetr.WINDOWS
        run.trace.start()
        t0 = time.perf_counter()
        i = 0
        while True:
            k = i % len(self.scans)
            with run.spans("scan"):
                labels = self._one(self.scans[k])
            tb = time.perf_counter()
            flops += self.flops_per_scan
            last[k] = (k, labels)
            i += 1
            if tb - t0 >= run.seconds:
                break
        run.trace.stop()
        self.last = [last[k] for k in sorted(last)]
        run.counts.update(attempted=i, failed=0, flops=flops,
                          windows=self.swinunetr.WINDOWS - windows0)
        run.end_to_end["scan_s"] = (tb - t0) / i

    def release(self) -> None:
        # the net stays: the check reads the program's logits
        pass

    # ------------------------------------------------------------ check
    def reference_logits(self, k: int, precision: str = "float32"):
        return ref.blended_logits(self.params, self.scans[k], self.run.device,
                                  self.roi, self.overlap, precision)

    def program_logits(self, k: int):
        return self.swinunetr.blended_logits(self.net, self.scans[k], ZOOMS,
                                             self.run.device)

    def check(self) -> dict:
        return judge_scans(self, self.last)

    def readings(self) -> dict:
        """The check's numbers on one pass over every scan, no window (for
        the readings a limit is set from)."""
        return judge_scans(self, [(k, self._one(s))
                                  for k, s in enumerate(self.scans)])

    def control(self) -> dict:
        """The control's numbers: the reference's logits computed in TF32,
        put in the program's place."""
        gap, error = 0.0, 0.0
        for k in range(len(self.scans)):
            want = self.reference_logits(k)
            low = self.reference_logits(k, "tf32")
            gap = max(gap, ref.logit_gap(want, low.argmax(0)))
            error = max(error, ref.logit_error(want, low))
            del low, want
        return {"logit_gap": gap, "logit_error": error}


def judge_scans(drv, done) -> dict:
    """The numbers the check compares over ``done`` ((scan index, labels)
    pairs)."""
    gap, error, mismatch, shape_bad = 0.0, 0.0, 0, 0
    for k, labels in done:
        image = drv.scans[k]
        if labels.shape != image.shape:
            shape_bad = 1
            continue
        logits = drv.program_logits(k)
        want = drv.reference_logits(k)
        if tuple(logits.shape) != tuple(want.shape):
            shape_bad = 1
            continue
        gap = max(gap, ref.logit_gap(want, logits.argmax(0)))
        error = max(error, ref.logit_error(want, logits))
        del want
        post = ref.labels(logits)
        del logits
        mismatch += int(np.count_nonzero(post != labels))
    return {"logit_gap": float(gap), "logit_error": float(error),
            "postprocess_mismatch": float(mismatch),
            "shape_mismatch": float(shape_bad)}
