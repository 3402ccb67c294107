"""Closed-loop scans through SynthSeg's whole-volume path.

Traffic parameters (``traffic/<name>.json``): ``scans`` distinct scans of
``frozen.make_scan`` (int16, 1 mm, ``shape``) drawn from the seed, taken in
turn. The configuration gives the net's widths and the tables ``labels``,
``lr_pairs``, ``topology_classes`` (the reference's; the program takes each
non-background channel as its own class) and ``structure_of``.

The window runs one scan after another, each through ``segment_synthseg``
(normalisation and padding, two whole-volume forwards, the flip average,
the topology post-process, the labels, one read-back), for ``--seconds``
and stops after the scan that crosses it: ``scan_s`` is the window over
the scans completed. The program's ``engine.synthseg.FORWARDS`` before and
after the window gives the forwards run in it.

The check, after the window, on its last completed scan of each input:
the program's flip-averaged ``P`` from its public
``flip_averaged_posteriors``, and the plain reference's from the raw scan
(``reference/synthseg.py``):

- ``posterior_gap``: over the padded volume, the largest ``max_k P_ref,k -
  P_ref,L``, ``L`` the argmax of the program's ``P``. The net has no
  max-unpool, so it is continuous and the largest gap is tight;
- ``posterior_error``: over the padded volume and the classes, the largest
  ``|P - P_ref|``. The post-process thresholds the values of ``P``, so a
  fault that leaves every argmax alone (the average left out, a positive
  scale a voxel) still moves the labels; this number holds the values;
- ``topology_mismatch``: voxels, over the scans, where the window's labels
  differ from the reference's post-process of the program's own ``P``
  (mapped to the 15 classes and cropped). A sum over the classes that
  crosses 0.25 in another order of addition can move a voxel;
- ``shape_mismatch``: 1 where the labels do not have the input's shape.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import frozen
from benchmark import weights_synthseg as weights
from benchmark.reference import synthseg as ref

ZOOMS = (1.0, 1.0, 1.0)


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from subcort_tpu_torch.engine import synthseg
        from subcort_tpu_torch.models.synthseg import SynthSegUNet

        run, cfg, tr = self.run, self.cfg, self.tr
        self.synthseg = synthseg
        t0 = time.perf_counter()
        shape = tuple(tr.get("shape", frozen.MNI_SHAPE))
        self.scans = [frozen.make_scan(np.random.default_rng([run.seed, i]),
                                       shape)[0]
                      for i in range(int(tr["scans"]))]
        run.setup_parts["inputs"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.params = weights.make_weights(cfg, run.seed, run.device)
        weights.calibrate(self.params, self.scans[0], run.device)
        self.net = SynthSegUNet.from_params(self.params, run.device)
        self.kw = dict(device=run.device, labels=cfg["labels"])
        run.setup_parts["program"] = time.perf_counter() - t0

        # warm-up: every scan once, the first twice (cuDNN's algorithm
        # choice, the allocator's pools, the filter kernel's build)
        t0 = time.perf_counter()
        for image in [self.scans[0]] + self.scans:
            self._one(image)
        run.setup_parts["warmup"] = time.perf_counter() - t0
        self.flops_per_scan = run.cell.flops.scan_flops(cfg, shape)

    def _one(self, image):
        with self.run.spans("segment_synthseg"):
            return self.synthseg.segment_synthseg(self.net, image, ZOOMS,
                                                  **self.kw)

    # ------------------------------------------------------------ window
    def window(self) -> None:
        run = self.run
        run.spans.seconds.clear()
        last, flops = {}, 0
        forwards0 = self.synthseg.FORWARDS
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
                          forwards=self.synthseg.FORWARDS - forwards0)
        run.end_to_end["scan_s"] = (tb - t0) / i

    def release(self) -> None:
        # the net stays: the check reads the program's posteriors
        pass

    # ------------------------------------------------------------ check
    def reference_prob(self, k: int, precision: str = "float32"):
        return ref.posteriors(self.params, self.scans[k], self.cfg["labels"],
                              self.cfg["lr_pairs"], self.run.device,
                              precision)

    def program_prob(self, k: int):
        return self.synthseg.flip_averaged_posteriors(
            self.net, self.scans[k], ZOOMS, self.run.device,
            labels=self.cfg["labels"])

    def check(self) -> dict:
        return judge_scans(self, self.last)

    def readings(self) -> dict:
        """The check's numbers on one pass over every scan, no window (for
        the readings a limit is set from)."""
        return judge_scans(self, [(k, self._one(s))
                                  for k, s in enumerate(self.scans)])

    def control(self) -> dict:
        """The control's numbers: the reference's posteriors computed in
        TF32, put in the program's place."""
        gap, error = 0.0, 0.0
        for k in range(len(self.scans)):
            low, _ = self.reference_prob(k, "tf32")
            want, _ = self.reference_prob(k)
            gap = max(gap, ref.posterior_gap(want, low.argmax(0)))
            error = max(error, ref.posterior_error(want, low))
            del low, want
        return {"posterior_gap": gap, "posterior_error": error}


def judge_scans(drv, done) -> dict:
    """The numbers the check compares over ``done`` ((scan index, labels)
    pairs)."""
    gap, error, mismatch, shape_bad = 0.0, 0.0, 0, 0
    for k, labels in done:
        image = drv.scans[k]
        if labels.shape != image.shape:
            shape_bad = 1
            continue
        prob, offsets = drv.program_prob(k)
        want, want_offsets = drv.reference_prob(k)
        if tuple(offsets) != tuple(want_offsets):
            shape_bad = 1
            continue
        gap = max(gap, ref.posterior_gap(want, prob.argmax(0)))
        error = max(error, ref.posterior_error(want, prob))
        del want
        index = ref.postprocess(prob.cpu().numpy(),
                                drv.cfg["topology_classes"])
        del prob
        post = ref.crop_labels(index, offsets, image.shape,
                               drv.cfg["structure_of"])
        mismatch += int(np.count_nonzero(post != labels))
    return {"posterior_gap": float(gap), "posterior_error": float(error),
            "topology_mismatch": float(mismatch),
            "shape_mismatch": float(shape_bad)}
