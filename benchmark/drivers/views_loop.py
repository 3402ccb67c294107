"""Closed-loop scans through FastSurferCNN's three views and the
post-process.

Traffic parameters (``traffic/<name>.json``): ``scans`` distinct scans of
``frozen.make_scan`` (int16, 1 mm, ``shape``) drawn from the seed, taken in
turn; ``batch`` slices a forward. The configuration gives the networks'
widths, the conformed ``height`` and the tables ``sagittal_to_full`` and
``structure_of``.

The window runs one scan after another, each through ``segment_views``
(conform, 3 views x ``height`` thick slices, aggregation, labels) and
``post_process_segmentation`` with a whole-volume mask (each class's
largest component), for ``--seconds`` and stops after the scan that
crosses it: ``scan_s`` is the window over the scans completed. The
program's ``engine.views.SLICES`` before and after the window gives the
slices forwarded in it.

The check, after the window, on its last completed scan of each input:
the plain reference's aggregated ``P`` (``reference/fastsurfer.py``) and,
per voxel, the gap ``max_k P_k - max_{k: structure_of[k] = L} P_k``, ``L``
the program's raw label; ``flipped_voxels``, the voxels whose gap exceeds
``FLIP_GAP`` (0.01) over the scans; ``postprocess_mismatch``, voxels where
the program's filtered labels differ from the reference's largest
component per class of the program's own raw labels; ``shape_mismatch``,
1 where the labels do not have the input's shape.

Why a count and not the largest gap: FastSurferCNN's max-unpool puts each
value back at its encoder's argmax, so the network is discontinuous where
a 2 x 2 window's two largest values lie within float32 rounding. Two
float32 evaluations that differ only in summation order (cuDNN's
algorithm at another batch, torch's BN kernel against BN written out)
disagree there, and the decoders' convolutions carry it to the
neighbours: a few voxels of a sound float32 program trail the reference
by up to 0.08, while TF32 and the planted faults move thousands to
millions (PERF.md §2).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import frozen
from benchmark import weights_fastsurfer as weights
from benchmark.reference import fastsurfer as ref_net
from benchmark.reference import postprocess as ref_post

ZOOMS = (1.0, 1.0, 1.0)
# a label trailing the reference's best class by more than this much
# probability is counted as flipped; a near-tie within it is not
FLIP_GAP = 0.01


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from subcort_tpu_torch.engine import views
        from subcort_tpu_torch.engine.postprocess import \
            post_process_segmentation
        from subcort_tpu_torch.models.fastsurfer import FastSurferViews

        run, cfg, tr = self.run, self.cfg, self.tr
        self.views = views
        self.post_process = post_process_segmentation
        t0 = time.perf_counter()
        shape = tuple(tr.get("shape", frozen.MNI_SHAPE))
        self.scans = [frozen.make_scan(np.random.default_rng([run.seed, i]),
                                       shape)[0]
                      for i in range(int(tr["scans"]))]
        self.mask = np.ones(shape, bool)
        run.setup_parts["inputs"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.params = weights.make_weights(cfg, run.seed, run.device)
        weights.calibrate(self.params, cfg, self.scans[0], run.device,
                          run.seed, size=int(cfg["height"]))
        self.nets = FastSurferViews.from_params(self.params, run.device)
        self.kw = dict(batch=int(tr["batch"]), size=int(cfg["height"]),
                       sagittal_to_full=cfg["sagittal_to_full"],
                       structure_of=cfg["structure_of"])
        run.setup_parts["program"] = time.perf_counter() - t0

        # warm-up: every scan once, the first twice (cuDNN's algorithm
        # choice, the allocator's pools, the filter kernel's build)
        t0 = time.perf_counter()
        for image in [self.scans[0]] + self.scans:
            self._one(image)
        run.setup_parts["warmup"] = time.perf_counter() - t0
        self.flops_per_scan = run.cell.flops.scan_flops(cfg)

    def _one(self, image):
        with self.run.spans("segment_views"):
            labels = self.views.segment_views(self.nets, image, ZOOMS,
                                              **self.kw)
        with self.run.spans("post_process"):
            out = self.post_process(None, labels, atlas_mask=self.mask)
        return labels, out

    # ------------------------------------------------------------ window
    def window(self) -> None:
        run = self.run
        run.spans.seconds.clear()
        last, flops = {}, 0
        slices0 = self.views.SLICES
        run.trace.start()
        t0 = time.perf_counter()
        i = 0
        while True:
            k = i % len(self.scans)
            with run.spans("scan"):
                labels, out = self._one(self.scans[k])
            tb = time.perf_counter()
            flops += self.flops_per_scan
            last[k] = (k, labels, out)
            i += 1
            if tb - t0 >= run.seconds:
                break
        run.trace.stop()
        self.last = [last[k] for k in sorted(last)]
        run.counts.update(attempted=i, failed=0, flops=flops,
                          slices=self.views.SLICES - slices0)
        run.end_to_end["scan_s"] = (tb - t0) / i

    def release(self) -> None:
        del self.nets

    # ------------------------------------------------------------ check
    def reference_prob(self, k: int, precision: str = "float32"):
        return ref_net.aggregate(self.params, self.scans[k],
                                 self.cfg["sagittal_to_full"],
                                 self.run.device, precision,
                                 size=int(self.cfg["height"]))

    def check(self) -> dict:
        return judge_scans(self, self.last)

    def readings(self) -> dict:
        """The check's numbers on one pass over every scan, no window (for
        the readings a limit is set from)."""
        return judge_scans(self, [(k,) + self._one(s)
                                  for k, s in enumerate(self.scans)])

    def control(self) -> dict:
        """The control's numbers: the labels of the reference computed in
        TF32, put in the program's place."""
        flipped = 0
        for k in range(len(self.scans)):
            low = ref_net.labels_of(self.reference_prob(k, "tf32"),
                                    self.cfg["structure_of"])
            flipped += flips(self.reference_prob(k), low,
                             self.cfg["structure_of"])
        return {"flipped_voxels": float(flipped)}


def judge_scans(drv, done) -> dict:
    """The numbers the check compares over ``done`` ((scan index, raw
    labels, post-processed labels) triples)."""
    flipped, mismatch, shape_bad = 0, 0, 0
    for k, labels, out in done:
        image = drv.scans[k]
        if labels.shape != image.shape or out.shape != image.shape:
            shape_bad = 1
            continue
        flipped += flips(drv.reference_prob(k), labels,
                         drv.cfg["structure_of"])
        want = ref_post.keep_components(labels, drv.mask)
        mismatch += int(np.count_nonzero(want != out))
    return {"flipped_voxels": float(flipped),
            "postprocess_mismatch": float(mismatch),
            "shape_mismatch": float(shape_bad)}


def flips(prob, labels, structure_of) -> int:
    """Voxels whose label trails the reference's best by over FLIP_GAP."""
    return int((ref_net.label_gaps(prob, labels, structure_of)
                > FLIP_GAP).sum())
