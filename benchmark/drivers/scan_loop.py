"""Closed-loop scans through ``segment_volume`` and the post-process.

Traffic parameters (``traffic/<name>.json``):

- ``scans``: distinct MNI-sized scans drawn from the seed (``frozen.
  make_scan``), taken in turn, so that nothing keyed on an array serves a
  repeat; ``shape`` their size; ``dilate`` the dilations of the ROI that
  give the candidates (the reference's crop: 10).

The configuration gives the network's widths and the path: ``use_fcn``
(the dense evaluator where the density rule picks it, else the patch
engine), ``compute_dtype`` and ``prior_dtype``.

The window runs one scan after another, each through ``segment_volume``
and ``post_process_segmentation`` (scipy, the default back end), for
``--seconds`` and stops after the scan that crosses it: ``scan_s`` is the
window over the scans completed, ``scan_p95_s`` the 95th percentile of
their wall times.

The check, after the window, on the window's last completed scan of each
input (its last ``scans`` scans): the plain reference's logits at every
candidate; ``logit_gap``, the widest amount by which the reference's logit
of the program's label lies below the reference's best over the
candidates; ``stray_labels``, labelled voxels that are not
candidates; ``postprocess_mismatch``, voxels where the program's
post-processed labels differ from the reference's post-process of the
program's own labels.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import frozen, weights
from benchmark.reference import postprocess as ref_post
from benchmark.reference import triplanar as ref_net

P95 = 95


def spec_of(cfg: dict):
    from subcort_tpu_torch.models import TriPlanarSpec
    return TriPlanarSpec(
        patch_size=cfg["patch_size"], num_channels=cfg["num_channels"],
        conv_filters=tuple(cfg["conv_filters"]), fc_conv=cfg["fc_conv"],
        fc_fc=cfg["fc_fc"], fc2=cfg["fc2"], num_classes=cfg["num_classes"],
        atlas_dim=cfg["atlas_dim"], dropout_conv=cfg["dropout_conv"],
        dropout_fc=cfg["dropout_fc"], bn_epsilon=cfg["bn_epsilon"],
        bn_alpha=cfg["bn_alpha"])


class Scan:
    def __init__(self, image, atlas, roi, centers):
        self.image, self.atlas, self.roi, self.centers = (image, atlas, roi,
                                                          centers)


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from subcort_tpu_torch.engine.infer import segment_volume
        from subcort_tpu_torch.engine.postprocess import \
            post_process_segmentation
        from subcort_tpu_torch.models import TriPlanarNet

        run, cfg, tr = self.run, self.cfg, self.tr
        self.segment_volume = segment_volume
        self.post_process = post_process_segmentation
        t0 = time.perf_counter()
        shape = tuple(tr.get("shape", frozen.MNI_SHAPE))
        self.scans = []
        for i in range(int(tr["scans"])):
            image, atlas, roi = frozen.make_scan(
                np.random.default_rng([run.seed, i]), shape)
            self.scans.append(Scan(image, atlas, roi, frozen.candidates(
                roi, int(tr.get("dilate", frozen.DILATE_CROP)))))
        run.setup_parts["inputs"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.params = weights.make_weights(cfg, run.seed, run.device)
        s = self.scans[0]
        weights.center_logits(self.params, cfg, s.image, s.atlas, s.centers,
                              run.device, run.seed)
        self.net = TriPlanarNet.from_params(self.params, spec_of(cfg),
                                            run.device)
        self.kw = dict(engine="auto" if cfg["use_fcn"] else "patch",
                       prior_dtype=np.dtype(cfg["prior_dtype"]),
                       compute_dtype=cfg["compute_dtype"])
        run.setup_parts["program"] = time.perf_counter() - t0

        # warm-up: every scan once, the first twice (cuDNN's handles and
        # algorithm choice, the allocator's pools)
        t0 = time.perf_counter()
        for scan in [self.scans[0]] + self.scans:
            self._one(scan)
        run.setup_parts["warmup"] = time.perf_counter() - t0
        self.flops_per_scan = [run.cell.flops.scan_flops(cfg, s.centers,
                                                         s.image.shape)
                               for s in self.scans]

    def _one(self, scan):
        with self.run.spans("segment_volume"):
            labels, _ = self.segment_volume(self.net, scan.image, scan.atlas,
                                            scan.centers, **self.kw)
        with self.run.spans("post_process"):
            out = self.post_process(None, labels, atlas_mask=scan.roi)
        return labels, out

    # ------------------------------------------------------------ window
    def window(self) -> None:
        run = self.run
        run.spans.seconds.clear()
        last, times, flops = {}, [], 0
        run.trace.start()
        t0 = time.perf_counter()
        i = 0
        while True:
            k = i % len(self.scans)
            ta = time.perf_counter()
            with run.spans("scan"):
                labels, out = self._one(self.scans[k])
            tb = time.perf_counter()
            times.append(tb - ta)
            flops += self.flops_per_scan[k]
            last[k] = (k, labels, out)
            i += 1
            if tb - t0 >= run.seconds:
                break
        window_s = tb - t0
        run.trace.stop()
        self.last = [last[k] for k in sorted(last)]
        run.counts.update(attempted=i, failed=0, flops=flops)
        run.end_to_end["scan_s"] = window_s / i
        run.end_to_end["scan_p95_s"] = float(np.percentile(times, P95))

    def release(self) -> None:
        del self.net

    # ------------------------------------------------------------ check
    def reference_logits(self, k: int, precision: str = "float32"):
        s = self.scans[k]
        return ref_net.scan_logits(self.params, self.cfg, s.image, s.atlas,
                                   s.centers, self.run.device, precision)

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
        return {"logit_gap": max(control_gap(self, k)
                                 for k in range(len(self.scans)))}


def labels_gap(logits: np.ndarray, labels: np.ndarray) -> float:
    """Widest amount by which the reference's logit of ``labels`` lies below
    the reference's best, over the rows."""
    chosen = np.take_along_axis(logits, labels[:, None].astype(np.int64), 1)
    return float((logits.max(1) - chosen[:, 0]).max())


def judge_scans(drv, done) -> dict:
    """The numbers the check compares over ``done`` ((scan index, raw
    labels, post-processed labels) triples)."""
    gap, stray, mismatch = 0.0, 0, 0
    cache = {}
    for k, labels, out in done:
        s = drv.scans[k]
        if k not in cache:
            cache[k] = drv.reference_logits(k)
        c = s.centers
        gap = max(gap, labels_gap(cache[k], labels[c[:, 0], c[:, 1], c[:, 2]]))
        inside = np.zeros(labels.shape, bool)
        inside[c[:, 0], c[:, 1], c[:, 2]] = True
        stray += int(np.count_nonzero(labels[~inside]))
        want = ref_post.keep_components(labels, s.roi)
        mismatch += int(np.count_nonzero(want != out))
    return {"logit_gap": gap, "stray_labels": float(stray),
            "postprocess_mismatch": float(mismatch)}


def control_gap(drv, k: int) -> float:
    """The control's reading on scan ``k``: the labels of the reference
    computed in TF32, judged against the float32 reference's logits."""
    want = drv.reference_logits(k)
    low = drv.reference_logits(k, "tf32")
    return labels_gap(want, low.argmax(1))

