"""Closed-loop folder sweeps through ``SegmentationEngine.segment_folder``,
as ``cli infer`` runs them: gzipped NIfTI in, labels on disk.

Traffic parameters (``traffic/<name>.json``): ``scans`` subjects of
``frozen.make_scan`` drawn from the seed (``shape``; ``dilate`` the
dilations of the ROI that give the candidates), each written once at
set-up as a folder of gzipped NIfTI (level 1, the program's writer): its
``T1.nii.gz`` (int16), ``tmp/MNI_sub_probabilities.nii.gz`` (15 float32
priors) and ``tmp/MNI_subcortical_mask.nii.gz`` (the ROI). The
configuration gives the network's widths and the path (``use_fcn``,
``compute_dtype``, ``prior_dtype``).

The window sweeps the folder serially (``folder_pipeline`` off) with
``post_process`` on, again and again, for ``--seconds``, and stops after
the sweep that crosses it: each scan is its T1 and priors read and
gunzipped, its candidates, the dense segmentation, the post-process and
``out_subcortical_seg_prec.nii.gz`` gzipped to disk. ``scan_s`` is the
window over the scans completed.

The check, after the window, on the last sweep: each subject's raw labels
as the program handed them to ``segment_folder``'s public
``on_raw_labels`` hook, and its written labels read back from disk,
judged as ``scan_loop.py`` judges a scan (``logit_gap`` at the candidates
against the plain reference's logits, ``stray_labels``,
``postprocess_mismatch`` against the reference's post-process of the raw
labels).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import frozen, weights
from benchmark.drivers import scan_loop
from benchmark.reference import triplanar as ref_net

OUT = "out_subcortical_seg_prec.nii.gz"


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from subcort_tpu_torch.config import Options
        from subcort_tpu_torch.engine import SegmentationEngine
        from subcort_tpu_torch.io import NiftiImage, load_nii, save_nii

        run, cfg, tr = self.run, self.cfg, self.tr
        self.load_nii = load_nii
        t0 = time.perf_counter()
        shape = tuple(tr.get("shape", frozen.MNI_SHAPE))
        self.folder = run.workdir / "folder"
        self.scans, self.subjects = [], []
        for i in range(int(tr["scans"])):
            image, atlas, roi = frozen.make_scan(
                np.random.default_rng([run.seed, i]), shape)
            self.scans.append(scan_loop.Scan(image, atlas, roi,
                                             frozen.candidates(
                roi, int(tr.get("dilate", frozen.DILATE_CROP)))))
            sub = self.folder / f"s{i:02d}"
            (sub / "tmp").mkdir(parents=True)
            save_nii(NiftiImage(image), str(sub / "T1.nii.gz"))
            save_nii(NiftiImage(atlas),
                     str(sub / "tmp" / "MNI_sub_probabilities.nii.gz"))
            save_nii(NiftiImage(roi.astype(np.uint8)),
                     str(sub / "tmp" / "MNI_subcortical_mask.nii.gz"))
            self.subjects.append(sub.name)
        run.setup_parts["inputs"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.params = weights.make_weights(cfg, run.seed, run.device)
        s = self.scans[0]
        weights.center_logits(self.params, cfg, s.image, s.atlas, s.centers,
                              run.device, run.seed)
        dev = run.device
        mode = "cpu" if dev.type == "cpu" else f"cuda{dev.index or 0}"
        options = Options(
            mode=mode, test_folder=str(self.folder), t1_name="T1.nii.gz",
            use_fcn=bool(cfg["use_fcn"]), compute_dtype=cfg["compute_dtype"],
            prior_dtype=cfg["prior_dtype"], post_process=True, crop=True,
            dilate_crop_iters=int(tr.get("dilate", frozen.DILATE_CROP)),
            folder_pipeline=False, net_verbose=0, debug=False)
        self.engine = SegmentationEngine(self.params, options,
                                         scan_loop.spec_of(cfg))
        run.setup_parts["program"] = time.perf_counter() - t0

        # warm-up: two sweeps (cuDNN's handles and algorithm choice, the
        # allocator's pools, the filter kernel's build)
        t0 = time.perf_counter()
        for _ in range(2):
            self._sweep()
        run.setup_parts["warmup"] = time.perf_counter() - t0

    def _sweep(self) -> dict:
        raw = {}

        def keep(subject, labels):
            raw[subject] = labels

        with self.run.spans("segment_folder"):
            self.engine.segment_folder(on_raw_labels=keep)
        return raw

    # ------------------------------------------------------------ window
    def window(self) -> None:
        run = self.run
        run.spans.seconds.clear()
        scans = 0
        run.trace.start()
        t0 = time.perf_counter()
        while True:
            raw = self._sweep()
            tb = time.perf_counter()
            scans += len(self.subjects)
            if tb - t0 >= run.seconds:
                break
        run.trace.stop()
        self.raw = raw
        run.counts.update(attempted=scans, failed=0)
        run.end_to_end["scan_s"] = (tb - t0) / scans

    def release(self) -> None:
        del self.engine

    # ------------------------------------------------------------ check
    def reference_logits(self, k: int, precision: str = "float32"):
        s = self.scans[k]
        return ref_net.scan_logits(self.params, self.cfg, s.image, s.atlas,
                                   s.centers, self.run.device, precision)

    def _done(self, raw: dict) -> list:
        """(scan index, raw labels, written labels) of each subject."""
        done = []
        for k, sub in enumerate(self.subjects):
            written = np.asarray(self.load_nii(
                str(self.folder / sub / OUT)).data)
            done.append((k, raw[sub], written))
        return done

    def check(self) -> dict:
        return scan_loop.judge_scans(self, self._done(self.raw))

    def readings(self) -> dict:
        """The check's numbers on one sweep, no window."""
        return scan_loop.judge_scans(self, self._done(self._sweep()))

    def control(self) -> dict:
        """The control's numbers: the labels of the reference computed in
        TF32, put in the program's place."""
        return {"logit_gap": max(scan_loop.control_gap(self, k)
                                 for k in range(len(self.scans)))}

