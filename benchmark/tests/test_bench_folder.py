"""The cell ``folder_serial`` cut to the CPU (the narrow tri-planar net,
two 40 x 48 x 40 subjects written as gzipped NIfTI, the ROI dilated
twice): it comes out correct, reading the raw labels through
``segment_folder``'s public ``on_raw_labels`` hook and the written labels
from disk; a label flipped where the engine makes it, and a written file
that is not the post-process of the raw labels, are not correct."""

import dataclasses
import tempfile
import time
from pathlib import Path

import numpy as np
import tiny
import torch

from benchmark import faults, harness

torch.set_num_threads(1)

TRAFFIC = dict(shape=[40, 48, 40], scans=2, dilate=2)


def execute(seconds: float = 1.0) -> dict:
    c = harness.resolve(harness.load_manifest(tiny.ROOT), "folder_serial",
                        tiny.ROOT)
    c = dataclasses.replace(c, config=dict(c.config, **tiny.NARROW),
                            traffic=dict(c.traffic, **TRAFFIC))
    with tempfile.TemporaryDirectory() as tmp:
        return harness.execute(c, "cpu", 2 ** 33 + 5, seconds, False,
                               Path(tmp), time.perf_counter())


def test_the_cut_cell_is_correct():
    out = execute()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["attempted"] % 2 == 0
    assert set(out["metrics"]) == {"scan_s", "setup_s"}


def test_a_flipped_label_is_not_correct(monkeypatch):
    faults.flip_one_label(monkeypatch.setattr)
    out = execute()
    assert not out["correct"], out["checks"]
    assert out["checks"]["logit_gap"]["value"] > \
        out["checks"]["logit_gap"]["limit"]


def test_a_written_file_that_is_not_the_post_process_is_not_correct(
        monkeypatch):
    """The writer's post-process replaced by the raw labels: the written
    file differs from the reference's post-process of the hook's labels."""
    from subcort_tpu_torch.engine import infer

    monkeypatch.setattr(infer, "post_process_segmentation",
                        lambda folder, labels, **kw: np.asarray(labels))
    out = execute()
    assert not out["correct"], out["checks"]
    assert out["checks"]["postprocess_mismatch"]["value"] > 0
