"""The readers of the program's spans (``"source": "program_span"``) on cut
runs on the CPU: with the program's recorder on over a window every reader
reads a number, the scan's stages account for the benchmark's own span
around ``segment_volume``, and a program without the recorder reads None
everywhere."""

import pytest
import tiny

from benchmark import harness

SOURCE = "program_span"


@pytest.fixture(autouse=True)
def empty_buffer():
    from subcort_tpu_torch.utils import runtime

    runtime.clear_records()
    yield
    runtime.clear_records()


def readers(workload):
    c = tiny.cell(workload)
    return {m["name"]: harness.load_module(
        harness.HERE / "metrics" / f"{m['name']}.py")
        for m in c.per_layer if m["source"] == SOURCE}


def window_recorded(workload, tmp_path, seconds=1.0):
    """A cut cell's driver whose window ran with the recorder on (on the
    CPU the harness opens no profiler); the buffer holds the window's
    spans."""
    from subcort_tpu_torch.utils import runtime

    drv = tiny.driver(workload, 2 ** 33 + 9, tmp_path)
    drv.run.seconds = seconds
    runtime.clear_records()
    with runtime.recording():
        drv.window()
    return drv


@pytest.mark.parametrize("workload", ["scan_dense", "train_b128"])
def test_every_reader_reads_the_window(workload, tmp_path):
    drv = window_recorded(workload, tmp_path)
    got = {name: r.read(drv.run) for name, r in readers(workload).items()}
    assert len(got) == {"scan_dense": 7, "train_b128": 4}[workload]
    assert all(v is not None and v >= 0 for v in got.values()), got
    if workload == "scan_dense":
        # the six stages and the root's own time are the call, which the
        # benchmark's span encloses
        from benchmark.program_spans import mean_self_per
        stages = sum(v for k, v in got.items() if k.startswith("infer_"))
        root = mean_self_per("infer.segment_volume", "infer.segment_volume")
        outer = drv.run.spans.mean("segment_volume")
        assert 0.9 * outer <= stages + root <= outer
        assert got["upload_gbs.scan"] > 0


@pytest.mark.parametrize("workload", ["scan_dense", "train_b128"])
def test_readers_read_none_without_the_recorder(workload, monkeypatch):
    """A program that keeps no records (a commit before the recorder)."""
    from subcort_tpu_torch.utils import runtime

    monkeypatch.delattr(runtime, "records")
    c = tiny.cell(workload)
    run = harness.Run(c, "cpu", 1, 0.0, True, ".")
    assert all(r.read(run) is None for r in readers(workload).values())
