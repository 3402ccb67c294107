"""The harness end to end on the CPU: its refusals, the modules a run loads,
cut cells that come out correct, and the same cells with the timed path
broken underneath, which must come out not correct."""

import shutil
import subprocess
import sys

import pytest
import torch
import tiny
from tiny import ROOT

from benchmark import faults, harness


def run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "scan_dense",
         "--seed", "3000000007", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_no_jax_in_a_run():
    """A cut run of every cell in a fresh interpreter loads no module whose
    top-level name is jax, jaxlib, flax or subcort_tpu."""
    code = (
        "import sys; sys.path.insert(0, 'benchmark/tests'); import tiny\n"
        "from benchmark import harness\n"
        "for w in tiny.TRAFFIC: tiny.execute(w, seconds=0.5)\n"
        "print(harness.check_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_check_modules_names_whole_top_levels(monkeypatch):
    monkeypatch.setitem(sys.modules, "subcort_tpu_torch_x", sys)
    assert harness.check_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.check_modules() == ["jaxlib"]


@pytest.mark.parametrize("workload", sorted(tiny.TRAFFIC))
def test_cut_cells_are_correct(workload):
    out = tiny.execute(workload)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("workload,fault", [
    ("scan_dense", "flip_one_label"),
    ("train_b128", "unchanged_state"),
    ("train_b128", "half_batch"),
    ("train_b128", "stuck_row_counter"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    out = tiny.execute(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload,narrow,traffic", [
    ("scan_dense", True, {}),
    ("train_b128", False, {})])
def test_the_control_fails(tmp_path, workload, narrow, traffic):
    """The reference in TF32 put in the program's place fails the cell's
    limits on a cut input: the first steps of training at full width; the
    scans, whose widest gap needs many candidates to find a near-tie that
    TF32 flips, at narrow widths."""
    drv = tiny.driver(workload, 2 ** 34 + 1, tmp_path, narrow=narrow,
                      **traffic)
    limits = drv.run.cell.limits
    numbers = {k: v for k, v in drv.control().items() if k in limits}
    ok, rows = harness.judge(numbers, {k: limits[k] for k in numbers})
    assert not ok, rows


def test_idle_gaps_split_over_the_open_spans():
    from benchmark.trace import idle_by_span
    marks = [(0, 100, "scan"), (0, 60, "segment_volume"),
             (60, 100, "post_process"), (100, 200, "scan"),
             (100, 150, "segment_volume"), (150, 200, "post_process")]
    got = idle_by_span([(40, 120), (170, 230)], marks, "harness")
    assert {k: round(v * 1e9) for k, v in got.items()} == {
        "segment_volume": 40, "post_process": 70, "harness": 30}
