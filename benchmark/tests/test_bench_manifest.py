"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the cells' metrics and the files each entry is found by."""

import json
import math
import re

import pytest
from tiny import ROOT

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                    r"expansion|_dim$|_rank$|experts_per_tok|filters|fc)")


@pytest.fixture(scope="module")
def manifest():
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_keys_and_sizes(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in manifest["paths"])
            assert (ROOT / word).is_file()
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    cells = 24
    assert ((2 + 14 * cells) * (manifest["run_seconds"] + 60)
            + cells * 2 * 90 + 1200) <= 43200


def test_names_units_and_entries(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["source"].startswith(("https://", "http://", "arXiv"))
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in manifest["workloads"]} == \
        {c["name"] for c in manifest["configs"]}
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= ({"bound"} if m in manifest["end_to_end"]
                    else {"layer", "moves"})
        assert set(m) <= allowed
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for group in ("configs", "workloads"):
        names += [e["name"] for e in manifest[group]]
    assert len(names) == len(set(names))


def test_end_to_end_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_what_it_must(manifest):
    for w in manifest["workloads"]:
        cell = harness.resolve(manifest, w["name"], ROOT)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert line(m["layer"])
        for name in m.get("workloads", cells):
            assert name in cells
            cell = harness.resolve(manifest, name, ROOT)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_files_found_by_name(manifest):
    here = ROOT / "benchmark"
    for w in manifest["workloads"]:
        cell = harness.resolve(manifest, w["name"], ROOT)
        assert (here / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert cell.limits and all(
            isinstance(v["limit"], (int, float)) and math.isfinite(v["limit"])
            for v in cell.limits.values())
        assert hasattr(cell.flops, "scan_flops")
    for m in manifest["per_layer"]:
        reader = harness.load_module(here / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)
    for path in here.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT).as_posix()
            assert PATH.match(rel), rel
