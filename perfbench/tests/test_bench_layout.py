"""BENCHMARK.json against the benchmark's contract, every cell's files
found by name, and a dummy cell, traffic mix and per-layer metric added
from a temporary directory with files and entries alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from perfbench import harness, run
from perfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_bounds():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for cell in m["workloads"]:
            mv = e2e[m["moves"]]
            assert cell in mv.get("workloads", CELLS), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        c = harness.resolve_cell(cell)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        assert c.chips == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = harness.resolve_cell(cell)
    driver = harness.load_driver(c)
    for fn in ("setup", "window", "end_to_end", "trace", "release",
               "counts", "check", "compare"):
        assert callable(getattr(driver, fn)), fn
    for m in c.per_layer:
        assert callable(harness.load_metric(c, m["name"]).read)
    for m in c.end_to_end:
        assert m["name"] == "setup_s" or m["name"] in driver.end_to_end(
            {"attempted": 10, "elapsed_s": 1.0, "unit_s": [0.1] * 10})
    entry = {x["name"]: x for x in BENCH["configs"]}[
        {w["name"]: w for w in BENCH["workloads"]}[cell]["config"]]
    assert (ROOT / entry["file"]).is_file()
    for key in entry["reduced"]:
        assert key in c.config and NAME.match(key)


def test_limits_name_every_compared_number():
    want = {"train": {"loss_gap", "grad_gap", "change_gap",
                      "relocate_gap"},
            "serve": {"flip_share", "bulk_rmse"}}
    for cell in CELLS:
        c = harness.resolve_cell(cell)
        assert set(c.limits) == want[c.traffic["driver"]]
        assert all(v > 0 for v in c.limits.values())


DUMMY_DRIVER = '''
"""A traffic of counted sums, for the layout test."""
import time


def setup(ctx):
    return {"n": ctx.cell.traffic["per_unit"]}


def window(st, seconds):
    t0 = time.perf_counter()
    times = []
    while time.perf_counter() - t0 < seconds:
        s = time.perf_counter()
        sum(range(st["n"]))
        times.append(time.perf_counter() - s)
    return {"unit_s": times, "attempted": len(times),
            "failed": 0, "elapsed_s": time.perf_counter() - t0,
            "unit_mean_s": sum(times) / len(times)}


def end_to_end(w):
    return {"dummy_units_per_s": w["attempted"] / w["elapsed_s"]}


def trace(st, n):
    return {"kernels": {}, "busy_s": 0.0,
            "window_s": 1.0, "device_ops": [], "idle_gaps": []}


def release(st):
    pass


def counts(st):
    return []


def check(st):
    return {"sum_gap": 0.0}
'''

DUMMY_METRIC = '''
def read(records):
    t = records.get("unit_s")
    return 1000.0 * max(t) if t else None
'''


def test_a_cell_a_mix_and_a_metric_are_added_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "perfbench"
    (pb / "drivers" / "dummy.py").write_text(DUMMY_DRIVER)
    (pb / "traffic" / "counted.json").write_text(json.dumps(
        {"driver": "dummy", "per_unit": 1000, "profiled": 3}))
    (pb / "metrics" / "unit_ms_max.dummy.py").write_text(DUMMY_METRIC)
    (pb / "limits" / "colmap_3dgut_mcmc.counted.json").write_text(
        json.dumps({"sum_gap": 0.0}))
    bench["workloads"].append({
        "name": "colmap_3dgut_mcmc.counted", "config": "colmap_3dgut_mcmc",
        "traffic": "counted", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "dummy_units_per_s", "unit": "units/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["colmap_3dgut_mcmc.counted"]})
    bench["per_layer"].append({
        "name": "unit_ms_max.dummy", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "entry",
        "moves": "dummy_units_per_s",
        "workloads": ["colmap_3dgut_mcmc.counted"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve_cell("colmap_3dgut_mcmc.counted", root)
    cpu = torch.device("cpu")
    out = run.run_cell(cell, 7, 0.2, False, cpu)
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"dummy_units_per_s", "setup_s"}
    out = run.run_cell(cell, 7, 0.2, True, cpu)
    assert set(out["metrics"]) == {"unit_ms_max.dummy"}
    assert list(out)[-1] == "checks"
    # the benchmark's own cells are untouched by the addition
    assert harness.resolve_cell("cusfm_3dgut_mcmc.serve", root).per_layer \
        == harness.resolve_cell("cusfm_3dgut_mcmc.serve").per_layer
