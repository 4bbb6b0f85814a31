"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Module names are compared by their
whole top-level name: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys
import types

from perfbench import harness
from perfbench.tests.conftest import ROOT

PB = ROOT / "perfbench"
JAX_SIDE = {"jax", "jaxlib", "flax", "threedgrut_tpu"}
PORT = {"threedgrut_tpu_torch", "train_torch"}


def imported_tops(path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_the_jax_side():
    files = sorted(PB.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported_tops(f) & JAX_SIDE, f


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((PB / "reference").rglob("*.py"))
    assert files
    for f in files:
        tops = imported_tops(f)
        assert not tops & (PORT | JAX_SIDE | {"perfbench"}), (f, tops)


def test_the_forbidden_modules_are_told_by_whole_top_level_names(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "threedgrut_tpu_torch_x",
                        types.ModuleType("threedgrut_tpu_torch_x"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "threedgrut_tpu.ops",
                        types.ModuleType("threedgrut_tpu.ops"))
    assert harness.forbidden_loaded() == ["threedgrut_tpu"]


def test_a_run_loads_no_jax(small):
    code = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from perfbench import harness, run\n"
        "cell = harness.resolve_cell('cusfm_3dgut_mcmc.serve', Path(%r))\n"
        "out = run.run_cell(cell, 3, 0.2, True, torch.device('cpu'))\n"
        "assert out['correct'], out\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        % (str(ROOT), str(small)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(eval(res.stdout.strip().splitlines()[-1]))
    assert "threedgrut_tpu_torch" in loaded
    assert not loaded & JAX_SIDE


def test_a_run_without_the_port_fails_before_any_result(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ alone: no result."""
    import shutil

    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "cusfm_3dgut_mcmc.serve", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert res.returncode != 0
    assert '"correct"' not in res.stdout
