"""Fixtures of the benchmark's CPU tests: a checkout-like root whose
cells are the benchmark's own at a size the CPU renders in seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the small size: rows, image, views, serving orbit
SMALL = dict(rows=2048, resolution=[64, 48], views=4, orbit=6)
# a window that serves the small orbit's every view (each a kept one) on a
# busy CPU
WINDOW_S = 2.0


def small_root(dst: Path) -> Path:
    """A copy of ``perfbench/`` and ``BENCHMARK.json`` under ``dst`` whose
    configurations keep every published setting but the sizes."""
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        conf.update(rows=SMALL["rows"], max_n_gaussians=SMALL["rows"],
                    views=SMALL["views"])
        conf["app_overrides"] = [
            f"strategy.add.max_n_gaussians={SMALL['rows']}"]
        conf["camera"].update(resolution=SMALL["resolution"],
                              serve_orbit_views=SMALL["orbit"])
        (dst / c["file"]).write_text(json.dumps(conf))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session")
def small(tmp_path_factory) -> Path:
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return small_root(tmp_path_factory.mktemp("small"))


@pytest.fixture
def cuda_device():
    """The card, or a skip where none is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
