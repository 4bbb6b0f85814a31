"""A small run of each cell on the card: the program's kernels and the
reference agree, and a traced run reads every per-layer metric. Run on
the card with ``python3 -m pytest -m gpu perfbench/tests``."""

from __future__ import annotations

import pytest

from perfbench import harness, run


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["colmap_3dgut_mcmc.train",
                                  "cusfm_3dgut_mcmc.train",
                                  "cusfm_3dgut_mcmc.serve"])
def test_small_traced_run_on_the_card(small, cuda_device, cell):
    c = harness.resolve_cell(cell, small)
    out = run.run_cell(c, 2 ** 31 + 9, 1.0, True, cuda_device)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in c.per_layer}
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for name, m in out["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100, name
