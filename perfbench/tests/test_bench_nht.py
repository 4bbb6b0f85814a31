"""The NHT cell (``colmap_3dgut_mcmc_nht.train``) at a small size on the
CPU: a run and a traced run come out correct and read the host's
metrics; its limits name exactly the numbers its driver compares; the
controls and every planted fault read above a limit, and the program
below all; a program whose decoder's EMA shadow stands still is caught,
and one whose decoder multiplies in bf16 (the port's earlier decoder, a
precision below the configuration's half). With ``-m gpu``, a small
traced run on the card reads every per-layer metric within its limits.

``test_bench_layout.py::test_limits_name_every_compared_number`` keys its
expected numbers by driver name and knows no ``train_nht``; the third
test here holds this cell's limits in its place.
"""

from __future__ import annotations

import pytest
import torch

from perfbench import control_nht, harness, run
from perfbench.tests.conftest import WINDOW_S

CPU = torch.device("cpu")
CELL = "colmap_3dgut_mcmc_nht.train"
SEED = 2 ** 31 + 91


@pytest.fixture(scope="module")
def runs(small):
    c = harness.resolve_cell(CELL, small)
    return c, run.run_cell(c, SEED, WINDOW_S, False, CPU), run.run_cell(
        c, SEED + 1, WINDOW_S, True, CPU)


def test_the_cell_runs_correct_with_its_metrics(runs):
    c, out, traced = runs
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert traced["correct"], traced["checks"]
    # the device's metrics read nothing on the CPU; the rest read
    host = {"step_ms_p95.train", "pairs_per_view.train", "idle_share.train",
            "host_reads.train", "mfu.nht.train"}
    assert set(traced["metrics"]) == host
    assert {m["name"] for m in c.per_layer} >= host | {
        "roofline.raster_fwd_nht.train", "roofline.raster_bwd_nht.train",
        "roofline.decoder.train"}


def test_limits_name_exactly_the_compared_numbers(runs):
    c, out, _ = runs
    assert set(c.limits) == set(out["checks"]) == {
        "loss_gap", "grad_gap", "change_gap", "relocate_gap", "ema_gap",
        "rgb_gap"}
    assert all(v > 0 for v in c.limits.values())


def test_controls_and_faults_read_above_the_limits(small):
    c = harness.resolve_cell(CELL, small)
    r = control_nht.readings(c, SEED + 2, CPU)
    assert all(v <= c.limits[k] for k, v in r.pop("program").items())
    assert set(r) == {"control_" + p for p in control_nht.CONTROLS} | {
        "fault_" + f for f in control_nht.FAULTS} | {"fault_state_unchanged"}
    for kind, numbers in r.items():
        assert any(v > c.limits[k] for k, v in numbers.items()), kind


def test_a_decoder_whose_ema_stands_still_is_caught(small, monkeypatch):
    from threedgrut_tpu_torch.models.nht_decoder import FeatureDecoder

    monkeypatch.setattr(FeatureDecoder, "ema_update", lambda self: None)
    out = run.run_cell(harness.resolve_cell(CELL, small), SEED + 3,
                       WINDOW_S, False, CPU)
    assert not out["correct"]
    assert out["checks"]["ema_gap"]["value"] == pytest.approx(1.0)


def test_a_bf16_decoder_is_caught(small, monkeypatch):
    from torch.nn import functional as F

    from threedgrut_tpu_torch.models import nht_decoder

    def bf16(x, ws):
        h = x.to(torch.bfloat16)
        for w in ws[:-1]:
            h = torch.relu(F.linear(h, w.to(torch.bfloat16)))
        return torch.sigmoid(F.linear(h, ws[-1].to(torch.bfloat16)).float())

    monkeypatch.setattr(nht_decoder, "mlp", bf16)
    out = run.run_cell(harness.resolve_cell(CELL, small), SEED + 4,
                       WINDOW_S, False, CPU)
    assert not out["correct"]
    assert out["checks"]["rgb_gap"]["value"] > out["checks"]["rgb_gap"][
        "limit"]


@pytest.mark.gpu
def test_small_traced_run_on_the_card(small, cuda_device):
    c = harness.resolve_cell(CELL, small)
    out = run.run_cell(c, SEED + 5, 1.0, True, cuda_device)
    # the card's fp16 decoder rounds each pixel's cotangent, and a first
    # gradient sums 330x fewer pixels here than in the cell: its gap,
    # ~1 / sqrt(pixels), reads 2.45e-3 here against 1e-4-3e-4 at the
    # cell's size (an fp32 decoder: 1.8e-7), so the cell's runs judge it
    assert all(v["value"] <= v["limit"] for k, v in out["checks"].items()
               if k != "grad_gap"), out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in c.per_layer}
    for name, m in out["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100, name
