"""The trace reduction and each per-layer metric's arithmetic on a
made-up profiler table, and the frozen counts against their parts."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from perfbench import harness
from perfbench.counts import raster

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def ev(name, start, end, device=CPU, thread=1, annotation=False):
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def made_up_trace():
    """A 1,000 us traced range: kernels B (100-300 us), C (400-450 us and
    500-600 us) overlapping a copy (550-650 us); host ops around them."""
    return [
        ev("perfbench.traced", 0, 1000),
        ev("perfbench.traced", 0, 1000, CUDA, annotation=True),
        ev("void raster_fwd_rgb_kernel<2>", 100, 300, CUDA),
        ev("void raster_bwd_kernel<2>", 400, 450, CUDA),
        ev("void raster_bwd_kernel<2>", 500, 600, CUDA),
        ev("Memcpy DtoD", 550, 650, CUDA),
        ev("void raster_fwd_rgb_kernel<2>", 1200, 1300, CUDA),  # outside
        ev("aten::nonzero", 20, 95),
        ev("aten::item", 30, 90),
        ev("aten::mul", 310, 395, thread=2),
        ev("aten::add", 660, 990),
    ]


def test_reduce_trace_busy_window_kernels_and_gaps():
    r = harness.reduce_trace(made_up_trace(), 2)
    assert r["window_s"] == pytest.approx(1000e-6)
    # the union: 200 + 50 + 150 (500-650) us
    assert r["busy_s"] == pytest.approx(400e-6)
    assert r["kernels"]["void raster_bwd_kernel<2>"] == pytest.approx(150e-6)
    assert "perfbench.traced" not in r["kernels"]
    assert r["device_ops"][0][0] == "void raster_fwd_rgb_kernel<2>"
    gaps = dict(r["idle_gaps"])
    # 0-100 (innermost at its middle: aten::item), 300-400 (aten::mul on
    # another thread), 450-500 (none), 650-1000 (aten::add)
    assert gaps["aten::item"] == pytest.approx(100e-6)
    assert gaps["aten::mul"] == pytest.approx(100e-6)
    assert gaps["host (no operator)"] == pytest.approx(50e-6)
    assert gaps["aten::add"] == pytest.approx(350e-6)


def records():
    r = harness.reduce_trace(made_up_trace(), 2)
    r.update(unit_s=[0.01 * k for k in range(1, 21)],
             pairs=[100, 300], unit_mean_s=0.02,
             counts=[{"evals": 1e6, "particles": 1e4, "pixels": 1e4,
                      "rows": 1e5, "isp": True}] * 2)
    return r


def metric(name):
    cell = harness.resolve_cell("cusfm_3dgut_mcmc.train")
    return harness.load_metric(cell, name)


def test_entry_and_binning_metrics():
    r = records()
    # linear between ranks: 0.95 * 19 = 18.05 -> 0.19 + 0.05 * 0.01
    assert metric("step_ms_p95.train").read(r) == pytest.approx(190.5)
    assert metric("frame_ms_p95.serve").read(r) == pytest.approx(190.5)
    assert metric("pairs_per_view.train").read(r) == 200
    # a reader that finds nothing to read returns nothing
    assert metric("step_ms_p95.train").read({}) is None
    assert metric("frame_ms_p95.serve").read({}) is None
    assert metric("pairs_per_view.train").read({"pairs": []}) is None


def test_rooflines_are_bound_over_kernel_time():
    r = records()
    b = raster.raster_fwd(r["counts"][0])["bound_s"]
    assert metric("roofline.raster_fwd.train").read(r) == pytest.approx(
        100 * 2 * b / 200e-6)
    c = raster.raster_bwd(r["counts"][0])["bound_s"]
    assert metric("roofline.raster_bwd.train").read(r) == pytest.approx(
        100 * 2 * c / 150e-6)
    r["kernels"] = {"aten::mul": 1.0}
    assert metric("roofline.raster_fwd.train").read(r) is None


def test_mfu_and_idle_share():
    r = records()
    want = raster.train_step_flops(r["counts"][0]) / (0.02 * 67e12)
    assert metric("mfu.train").read(r) == pytest.approx(100 * want)
    assert metric("idle_share.train").read(r) == pytest.approx(60.0)
    assert metric("idle_share.serve").read(r) == pytest.approx(60.0)
    assert metric("idle_share.serve").read({}) is None
    assert metric("mfu.serve").read({"unit_mean_s": 0.02}) is None


def test_counts_tie_to_their_parts():
    c = {"evals": 1000, "particles": 10, "pixels": 100, "rows": 50}
    f = raster.raster_fwd(c)
    assert f["flops"] == 1000 * raster.FWD_FLOPS_PER_EVAL
    assert f["bytes"] == 10 * 64 + 100 * (20 + 24)
    assert f["bound_s"] == max(f["flops"] / 67e12, f["bytes"] / 3.35e12)
    b = raster.raster_bwd(c)
    assert b["bytes"] == 2 * 10 * 64 + 100 * 52
    serve = raster.serve_frame_flops(c)
    assert serve == 50 * (250 + 135 + 49) + f["flops"] + 600
    step = raster.train_step_flops(c)
    assert step > serve + b["flops"]
