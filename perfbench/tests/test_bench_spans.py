"""``spans.py``: the reduction of a trace by ``grut.`` span on a made-up
event tree, the host-read readers on the program's counter, and on the
card, the syncs of each cell's unit against the reads the program
counts, and a span's device time against CUDA events."""

from __future__ import annotations

import warnings
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, spans
from threedgrut_tpu_torch.utils import timer

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
CELLS = ["colmap_3dgut_mcmc.train", "cusfm_3dgut_mcmc.train",
         "cusfm_3dgut_mcmc.serve"]


def ev(name, start, end, thread=1, seq=-1, fwd=0, device=CPU, id=0):
    return SimpleNamespace(
        name=name, device_type=device, thread=thread, fwd_thread=fwd,
        sequence_nr=seq, is_user_annotation=name.startswith("grut."),
        time_range=SimpleNamespace(start=start, end=end), id=id)


def launch(start, id, thread=1, name="cudaLaunchKernel"):
    return ev(name, start, start + 2, thread=thread, id=id)


def made_up_trace():
    """One 1,000 us unit: the UT's mul and the raster's Function forward
    on thread 1, their backward nodes on the engine's thread 2 (linked by
    sequence_nr; the table's no-op records the raster's number first, as
    an operation that makes no node does), an AccumulateGrad's copy and a
    node whose forward is not in the trace (both left to grut.backward),
    Adam, a fill under the step alone, and a kernel with no launch in
    the trace. Each kernel shares its id with its launch."""
    return [
        ev("perfbench.traced", 0, 1000),
        ev("grut.step", 0, 900),
        ev("grut.ut", 10, 100),
        ev("aten::mul", 20, 30, seq=5), launch(25, 101),
        ev("grut.table", 102, 108),
        ev("aten::contiguous", 103, 104, seq=6),
        ev("grut.raster", 110, 200),
        ev("_Rasterize", 120, 190, seq=6), launch(150, 102),
        ev("grut.backward", 300, 700),
        ev("autograd::engine::evaluate_function: _RasterizeBackward",
           310, 400, thread=2, seq=6, fwd=1),
        ev("_RasterizeBackward", 311, 399, thread=2, seq=6, fwd=1),
        launch(320, 103, thread=2),
        ev("MulBackward0", 410, 450, thread=2, seq=5, fwd=1),
        ev("aten::mul", 411, 449, thread=2), launch(420, 104, thread=2),
        ev("torch::autograd::AccumulateGrad", 460, 470, thread=2),
        launch(462, 105, thread=2, name="cudaMemcpyAsync"),
        ev("OtherBackward0", 480, 490, thread=2, seq=99, fwd=1),
        launch(482, 106, thread=2),
        ev("grut.adam", 710, 800),
        ev("aten::add", 720, 730), launch(722, 107),
        ev("aten::zeros", 850, 860), launch(852, 108),
        # the device's track: an annotation range, the kernels and a copy
        ev("grut.step", 0, 900, device=CUDA),
        ev("mul_kernel", 100, 140, device=CUDA, id=101),
        ev("raster_fwd", 200, 300, device=CUDA, id=102),
        ev("raster_bwd", 400, 600, device=CUDA, id=103),
        ev("mul_kernel", 610, 640, device=CUDA, id=104),
        ev("Memcpy DtoD", 650, 660, device=CUDA, id=105),
        ev("other", 670, 675, device=CUDA, id=106),
        ev("add", 800, 820, device=CUDA, id=107),
        ev("fill", 870, 877, device=CUDA, id=108),
        ev("orphan", 880, 882, device=CUDA, id=999),
    ]


def test_reduce_spans_charges_forward_and_linked_backward():
    r = spans.reduce_spans(made_up_trace(), 1)
    approx = pytest.approx
    assert r["device_ms"] == approx({
        "grut.ut": 0.070, "grut.raster": 0.300, "grut.backward": 0.015,
        "grut.adam": 0.020, "grut.step": 0.007, spans.NO_SPAN: 0.002})
    assert r["backward_ms"] == approx({"grut.ut": 0.030,
                                       "grut.raster": 0.200})
    assert r["layer_share"] == approx(0.405 / 0.414)
    assert r["uncovered"] == [["fill", approx(0.007)],
                              ["orphan", approx(0.002)]]
    assert r["idle_ms"] == approx({
        "grut.ut": 0.100, "grut.raster": 0.060, "grut.backward": 0.130,
        "grut.adam": 0.125, "grut.step": 0.053, spans.NO_SPAN: 0.118})
    # per unit, and the span helpers
    assert spans.reduce_spans(made_up_trace(), 2)["device_ms"][
        "grut.raster"] == approx(0.150)
    assert spans.device_ms(r, spans.PROJECT) == approx(0.070)
    assert spans.device_ms(r, ["grut.mcmc"]) is None
    # every device event once: the device time is reduce_trace's busy
    # time, and the idle time the traced window less it
    busy = harness.reduce_trace(made_up_trace(), 1)["busy_s"] * 1e3
    assert sum(r["device_ms"].values()) == approx(busy)
    assert sum(r["idle_ms"].values()) == approx(1.0 - busy)


def test_reduce_spans_needs_the_traced_range():
    with pytest.raises(RuntimeError, match="perfbench.traced"):
        spans.reduce_spans(made_up_trace()[1:], 1)


def test_device_ms_takes_a_spans_children():
    r = {"device_ms": {"grut.mcmc": 0.5, "grut.mcmc.perturb": 2.0,
                       "grut.mcmcx": 9.0}}
    assert spans.device_ms(r, ["grut.mcmc"]) == pytest.approx(2.5)


def test_enqueue_ms_leaves_out_the_reads():
    table = {"grut.step": {"calls": 2, "total_ms": 80.0},
             "grut.read.loss": {"calls": 10, "total_ms": 30.0},
             "grut.read.pairs": {"calls": 2, "total_ms": 10.0}}
    assert spans.enqueue_ms(table, "grut.step") == pytest.approx(20.0)
    assert spans.enqueue_ms(table, "grut.frame") is None


@pytest.mark.parametrize("cell,metric,unit", [
    ("colmap_3dgut_mcmc.train", "host_reads.train", "grut.step"),
    ("cusfm_3dgut_mcmc.serve", "host_reads.serve", "grut.frame")])
def test_host_read_readers(cell, metric, unit):
    """The readers divide the program's counted reads by its units; they
    read nothing where no unit ran with spans on."""
    c = harness.resolve_cell(cell)
    reader = harness.load_metric(c, metric)
    timer.reset_spans()
    assert reader.read({}) is None
    timer.timing_options.active = True
    try:
        for _ in range(2):
            with timer.ScopedTimer(unit, unit=True):
                for _ in range(3):
                    timer.host_read("site", torch.tensor(1.0))
    finally:
        timer.timing_options.active = False
    assert reader.read({}) == pytest.approx(3.0)
    timer.reset_spans()


def test_host_read_reader_without_the_counter(monkeypatch):
    """A program that has no counter (the parent of the change that adds
    it) gives no value, and no error."""
    monkeypatch.delattr(timer, "host_read_counts")
    assert spans.host_reads_per_unit("grut.step") is None


def _syncs(fn) -> int:
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in got)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_syncs_are_the_counted_reads(small, cuda_device, cell):
    """One unit of the cell (a training step, and one on relocate's and
    add's schedule; a served frame) synchronises with the card exactly as
    often as the program counts host reads, with spans on and off."""
    c = harness.resolve_cell(cell, small)
    drv = harness.load_driver(c)
    st = drv.setup(SimpleNamespace(cell=c, seed=2 ** 31 + 77,
                                   device=cuda_device))
    if "train" in cell:
        def relocating():
            tr = st["trainer"]
            tr.global_step += 99 - tr.global_step % 100
            drv._step(st)
        units = [lambda: drv._step(st), relocating]
    else:
        units = [lambda: st["render"]([st["cams"][0]])]
    for unit in units:
        timer.reset_spans()
        timer.timing_options.active = True
        try:
            on = _syncs(unit)
        finally:
            timer.timing_options.active = False
        reads = sum(timer.host_read_counts().values())
        off = _syncs(unit)
        assert on == reads == off, (timer.host_read_counts(), on, off)
        assert reads >= 1
    timer.reset_spans()


@pytest.mark.gpu
def test_span_device_time_matches_cuda_events(cuda_device):
    """Matrix products inside a span, queued behind a wait on the card so
    that they run back to back: the trace's device time under the span
    and CUDA events around it agree within 5%."""
    x = torch.randn(4096, 4096, device=cuda_device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def unit():
        torch.cuda._sleep(50_000_000)
        with timer.ScopedTimer("grut.test"):
            start.record()
            for _ in range(8):
                x @ x
            end.record()

    unit()
    events = spans.profile_events(unit, 1)
    r = spans.reduce_spans(events, 1)
    ms = start.elapsed_time(end)
    assert r["device_ms"]["grut.test"] == pytest.approx(ms, rel=0.05)
    timer.reset_spans()
