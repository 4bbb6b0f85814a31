"""The port's spans and host-read counter (``utils/timer.py``) on a tiny
MCMC + PPISP training step and a served frame, on the CPU. No JAX.

Spans are off unless ``timing_options.active`` is set or a torch.profiler
capture runs; on, each layer of section 3 of PERF.md opens its span
under the step's or the frame's, and every device read of the step goes
through ``host_read``.
"""

import dataclasses

import pytest
import torch

from threedgrut_tpu_torch import synthetic
from threedgrut_tpu_torch.render.serve import make_serving_renderer
from threedgrut_tpu_torch.train.trainer import Trainer, TrainerConfig
from threedgrut_tpu_torch.utils import timer

LAYERS = ("grut.ut", "grut.sh", "grut.binning", "grut.table", "grut.raster")
READS = {"read.pair_total": "grut.binning", "read.loss": "grut.step",
         "read.psnr": "grut.step", "read.pairs": "grut.step",
         "read.overflow": "grut.step"}


@pytest.fixture(scope="module")
def scene():
    torch.manual_seed(0)
    teacher = synthetic.build_teacher(2000, seed=1)
    data = synthetic.teacher_dataset(teacher, n_views=2, side=24)
    return teacher, data


def _trainer(scene, ppisp=True):
    _, data = scene
    conf = TrainerConfig(strategy="mcmc",
                         post_processing="ppisp" if ppisp else None,
                         n_iterations=1000)
    conf = dataclasses.replace(conf, mcmc=conf.mcmc.replace(
        max_n_gaussians=512))
    return Trainer(conf, data, synthetic.bench_cloud(300, seed=2))


@pytest.fixture
def spans_on():
    timer.reset_spans()
    timer.timing_options.active = True
    yield
    timer.timing_options.active = False
    timer.reset_spans()


def _frame(scene):
    teacher, data = scene
    from threedgrut_tpu_torch.train.trainer import camera_from_batch
    render = make_serving_renderer(teacher, TrainerConfig().raster, 3)
    return lambda: render([camera_from_batch(data[0])])


def test_spans_off_record_nothing(scene, monkeypatch):
    """Off: a shared no-op context, no profiler range, no table entry and
    no count, through a training step and a served frame."""
    timer.reset_spans()
    assert not timer.spans_on()
    assert timer.ScopedTimer("grut.a") is timer.ScopedTimer("grut.b")

    def no_range(*a, **k):
        raise AssertionError("a profiler range while spans are off")
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    _trainer(scene).train_iteration(scene[1][0], frame_idx=0)
    _frame(scene)()
    assert timer.span_table() == {}
    assert timer.host_read_counts() == {}


def test_step_span_tree(scene, spans_on):
    """One step: every layer span under grut.step (the ISP under the loss,
    perturb under MCMC), each read under its layer; one unit; self time
    never above total."""
    tr = _trainer(scene)
    m = tr.train_iteration(scene[1][0], frame_idx=0)
    table = timer.span_table()
    parents = {k: v["parents"] for k, v in table.items()}
    assert parents["grut.step"] == [None]
    for name in LAYERS + ("grut.loss", "grut.backward", "grut.adam",
                          "grut.mcmc"):
        assert parents[name] == ["grut.step"], name
    assert parents["grut.isp"] == ["grut.loss"]
    assert parents["grut.mcmc.perturb"] == ["grut.mcmc"]
    for site, parent in READS.items():
        assert parents["grut." + site] == [parent], site
    assert "grut.mcmc.relocate" not in table
    for name, row in table.items():
        assert row["units"] == 1, name
        assert 0.0 <= row["self_ms"] <= row["total_ms"] + 1e-9, name
    assert table["grut.step"]["calls"] == 1
    counts = timer.host_read_counts()
    assert counts == {"pair_total": 1, "loss": len(m) - 3, "psnr": 1,
                      "pairs": 1, "overflow": 1}


def test_relocate_step_reads(scene, spans_on):
    """A step on relocate's and add's schedule: both under grut.mcmc;
    relocate reads its count of dead rows and whether any row is live,
    add whether any row is live; add's append knows its count."""
    tr = _trainer(scene, ppisp=False)
    tr.global_step = 599
    tr.train_iteration(scene[1][0], frame_idx=0)
    parents = {k: v["parents"] for k, v in timer.span_table().items()}
    assert parents["grut.mcmc.relocate"] == ["grut.mcmc"]
    assert parents["grut.mcmc.add"] == ["grut.mcmc"]
    assert "grut.isp" not in parents
    counts = timer.host_read_counts()
    assert counts["mcmc.any_live"] == 2
    assert counts["mcmc.relocated"] == 1
    assert "strategy.append" not in counts
    assert [e[1] for e in tr.event_stats] == ["relocate", "add"]
    assert tr.event_stats[1][2]["n_added"] > 0


def test_nht_step_decoder_spans(scene, spans_on):
    """An NHT step: the decoder's span under the loss, its EMA update
    under the step, and the decoded rows counted (one a pixel)."""
    from threedgrut_tpu_torch.models import nht_decoder

    _, data = scene
    conf = TrainerConfig(strategy="mcmc", n_iterations=1000)
    conf = dataclasses.replace(conf, mcmc=conf.mcmc.replace(
        max_n_gaussians=512))
    tr = Trainer(conf, data, synthetic.nht_cloud(300, seed=2))
    rows = nht_decoder.mlp.rows
    tr.train_iteration(data[0], frame_idx=0)
    parents = {k: v["parents"] for k, v in timer.span_table().items()}
    assert parents["grut.decoder"] == ["grut.loss"]
    assert parents["grut.decoder.ema"] == ["grut.step"]
    w, h = data[0].resolution
    assert nht_decoder.mlp.rows - rows == w * h


def test_frame_span_tree_and_units(scene, spans_on):
    """Two served frames: the layers under grut.frame, the pair total read
    under the binning, two units, one read a frame."""
    frame = _frame(scene)
    frame()
    frame()
    table = timer.span_table()
    assert table["grut.frame"]["parents"] == [None]
    assert table["grut.frame"]["units"] == 2
    for name in LAYERS:
        assert table[name]["parents"] == ["grut.frame"], name
        assert table[name]["units"] == 2, name
    assert table["grut.read.pair_total"]["parents"] == ["grut.binning"]
    assert timer.host_read_counts() == {"pair_total": 2}
    assert not {"grut.loss", "grut.adam", "grut.step"} & set(table)


def test_profiler_capture_turns_spans_on(scene):
    """A torch.profiler capture shows the grut. ranges (each with its
    unit) without the toggle, and the table and counts fill."""
    timer.reset_spans()
    frame = _frame(scene)
    with torch.profiler.profile() as prof:
        assert timer.spans_on()
        frame()
    assert not timer.spans_on()
    names = {e.name for e in prof.events()}
    assert {"grut.frame", "grut.read.pair_total", *LAYERS} <= names
    assert timer.host_read_counts() == {"pair_total": 1}
    assert timer.span_table()["grut.frame"]["calls"] == 1
    timer.reset_spans()


@pytest.mark.parametrize("value,want", [
    (torch.tensor(3, dtype=torch.int32), 3),
    (torch.tensor(2.5), 2.5),
    (torch.tensor(True), True),
])
def test_host_read_counts_per_site(spans_on, value, want):
    """host_read returns the value and counts one read for its site,
    under a grut.read.<site> span."""
    assert timer.host_read("a", value) == want
    assert timer.host_read("a", value) == want
    assert timer.host_read("b", value) == want
    assert timer.host_read_counts() == {"a": 2, "b": 1}
    assert timer.span_table()["grut.read.a"]["calls"] == 2
    timer.reset_spans()
    assert timer.host_read_counts() == {} and timer.span_table() == {}


def test_host_read_counts_nothing_while_off():
    timer.reset_spans()
    assert timer.host_read("a", torch.tensor(7)) == 7
    assert timer.host_read_counts() == {}


def test_nested_self_time(spans_on):
    """Self time is the total less the child spans; a timed function
    opens its span around the call."""
    import time

    @timer.timed("grut.inner")
    def inner():
        time.sleep(0.02)

    with timer.ScopedTimer("grut.outer", unit=True):
        inner()
        inner()
    t = timer.span_table()
    assert t["grut.inner"]["calls"] == 2
    assert t["grut.inner"]["parents"] == ["grut.outer"]
    outer = t["grut.outer"]
    assert outer["total_ms"] >= 40.0
    assert outer["self_ms"] == pytest.approx(
        outer["total_ms"] - t["grut.inner"]["total_ms"], abs=1e-6)
    assert outer["self_ms"] < 20.0


def test_upload_matches_a_plain_copy():
    got = timer.upload([[0.1, 2.0], [3.0, -1.0]], "cpu")
    want = torch.tensor([[0.1, 2.0], [3.0, -1.0]], dtype=torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert timer.upload([1, 2], "cpu", torch.float64).dtype == torch.float64
