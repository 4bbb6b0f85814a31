"""The trainer's summary writer, the port's timers and its copies of the
JAX helpers (models/geometry.py, utils/{exif,logger}.py) against the JAX
package's.

CPU. Both trainers (tests/test_torch_trainer.py's views, initialisation
and GS events) run with ``enable_writer=True``: 2 steps, ``validate`` on
one view and ``log_validation_images`` on another, each package into its
own directory through tensorboardX (2.6.4 here; absent on the H100's
machine, where the writer does nothing). Both event files are read back
with tensorboard's EventAccumulator. Tolerances, with reasons:
  * the tag sets are equal (JAX adds no metric key of its own here);
  * train/total within 1e-4 relative and train/psnr within 1e-3 (the
    three-step test's bounds), the other train losses within 1e-4
    relative, train/pairs, train/overflow and train/n_gaussians equal;
  * the val scalars within 1e-3 (test_torch_trainer.py's validate test);
  * the returned image panels within 1e-4 (the render agrees to ~1e-5);
    the logged PNGs are 8-bit, so a value within 1e-4 of a rounding
    boundary may land one level apart: at most 1 level, on fewer than
    0.5% of the values.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_trainer import GS_EVENTS, Views, _init_state
from threedgrut_tpu.models import background as j_bg
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu.train import trainer as j_tr
from threedgrut_tpu_torch.convert import model_from_state
from threedgrut_tpu_torch.models.background import BackgroundConfig
from threedgrut_tpu_torch.train import trainer as t_tr
from threedgrut_tpu_torch.utils import timer as t_timer
from threedgrut_tpu_torch.utils.misc import create_summary_writer

PANELS = ("pred", "depth", "opacity", "hits", "gt")


def _trainers(views, jdir, tdir, enable_writer=True):
    j_conf = j_tr.TrainerConfig(
        raster=JRasterConfig(max_pairs=1 << 13, exact_kill=True),
        auto_max_pairs=False, init_n_features=0, max_n_features=2,
        increase_frequency=2,
        background=j_bg.BackgroundConfig(color="white"))
    j_conf.gs = j_conf.gs.replace(**GS_EVENTS)
    t_conf = t_tr.TrainerConfig(
        init_n_features=0, max_n_features=2, increase_frequency=2,
        background=BackgroundConfig(color="white"))
    t_conf.gs = t_conf.gs.replace(**GS_EVENTS)
    state = _init_state()
    return (j_tr.Trainer(j_conf, views, state, out_dir=str(jdir),
                         enable_writer=enable_writer),
            t_tr.Trainer(t_conf, views, model_from_state(state),
                         out_dir=str(tdir), enable_writer=enable_writer))


def _one(views, i):
    one = Views.__new__(Views)
    one.batches = views.batches[i:i + 1]
    return one


def _read(path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(str(path), size_guidance={"images": 0,
                                                     "scalars": 0})
    acc.Reload()
    return acc


def _png(event):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(event.encoded_image_string)))


@pytest.fixture(scope="module")
def views():
    return Views()


@pytest.fixture(scope="module")
def logged(views, tmp_path_factory):
    root = tmp_path_factory.mktemp("writer")
    jt, tt = _trainers(views, root / "jax", root / "port")
    for step in range(2):
        jt.train_iteration(views[step])
        tt.train_iteration(views[step])
    jt.validate(_one(views, 0))
    tt.validate(_one(views, 0))
    j_img = jt.log_validation_images(views[2])
    t_img = tt.log_validation_images(views[2])
    for w in jt.writer.writers + tt.writer.writers:
        w.close()   # flushes and ends tensorboardX's writer thread
    return _read(root / "jax"), _read(root / "port"), j_img, t_img


def test_writer_logs_jax_tags(logged):
    j, t, _, _ = logged
    assert t.Tags()["scalars"] and t.Tags()["images"]
    assert sorted(t.Tags()["scalars"]) == sorted(j.Tags()["scalars"])
    assert sorted(t.Tags()["images"]) == sorted(j.Tags()["images"])
    assert {f"val/{p}" for p in PANELS} == set(t.Tags()["images"])
    assert {"train/total", "train/l1", "train/ssim", "train/psnr",
            "train/pairs", "train/overflow", "train/n_gaussians",
            "val/psnr", "val/ssim", "val/hits_mean",
            "val/hits_max"} == set(t.Tags()["scalars"])


def test_writer_scalars_match_jax(logged):
    j, t, _, _ = logged
    for tag in t.Tags()["scalars"]:
        got, ref = t.Scalars(tag), j.Scalars(tag)
        assert [e.step for e in got] == [e.step for e in ref], tag
        for a, b in zip(got, ref):
            if tag in ("train/pairs", "train/overflow", "train/n_gaussians"):
                assert a.value == b.value, tag
            elif tag == "train/psnr" or tag.startswith("val/"):
                assert a.value == pytest.approx(b.value, abs=1e-3), tag
            else:
                assert a.value == pytest.approx(b.value, rel=1e-4), tag


def test_validation_images_match_jax(logged):
    j, t, j_img, t_img = logged
    assert set(t_img) == set(j_img) == set(PANELS)
    for k in PANELS:
        np.testing.assert_allclose(t_img[k].numpy(), np.asarray(j_img[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    for k in PANELS:
        (a,), (b,) = t.Images(f"val/{k}"), j.Images(f"val/{k}")
        assert a.step == b.step == 2
        pa, pb = _png(a).astype(int), _png(b).astype(int)
        assert pa.shape == pb.shape == (32, 48, 3)
        d = np.abs(pa - pb)
        assert d.max() <= 1 and (d > 0).mean() < 0.005, (k, d.max())


def test_writers_do_nothing_without_tensorboardx(views, tmp_path,
                                                monkeypatch):
    """With tensorboardX unimportable both writers have no backend (a
    MultiWriter of none) and write nothing; the port's trainer steps,
    validates and logs images as before."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    assert create_summary_writer(str(tmp_path / "w")).writers == []
    jt, tt = _trainers(views, tmp_path / "jax", tmp_path / "port")
    assert jt.writer.writers == [] and tt.writer.writers == []
    tt.train_iteration(views[0])
    tt.validate(_one(views, 1))
    images = tt.log_validation_images(views[1])
    assert set(images) == set(PANELS)
    for d in ("jax", "port"):
        assert not os.path.exists(tmp_path / d) or not os.listdir(
            tmp_path / d)


def test_trainer_without_writer_has_none(views, tmp_path):
    """enable_writer off (train_torch.py's and train.py's way), or no
    out_dir: no writer, as JAX."""
    jt, tt = _trainers(views, tmp_path / "j", tmp_path / "t",
                       enable_writer=False)
    assert jt.writer is None and tt.writer is None
    state = _init_state()
    assert t_tr.Trainer(tt.conf, views, model_from_state(state),
                        enable_writer=True).writer is None


class TestTimers:
    """tests/test_utils.py:105-124 on the port's utils/timer.py."""

    def test_device_timer(self):
        t = t_timer.DeviceTimer(device="cpu")
        t.start()
        x = torch.ones((128, 128)) @ torch.ones((128, 128))
        t.end(x)
        assert t.timing() > 0

    def test_device_timer_asks_for_the_cpu_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="cpu"):
            t_timer.DeviceTimer()

    def test_scoped_timer_toggle(self):
        t_timer.reset_spans()
        t_timer.timing_options.active = False
        with t_timer.ScopedTimer("off"):
            pass
        assert "off" not in t_timer.span_table()
        t_timer.timing_options.active = True
        try:
            with t_timer.ScopedTimer("on"):
                pass
        finally:
            t_timer.timing_options.active = False
        assert t_timer.span_table()["on"]["calls"] == 1
        t_timer.reset_spans()


def test_geometry_matches_jax():
    """models/geometry.py, a copy: the same distances and transform as
    JAX's, and its shape checks."""
    from threedgrut_tpu.models import geometry as j_geo
    from threedgrut_tpu_torch.models import geometry as t_geo

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    obs = rng.normal(size=(7, 3)).astype(np.float32)
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = 1.5 * np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
    tf[:3, 3] = [0.1, -0.2, 0.3]
    np.testing.assert_array_equal(t_geo.k_nearest_neighbors(pts, 4),
                                  j_geo.k_nearest_neighbors(pts, 4))
    np.testing.assert_array_equal(
        t_geo.nearest_neighbor_dist_cpuKD(pts, obs),
        j_geo.nearest_neighbor_dist_cpuKD(pts, obs))
    np.testing.assert_array_equal(t_geo.apply_points_transform(pts, tf),
                                  j_geo.apply_points_transform(pts, tf))
    with pytest.raises(ValueError):
        t_geo.apply_points_transform(pts, tf[:3])
    with pytest.raises(ValueError):
        t_geo.apply_points_transform(pts[:, :2], tf)


def test_exif_exposures_match_jax(tmp_path):
    """utils/exif.py, a copy: mean-normalised log2 exposures of JPEGs
    with shutter, f-number and ISO tags, a file without them left out."""
    from PIL import Image

    from threedgrut_tpu.utils import exif as j_exif
    from threedgrut_tpu_torch.utils import exif as t_exif

    paths = []
    for i, (shutter, fnum, iso) in enumerate(
            ((1 / 125, 2.8, 100), (1 / 60, 4.0, 400), (1 / 30, 2.0, 200))):
        img = Image.new("RGB", (8, 8), (i * 40, 80, 120))
        tags = Image.Exif()
        tags[0x829A], tags[0x829D], tags[0x8827] = shutter, fnum, iso
        paths.append(str(tmp_path / f"f{i}.jpg"))
        img.save(paths[-1], exif=tags)
    paths.append(str(tmp_path / "plain.jpg"))
    Image.new("RGB", (8, 8)).save(paths[-1])
    got = t_exif.load_exif_exposures(paths)
    assert got == j_exif.load_exif_exposures(paths)
    assert set(got) == {"f0.jpg", "f1.jpg", "f2.jpg"}
    assert abs(sum(got.values())) < 1e-9
    assert t_exif.load_exif_exposures(paths[-1:]) is None


def test_logger_progress_and_table():
    """utils/logger.py: the progress bar advances before rich has measured
    a speed (JAX's formats None and raises, ROADMAP.md §3), the table and
    the log calls run."""
    from threedgrut_tpu_torch.utils import logger as t_log

    assert t_log._speed_text(None) == " " * 6 + " it/s"
    assert t_log._speed_text(12.34) == "  12.3 it/s"
    log = t_log.TrainLogger("test_torch_writer")
    with log.progress("steps", 3) as advance:
        for _ in range(3):
            advance()
    log.table("metrics", {"psnr": 30.0, "n": 3})
    log.info("done %d", 3)
