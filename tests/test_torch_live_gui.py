"""The port's live-training GUI (threedgrut_tpu_torch/playground/live_gui.py)
and ``utils/misc.py:jet_map`` against the JAX package's.

CPU. A TrainingGUI over a tiny trainer (3 teacher views at 24x24, 300
random Gaussians) serves on port 0, the port the system picks, so that
test workers never collide; a helper thread drives the HTTP surface as
a browser would while ``run`` trains on the test's thread. jet_map is
held to JAX's within 1e-7 (the same clipped float32 products).
"""

import json
import threading
import time
import types
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu.playground import live_gui as j_gui
from threedgrut_tpu.utils.misc import jet_map as j_jet
from threedgrut_tpu_torch.playground import live_gui as t_gui
from threedgrut_tpu_torch.utils.misc import jet_map as t_jet

STEPS = 6
# seconds the browser waits for the last step and the video
DEADLINE = 900
MODES = ("rgb", "depth", "opacity", "hits", "points")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_jet_map_matches_jax():
    v = np.random.default_rng(0).uniform(-5, 30, (7, 9, 1)).astype(
        np.float32)
    for max_val in (1.0, 20.0, 128.0):
        np.testing.assert_allclose(
            t_jet(torch.tensor(v), max_val).numpy(),
            np.asarray(j_jet(jnp.asarray(v), max_val)), atol=1e-7, rtol=0)


def _get(url, timeout=120):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _tiny_trainer():
    from threedgrut_tpu_torch.models.gaussians import (GaussianModelConfig,
                                                       default_capacity_for,
                                                       random_initialization)
    from threedgrut_tpu_torch.synthetic import (build_teacher,
                                                orbit_geometry,
                                                teacher_dataset)
    from threedgrut_tpu_torch.train.trainer import Trainer, TrainerConfig

    teacher = build_teacher(600, seed=0)
    ds = teacher_dataset(teacher, n_views=3, side=24)
    model = random_initialization(
        GaussianModelConfig(), 300, extent=ds.get_scene_extent(), seed=1,
        capacity=default_capacity_for(300, headroom=2.0))
    return (Trainer(TrainerConfig(n_iterations=STEPS), ds, model),
            orbit_geometry(teacher))


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    tr, (center, dist) = _tiny_trainer()
    out = str(tmp_path_factory.mktemp("live"))
    gui = t_gui.TrainingGUI(tr, center=tuple(center), resolution=(32, 24),
                            port=0, out_dir=out, host="127.0.0.1")
    gui.export_frames_per_key = 2
    gui.paused = True               # paused before the first step
    base = gui.start()
    res = {"port": gui.port, "base": base, "out": out}
    q = f"&dist={dist:.3f}"

    def browser():
        try:
            res["page"] = _get(base)
            a = json.loads(_get(base + "state")[1])
            time.sleep(0.5)
            b = json.loads(_get(base + "state")[1])
            _get(base + "cmd?op=toggle_pause")
            res["paused"] = (a, b, json.loads(_get(base + "state")[1]))
            for mode in MODES:
                res[mode] = _get(base + f"frame.jpg?az=0.3&el=0.2{q}"
                                 f"&mode={mode}")
            _get(base + f"cmd?op=addkey&az=0&el=0.1{q}")
            _get(base + f"cmd?op=addkey&az=1.0&el=0.3{q}")
            _get(base + "cmd?op=export")
            deadline = time.time() + DEADLINE
            while time.time() < deadline:
                st = json.loads(_get(base + "state")[1])
                if st.get("video") and st["step"] >= STEPS:
                    res["video"] = _get(base + "video.mp4")
                    break
                time.sleep(0.1)
            res["final"] = json.loads(_get(base + "state")[1])
        finally:
            gui.stop()

    t = threading.Thread(target=browser)
    t.start()
    gui.run(max_steps=STEPS)
    t.join(timeout=DEADLINE)
    res["step"] = tr.global_step
    return res


def test_gui_binds_the_port_it_reports(session):
    assert session["port"] > 0
    assert session["base"] == f"http://localhost:{session['port']}/"
    status, body = session["page"]
    assert status == 200 and b"threedgrut_tpu_torch live" in body


def test_gui_trains_and_renders_every_mode(session):
    st = session["final"]
    assert st["step"] == session["step"] == STEPS
    assert np.isfinite(st["loss"]) and st["ng"] == 300
    for mode in MODES:
        status, body = session[mode]
        assert status == 200 and body[:2] == b"\xff\xd8", mode


def test_gui_pause_holds_the_step(session):
    """Paused, the step holds; toggle_pause resumes (and the run then
    reaches its last step)."""
    a, b, resumed = session["paused"]
    assert a["paused"] and b["paused"] and a["step"] == b["step"] == 0
    assert not resumed["paused"]


def test_gui_exports_the_flythrough(session):
    """Two keys, 4 interpolated frames: an MP4 where imageio encodes it,
    else (no ffmpeg) the PNG frames, served zipped."""
    import io
    import os
    import zipfile

    status, body = session["video"]
    assert status == 200 and len(body) > 200
    if body[:2] == b"PK":
        names = zipfile.ZipFile(io.BytesIO(body)).namelist()
        assert names == [f"{i:05d}.png" for i in range(4)]
    else:
        assert os.path.exists(os.path.join(session["out"], "flythrough.mp4"))


class _Done:
    """A trainer whose training is over (global_step = n_iterations)."""

    def __init__(self):
        self.conf = types.SimpleNamespace(n_iterations=3, seed=0)
        self.global_step = 3
        self.dataset = [None]
        self.out_dir = None


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_quirk_run_serves_until_stopped(package, tmp_path):
    """After the last step run() keeps serving until stop()
    (live_gui.py:266-268), in both packages; train.py writes
    ckpt_last.npz only after it returns."""
    gui = (j_gui.TrainingGUI(_Done(), out_dir=str(tmp_path), port=0)
           if package == "jax" else
           t_gui.TrainingGUI(_Done(), out_dir=str(tmp_path), port=0))
    t = threading.Thread(target=gui.run)
    t.start()
    time.sleep(0.3)
    assert t.is_alive()
    gui.stop()
    t.join(timeout=10)
    assert not t.is_alive()
