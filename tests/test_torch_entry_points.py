"""The port's counterparts of the repository's remaining entry points,
against the JAX ones on the CPU at a small size:

  * scripts/train_denoiser_torch.py: the random scene equal to JAX's for
    one numpy stream; one pair with the randomness off (spp_mode "none",
    no aperture) within the engine's tolerance, 1e-4
    (tests/test_torch_playground.py); the loss within 1e-6 relative and
    two Adam steps within 1e-5 of max against JAX's loss and optax.adam
    on the same numpy parameters and crops; the whole script on a cached
    4-pair npz at side 16 (the full-set MSE falls; ``denoise_frame(path=)``
    loads the new weights);
  * notebooks/playground_headless_torch.ipynb: its code cells in order on
    the CPU (64x64 frames, 1 spp, a small generated checkpoint), the JAX
    notebook's cells in kind and order, its props' materials equal;
  * tools/parity_probe_torch.py at --side 24 --n 500;
  * scripts/gen_parity_fixture_torch.py: byte for byte the committed
    tests/fixtures/parity_cloud.ply;
  * scripts/eval_fps_torch.py --save-frame through tools/compare_frames.py;
  * tools/convert_ckpt_nht.py on a port checkpoint: the port's NHT model
    initialised to JAX's parameters, then two training steps;
  * scripts/conv_table.py: the same table from the port's and JAX's
    run_training log lines on the same steps and clock, and a table from
    a real port training log.

JAX's engine runs trace() through a jitted wrapper of the same function
(its Pallas kernel in interpret mode), so the kernel compiles once rather
than on every eager call.
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

ENGINE_TOL = 1e-4


def _load(name, rel):
    """The module of a script of the repository, by path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO,
                                                                     rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the renders and fits here are many small ops,
    which several threads slow down on a loaded machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scripts():
    """(JAX's train_denoiser, the port's train_denoiser_torch)."""
    return (_load("jax_train_denoiser", "scripts/train_denoiser.py"),
            _load("train_denoiser_torch", "scripts/train_denoiser_torch.py"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def test_random_scene_matches_jax(scripts):
    j_td, t_td = scripts
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    je, te = j_td.random_scene(rj), t_td.random_scene(rt, "cpu")
    jp = je.model.params
    for k in ("positions", "rotation", "scale", "density",
              "features_albedo", "features_specular"):
        np.testing.assert_array_equal(_np(getattr(te.model, k)),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    assert te.model.n_active == int(je.model.n_active) == 220
    assert te.model.n_active_features == int(je.model.n_active_features)
    for f in ("max_bounces", "spp", "spp_mode", "aperture", "focus_distance",
              "gaussian_sh_degree", "denoise", "denoiser"):
        assert getattr(te.config, f) == getattr(je.config, f), f
    np.testing.assert_array_equal(_np(te.envmap.constant),
                                  np.asarray(je.envmap.constant))
    assert len(te.materials) == len(je.materials) >= 3
    for tm, jm in zip(te.materials, je.materials):
        for f in ("kind", "roughness", "metallic", "ior", "transmission"):
            assert getattr(tm, f) == getattr(jm, f), f
        np.testing.assert_array_equal(np.asarray(tm.base_color),
                                      np.asarray(jm.base_color))
    assert len(te.meshes) == len(je.meshes)
    for tm, jm in zip(te.meshes, je.meshes):
        np.testing.assert_array_equal(tm.vertices, np.asarray(jm.vertices))
        np.testing.assert_array_equal(tm.faces, np.asarray(jm.faces))
        assert tm.material_id == jm.material_id
    # the numpy stream stands at the same place
    assert rj.integers(0, 2 ** 31) == rt.integers(0, 2 ** 31)


def _jit_trace():
    """JAX's trace, jitted per (sh_degree, t_min): the same function, its
    interpret-mode kernel compiled once."""
    from threedgrut_tpu.render.grt import trace

    cache = {}

    def jitted(model, o, d, sh_degree=3, t_min=1e-4, t_max=1e7):
        key = (sh_degree, t_min)
        if key not in cache:
            cache[key] = jax.jit(functools.partial(trace, sh_degree=sh_degree,
                                                   t_min=t_min))
        return cache[key](model, o, d, t_max=t_max)

    return jitted


def test_render_pair_without_randomness_matches_jax(scripts, monkeypatch):
    """One pair at side 16, spp_ref 2 with the jitter and the aperture
    off: the same camera and the same renders as JAX's, and the numpy
    stream at the same place after it."""
    from threedgrut_tpu.playground import engine as j_engine

    monkeypatch.setattr(j_engine, "trace", _jit_trace())
    j_td, t_td = scripts
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    je, te = j_td.random_scene(rj), t_td.random_scene(rt, "cpu")
    for eng in (je, te):
        eng.config.spp_mode = "none"
        eng.config.aperture = 0.0
    jn, jc = j_td.render_pair(je, rj, 16, 2)
    tn, tc = t_td.render_pair(te, rt, 16, 2)
    assert te.config.spp == 1
    for got, ref in ((tn, jn), (tc, jc)):
        assert got.shape == (16, 16, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(ref), atol=ENGINE_TOL,
                                   rtol=0)
    assert float(np.std(tn)) > 0.01       # a scene, not a blank frame
    assert rj.integers(0, 2 ** 31) == rt.integers(0, 2 ** 31)


def test_engine_render_seed(scripts):
    """The engine's seed drives the jitter and the aperture: the same
    seed renders the same frame, another seed another one."""
    _, t_td = scripts
    rng = np.random.default_rng(9)
    eng = t_td.random_scene(rng, "cpu")
    cam = t_td.pair_camera(rng, 8, "cpu")
    a, b, c = (eng.render(cam, seed=s) for s in (11, 11, 12))
    np.testing.assert_array_equal(a, b)
    assert float(np.abs(a - c).max()) > 1e-3


def _jax_loss(j_cnn, p, x, y):
    """scripts/train_denoiser.py:176-184 (``loss_fn`` inside its main)."""
    out = j_cnn.apply_cnn(p, x)
    l1 = jnp.mean(jnp.abs(out - y))
    gx = jnp.mean(jnp.abs((out[:, :, 1:] - out[:, :, :-1])
                          - (y[:, :, 1:] - y[:, :, :-1])))
    gy = jnp.mean(jnp.abs((out[:, 1:] - out[:, :-1])
                          - (y[:, 1:] - y[:, :-1])))
    return l1 + 0.5 * (gx + gy)


def test_loss_and_adam_steps_match_jax(scripts):
    """The port's loss and torch's Adam (the script's optimiser) against
    JAX's loss and optax.adam on the same numpy parameters and crops: the
    loss within 1e-6 relative, the parameters after each of two steps
    within 1e-5 of max."""
    import optax

    from threedgrut_tpu.playground import denoise_cnn as j_cnn

    _, t_td = scripts
    rng = np.random.default_rng(0)
    shapes = {"conv_in": (3, 3, 3, 24), "res0_a": (3, 3, 24, 24),
              "res0_b": (3, 3, 24, 24), "res1_a": (3, 3, 24, 24),
              "res1_b": (3, 3, 24, 24), "conv_out": (3, 3, 24, 3)}
    raw = {k: {"w": (rng.normal(size=s) * np.sqrt(2.0 / (9 * s[2]))
                     ).astype(np.float32),
               "b": (rng.normal(size=s[3]) * 0.01).astype(np.float32)}
           for k, s in shapes.items()}
    crops = [(rng.uniform(size=(2, 12, 12, 3)).astype(np.float32),
              rng.uniform(size=(2, 12, 12, 3)).astype(np.float32))
             for _ in range(2)]
    lr = 2e-3

    jp = jax.tree_util.tree_map(jnp.asarray, raw)
    opt = optax.adam(lr)
    state = opt.init(jp)
    tp = {k: {n: torch.tensor(v, requires_grad=True) for n, v in d.items()}
          for k, d in raw.items()}
    leaves = [p for d in tp.values() for p in d.values()]
    t_opt = torch.optim.Adam(leaves, lr=lr)
    for x, y in crops:
        jl, g = jax.value_and_grad(functools.partial(_jax_loss, j_cnn))(
            jp, jnp.asarray(x), jnp.asarray(y))
        up, state = opt.update(g, state)
        jp = optax.apply_updates(jp, up)
        t_opt.zero_grad()
        tl = t_td.loss_fn(tp, torch.tensor(x), torch.tensor(y))
        tl.backward()
        t_opt.step()
        assert abs(tl.item() - float(jl)) <= 1e-6 * abs(float(jl))
        for k in raw:
            for n in ("w", "b"):
                np.testing.assert_allclose(
                    _np(tp[k][n]), np.asarray(jp[k][n]), atol=1e-5, rtol=0,
                    err_msg=f"{k}/{n}")


def test_train_denoiser_script_on_cpu(scripts, tmp_path, capsys,
                                      monkeypatch):
    """The script renders 4 pairs at side 16 (8-spp targets) into its npz
    cache (the JAX script's format), then trains 20 steps from that
    cache: the
    full-set MSE falls and denoise_frame(path=out) serves the new
    weights."""
    from threedgrut_tpu_torch.playground import denoise_cnn

    _, t_td = scripts
    data = str(tmp_path / "pairs.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_td.main(["--data", data, "--steps", "0"])
    first = t_td.main(["--device", "cpu", "--scenes", "4", "--side", "16",
                       "--spp-ref", "8", "--steps", "0", "--data", data,
                       "--out", str(tmp_path / "w0.npz")])
    assert len(first["pair_ms"]) == 4
    with np.load(data) as blob:
        assert blob["noisy"].shape == blob["clean"].shape == (4, 16, 16, 3)
        assert blob["noisy"].dtype == np.float32
        noisy = blob["noisy"]
    out = str(tmp_path / "w.npz")
    got = t_td.main(["--device", "cpu", "--data", data, "--steps", "20",
                     "--crop", "8", "--batch", "2", "--out", out])
    assert "loaded 4 cached pairs" in capsys.readouterr().out
    assert got["pair_ms"] == [] and len(got["step_ms"]) == 20
    assert got["out_mse"] < got["base_mse"] and got["gain_db"] > 0
    with np.load(out) as w:
        assert w["conv_in/w"].shape == (3, 3, 3, 24)
        assert float(np.abs(w["conv_out/w"]).max()) > 0   # trained
    frame = torch.tensor(noisy[0])
    ref = denoise_cnn.apply_cnn(denoise_cnn.load_params(out), frame)
    torch.testing.assert_close(denoise_cnn.denoise_frame(frame, path=out),
                               ref, rtol=0, atol=0)
    assert not torch.equal(ref, denoise_cnn.denoise_frame(frame))


def _small_checkpoint(path, n=96, seed=1):
    from scene_utils import make_test_scene
    from threedgrut_tpu_torch.convert import model_from_state, save_checkpoint

    _, state = make_test_scene(n=n, seed=seed)
    save_checkpoint(model_from_state(state), path)


NOTEBOOK = os.path.join(REPO, "notebooks", "playground_headless_torch.ipynb")


def _notebook_cells():
    with open(NOTEBOOK) as f:
        nb = json.load(f)
    return [c for c in nb["cells"] if c["cell_type"] == "code"]


def test_headless_notebook_runs_on_cpu(tmp_path, monkeypatch):
    """The notebook's code cells in order, with the parameters cell's
    values replaced: the CPU, a small checkpoint, 64x64 frames, 1 spp;
    IPython.display stubbed where IPython is absent. With the default
    device and no card it stops at the model's cell."""
    ckpt = str(tmp_path / "ckpt.npz")
    _small_checkpoint(ckpt)
    if importlib.util.find_spec("IPython") is None:
        stub = types.ModuleType("IPython.display")
        stub.display = stub.clear_output = lambda *a, **k: None
        monkeypatch.setitem(sys.modules, "IPython", types.ModuleType(
            "IPython"))
        monkeypatch.setitem(sys.modules, "IPython.display", stub)
    monkeypatch.chdir(os.path.join(REPO, "notebooks"))
    cells = _notebook_cells()
    assert len(cells) == 8
    overrides = dict(DEVICE="cpu", ASSET=ckpt, SIDE=64, SPP=1,
                     PROGRESSIVE_SPP=1, VIDEO_SIDE=64, VIDEO_FRAMES=2,
                     OUT_DIR=str(tmp_path))

    ns = {}
    with contextlib.redirect_stdout(io.StringIO()) as log:
        for cell in cells:
            exec(compile("".join(cell["source"]), NOTEBOOK, "exec"), ns)
            if "parameters" in cell["metadata"].get("tags", ()):
                assert set(overrides) <= set(ns)
                ns.update(overrides)
    assert ns["device"] == torch.device("cpu")
    for name in ("frame", "fish", "dof"):
        img = ns[name]
        assert img.shape == (64, 64, 3) and np.isfinite(img).all(), name
        assert 0.0 <= img.min() and img.max() <= 1.0
    assert ns["fish"][0, 0].sum() == 0.0          # outside the field of view
    assert ns["engine"].config.denoise and len(ns["engine"].meshes) == 2
    # cell for cell the JAX notebook: the same kinds of cells in order, and
    # its props' materials as the JAX notebook writes them
    with open(os.path.join(REPO, "notebooks",
                           "playground_headless.ipynb")) as f:
        ref = json.load(f)["cells"]
    with open(NOTEBOOK) as f:
        assert ([c["cell_type"] for c in json.load(f)["cells"]]
                == [c["cell_type"] for c in ref])
    from threedgrut_tpu_torch.playground.engine import PBRMaterial
    ref_mats = re.findall(r"PBRMaterial\([^)]*\)",
                          "".join("".join(c["source"]) for c in ref))
    assert len(ref_mats) == 2
    assert ns["engine"].materials[1:] == [
        eval(m, {"PBRMaterial": PBRMaterial}) for m in ref_mats]
    assert len(ns["frames"]) == 2
    written = [p for p in os.listdir(tmp_path) if p.startswith("orbit")]
    assert written and "wrote" in log.getvalue()

    ns = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="DEVICE = 'cpu'"):
        for cell in cells[:2]:
            exec(compile("".join(cell["source"]), NOTEBOOK, "exec"), ns)
            ns["ASSET"] = ckpt


def test_parity_probe_on_cpu(capsys, monkeypatch):
    probe = _load("parity_probe_torch", "tools/parity_probe_torch.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        probe.main([])
    rows = probe.main(["--device", "cpu", "--side", "24", "--n", "500"])
    assert set(rows) == {"exact_kill", "nokill_eps"}
    for name, r in rows.items():
        assert r["bulk"] >= 80.0 and r["flips"] <= 0.01, (name, r)
        assert r["max_err"] < 1e-3
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in out] == ["exact_kill", "nokill_eps"]
    assert all("psnr=" in ln and "bulk=" in ln and "max|e|=" in ln
               and "flips=" in ln for ln in out)


def test_parity_fixture_generator_is_byte_equal(tmp_path):
    gen = _load("gen_parity_fixture_torch",
                "scripts/gen_parity_fixture_torch.py")
    out = str(tmp_path / "sub" / "parity_cloud.ply")
    assert gen.main([out]) == 0
    with open(out, "rb") as a, open(os.path.join(
            REPO, "tests", "fixtures", "parity_cloud.ply"), "rb") as b:
        assert a.read() == b.read()


def test_eval_fps_save_frame_round_trips_compare_frames(tmp_path, capsys,
                                                        monkeypatch):
    import eval_fps_torch

    frames = {}
    for tag, extra in (("a", []), ("b", []),
                       ("grt", ["--config-name",
                                "apps/nerf_synthetic_3dgrt"])):
        path = str(tmp_path / f"{tag}.npz")
        assert eval_fps_torch.main(
            ["--synthetic", "300", "--device", "cpu", "--width", "16",
             "--height", "16", "--batch", "1", "--reps", "1",
             "--save-frame", path] + extra) == 0
        frames[tag] = path
    with np.load(frames["a"]) as f:
        assert f["frame"].dtype == np.float32
        assert f["frame"].shape == (16, 16, 3)
        assert str(f["mode"]) == "3dgut"
    with np.load(frames["grt"]) as f:
        assert str(f["mode"]) == "3dgrt"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        eval_fps_torch.main(["--synthetic", "300"])
    capsys.readouterr()

    def compare(a, b):
        return subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "compare_frames.py"),
             a, b], capture_output=True, text=True, check=True).stdout

    same = compare(frames["a"], frames["b"])
    assert same.startswith("3dgut vs 3dgut: mse=0.000e+00 psnr=inf dB")
    other = compare(frames["a"], frames["grt"])
    assert other.startswith("3dgut vs 3dgrt:") and "psnr=inf" not in other


def test_convert_ckpt_nht_initialises_the_port_nht_model(tmp_path, capsys):
    """tools/convert_ckpt_nht.py on a port GS checkpoint: the port's
    apps/nerf_synthetic_3dgut_mcmc_nht model built from it by
    initialization.method=checkpoint equals JAX's state_from_checkpoint,
    and train_torch.py trains two steps from it; its log gives
    scripts/conv_table.py a table."""
    from test_torch_trainer import _write_nerf_dataset
    from threedgrut_tpu.models.gaussians import GaussianModelConfig as JCfg
    from threedgrut_tpu.models.gaussians import state_from_checkpoint
    from threedgrut_tpu_torch.config.loader import load_config

    import train_torch

    src, dst = str(tmp_path / "gs.npz"), str(tmp_path / "nht.npz")
    _small_checkpoint(src, n=200, seed=4)
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "convert_ckpt_nht.py"),
                    src, dst], check=True, capture_output=True)
    data = str(tmp_path / "data")
    _write_nerf_dataset(data)
    init = ["initialization.method=checkpoint", f"initialization.path={dst}"]
    conf = load_config("apps/nerf_synthetic_3dgut_mcmc_nht",
                       overrides=[f"path={data}"] + init)
    model = train_torch.make_model(conf, None, torch.device("cpu"))
    ref = state_from_checkpoint(dst, JCfg(feature_type="nht",
                                          nht_feature_dim=48))
    assert model.config.feature_type == "nht"
    assert model.n_active == int(ref.n_active) == 200
    for k in ("positions", "rotation", "scale", "density", "features"):
        np.testing.assert_array_equal(_np(getattr(model, k)),
                                      np.asarray(getattr(ref.params, k)), k)

    out = str(tmp_path / "runs")
    capsys.readouterr()
    train_torch.main(["--config-name", "apps/nerf_synthetic_3dgut_mcmc_nht",
                      "--device", "cpu", f"path={data}", "n_iterations=2",
                      "log_frequency=0.01", "val_frequency=1",
                      f"out_dir={out}", "experiment_name=nht"] + init)
    log_text = capsys.readouterr().out
    with open(os.path.join(out, "nht", "final_metrics.json")) as f:
        assert json.load(f)["n_iterations"] == 2
    assert "step 2:" in log_text and "val:" in log_text
    log = tmp_path / "train.log"
    log.write_text(log_text)
    rows = _table_rows(_conv_table(str(log)))
    assert [r[0] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r[1])) for r in rows)   # val PSNR parsed
    assert np.isfinite(float(rows[1][4])) and float(rows[1][4]) > 0


def _conv_table(path):
    mod = _load("conv_table", "scripts/conv_table.py")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(path)
    return buf.getvalue()


def _table_rows(text):
    return [[c.strip() for c in ln.strip("|").split("|")]
            for ln in text.splitlines()
            if ln.startswith("| ") and not ln.startswith("| iter")]


class _FakeTrainer:
    """The state that the trainers' run_training reads: a step that takes
    STEP_S seconds of a fake clock, from a checkpoint's step."""
    STEP_S = 0.25

    def __init__(self, clock, start_step):
        self.clock = clock
        self.global_step = start_step
        self.conf = types.SimpleNamespace(seed=0, n_iterations=10_000)
        self.dataset = list(range(5))
        self.model = types.SimpleNamespace(n_active=1234)
        self.train_wall_time = 0.0
        self.metrics_history = []

    def train_iteration(self, batch, gt_dev=None, frame_idx=None):
        self.clock[0] += self.STEP_S
        self.global_step += 1
        return {"total": 0.1, "psnr": 20.0 + 0.01 * self.global_step}

    # JAX's trainer only
    def _gt_cache(self):
        return False

    def _flush_event_stats(self):
        pass


def test_conv_table_reads_the_port_log_as_jax_log(tmp_path, monkeypatch):
    """Both trainers' run_training, driven as their CLIs drive it (one call
    per logged window of 4 steps, a val line after each), from a
    checkpoint's step 100 on one fake clock: conv_table.py gives the same
    table from both logs, each window at the true rate of 4 it/s. The port
    once printed its window's own rate, which conv_table misread."""
    from threedgrut_tpu.train import trainer as j_trainer
    from threedgrut_tpu_torch.train import trainer as t_trainer

    tables = []
    for mod, kw in ((j_trainer, {"group_steps": False}), (t_trainer, {})):
        clock = [1000.0]
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: clock[0]))
        fake = _FakeTrainer(clock, start_step=100)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            for _ in range(3):
                mod.Trainer.run_training(fake, fake.global_step + 4,
                                         log_every=4, **kw)
                print("val:", {"psnr": 20.0 + fake.global_step / 100,
                               "ssim": 0.5, "n_views": 2})
        path = tmp_path / f"{mod.__name__}.log"
        path.write_text(buf.getvalue())
        tables.append(_conv_table(str(path)))
    assert tables[0] == tables[1]
    rows = _table_rows(tables[1])
    assert [r[0] for r in rows] == ["104", "108", "112"]
    assert [r[4] for r in rows] == ["nan", "4.0", "4.0"]
    assert "window rates: median 4.0 it/s" in tables[1]

