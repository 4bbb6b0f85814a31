"""3DGUT forward render of the PyTorch port against the JAX package.

CPU: ``render_gut`` with the exact kill (the JAX raster kernel in Pallas
interpret mode), n = 96 at 64x48, two seeds. Tolerances, with reasons:
  * features and opacity, max |diff| <= 1e-4: the JAX kernel evaluates
    the hit math and the transmittance scan as split-bf16 matmuls
    (ops/pallas/mxu.py, ~2^-17 relative per product), which leaves
    ~5e-5 against plain fp32 on these scenes;
  * depth, <= 1e-3 absolute on depths of a few world units (the same
    rounding, times the hit distance);
  * hit counts may flip on < 1% of pixels: a ~1e-7 difference at the
    min_response / min_alpha boundary adds or drops one contribution.

The kernels against their plain versions on the card:
tests/test_torch_gpu.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu.render.gut import render_gut as j_render_gut
from threedgrut_tpu.render.oracle import render_oracle as j_render_oracle
from threedgrut_tpu_torch.convert import model_from_state, save_checkpoint
from threedgrut_tpu_torch.models.gaussians import GaussianModel
from threedgrut_tpu_torch.ops import ut as t_ut
from threedgrut_tpu_torch.ops.cameras import orbit_camera
from threedgrut_tpu_torch.ops.cuda.expand import expand_decode_pairs
from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.render.gut import render_gut
from threedgrut_tpu_torch.render.oracle import parity_db, render_oracle
from threedgrut_tpu_torch.render.serve import make_serving_renderer
from torch_port_utils import torch_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_gut_small.npz")
RES = (64, 48)
J_RC = JRasterConfig(max_pairs=2048, grad_fold=False, exact_kill=True)
RC = RasterConfig()
UT = t_ut.UTConfig()
KEYS = ("pred_features", "pred_opacity", "pred_dist", "hits_count")


def assert_render_close(got, ref):
    """The render tolerances of this file (module docstring)."""
    np.testing.assert_allclose(got["pred_features"], ref["pred_features"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["pred_opacity"], ref["pred_opacity"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["pred_dist"], ref["pred_dist"],
                               atol=1e-3, rtol=0)
    flips = np.abs(np.asarray(got["hits_count"], np.int64)
                   - np.asarray(ref["hits_count"], np.int64)) > 0
    assert flips.mean() < 0.01


def _np(out):
    return {k: np.asarray(out[k].cpu() if isinstance(out[k], torch.Tensor)
                          else out[k], np.float32) for k in KEYS}


def make_gut_fixture(seed=0):
    """Scene inputs and JAX ``render_gut`` outputs of the small parity
    scene (tests/fixtures/torch_port_gut_small.npz)."""
    cam, state = make_test_scene(n=96, seed=seed, res=RES)
    out = j_render_gut(cam, JUTConfig(), J_RC, state, sh_degree=3,
                       interpret=True)
    data = {f"params/{k}": np.asarray(getattr(state.params, k))
            for k in ("positions", "rotation", "scale", "density",
                      "features_albedo", "features_specular")}
    data.update(
        n_active=np.int32(state.n_active),
        n_active_features=np.int32(state.n_active_features),
        density_activation=state.config.density_activation,
        scale_activation=state.config.scale_activation,
        resolution=np.asarray(cam.resolution, np.int32),
        focal=np.asarray(cam.focal), principal=np.asarray(cam.principal),
        t=np.asarray(cam.t_start), q=np.asarray(cam.q_start),
        sh_degree=np.int32(3), num_pairs=np.int32(out["num_pairs"]))
    data.update({k: np.asarray(out[k], np.float32) for k in KEYS})
    return data


@pytest.fixture(scope="module")
def scenes():
    """(jax cam, jax state, jax render) per seed."""
    res = {}
    for seed in (0, 1):
        cam, state = make_test_scene(n=96, seed=seed, res=RES)
        res[seed] = (cam, state, j_render_gut(
            cam, JUTConfig(), J_RC, state, sh_degree=3, interpret=True))
    return res


@pytest.mark.parametrize("seed", [0, 1])
def test_render_gut_matches_jax(scenes, seed):
    cam, state, ref = scenes[seed]
    tcam, model = torch_scene(cam, state)
    launches = (expand_decode_pairs.launches, rasterize_tiles.launches)
    with torch.no_grad():
        out = render_gut(tcam, UT, RC, model, sh_degree=3)
    assert_render_close(_np(out), ref)
    assert int(out["num_pairs"]) == int(ref["num_pairs"])
    assert int(out["pairs_overflow"]) == 0
    np.testing.assert_array_equal(out["mog_visibility"].numpy(),
                                  np.asarray(ref["mog_visibility"]))
    # on the CPU the wrappers run their plain versions, never a kernel
    assert (expand_decode_pairs.launches,
            rasterize_tiles.launches) == launches == (0, 0)


def test_render_requires_no_grad(scenes):
    """Serving needs no autograd: under no_grad the render builds no
    graph and gives the same values as the differentiable render."""
    cam, state, _ = scenes[0]
    tcam, model = torch_scene(cam, state)
    with torch.no_grad():
        plain = render_gut(tcam, UT, RC, model, sh_degree=3)
    graded = render_gut(tcam, UT, RC, model, sh_degree=3)
    assert all(plain[k].grad_fn is None for k in KEYS)
    assert graded["pred_features"].grad_fn is not None
    assert graded["hits_count"].grad_fn is None      # no gradient to hits
    for k in KEYS:
        torch.testing.assert_close(graded[k].detach(), plain[k], rtol=0,
                                   atol=0)


def test_oracle_matches_jax_oracle(scenes):
    """Oracle vs oracle: both composite in float32/float64 without any
    matmul emulation, so 1e-5 holds on features and opacity."""
    cam, state, _ = scenes[1]
    ref = j_render_oracle(cam, JUTConfig(), J_RC, state, sh_degree=3)
    tcam, model = torch_scene(cam, state)
    with torch.no_grad():
        got = render_oracle(tcam, UT, RC, model, sh_degree=3)
    for k in ("pred_features", "pred_opacity"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["pred_dist"].numpy(),
                               np.asarray(ref["pred_dist"]), atol=1e-4)
    flips = got["hits_count"].numpy() != np.asarray(ref["hits_count"])
    assert flips.mean() < 0.01
    # and the port's own render against its oracle, in the probe's terms
    with torch.no_grad():
        out = render_gut(tcam, UT, RC, model, sh_degree=3)
    bulk, _, flip = parity_db(out["pred_features"].numpy(),
                              got["pred_features"].numpy())
    assert bulk >= 80.0 and flip <= 0.01


def test_serve_batch_matches_per_view(scenes):
    _, state, _ = scenes[0]
    model = model_from_state(state)
    cams = [orbit_camera(az, 0.3, 4.0, center=(0.0, 0.0, 4.2),
                         resolution=RES) for az in (0.0, 0.4, -0.5)]
    bg = torch.tensor([0.2, 0.4, 0.6])
    serve = make_serving_renderer(model, RC, sh_degree=3, background=bg)
    imgs = serve(cams)
    assert imgs.shape == (3, RES[1], RES[0], 3)
    with torch.no_grad():
        for i, cam in enumerate(cams):
            out = render_gut(cam, UT, RC, model, sh_degree=3)
            ref = out["pred_features"] + bg * (1.0 - out["pred_opacity"])
            torch.testing.assert_close(imgs[i], ref, rtol=0, atol=0)
    assert float(imgs.std()) > 0.0


def test_serve_turns_normals_off(scenes, monkeypatch):
    """A served view never builds normals, as JAX's serving_raster_config
    trims them: render_gut gets the config with enable_normals False."""
    from threedgrut_tpu_torch.render import serve as serve_mod

    _, state, _ = scenes[0]
    model = model_from_state(state)
    seen = []

    def spy(cam, ut_cfg, raster_cfg, model, sh_degree):
        seen.append(raster_cfg)
        return render_gut(cam, ut_cfg, raster_cfg, model, sh_degree)

    monkeypatch.setattr(serve_mod, "render_gut", spy)
    cam = orbit_camera(0.0, 0.3, 4.0, center=(0.0, 0.0, 4.2),
                       resolution=RES)
    imgs = make_serving_renderer(model, RC.replace(enable_normals=True),
                                 sh_degree=3)([cam])
    assert imgs.shape == (1, RES[1], RES[0], 3)
    assert len(seen) == 1 and seen[0].enable_normals is False
    assert seen[0] == RC


def test_checkpoint_round_trip(scenes, tmp_path):
    cam, state, _ = scenes[0]
    tcam, model = torch_scene(cam, state)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(model, path)
    # the JAX package reads what the port wrote ...
    from threedgrut_tpu.models.gaussians import state_from_checkpoint
    back = state_from_checkpoint(path, state.config)
    for k in ("positions", "rotation", "scale", "density",
              "features_albedo", "features_specular"):
        np.testing.assert_array_equal(np.asarray(getattr(back.params, k)),
                                      np.asarray(getattr(state.params, k)))
    # ... and the port renders it the same
    loaded = GaussianModel.from_checkpoint(path, model.config, device="cpu")
    assert loaded.n_active == model.n_active
    with torch.no_grad():
        a = render_gut(tcam, UT, RC, model, sh_degree=3)
        b = render_gut(tcam, UT, RC, loaded, sh_degree=3)
    for k in KEYS:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_loaders_without_a_card_refuse_the_default_device(
        scenes, tmp_path, monkeypatch):
    """With no device given the loaders take the card; without one they
    raise naming device="cpu", and never load onto the CPU quietly."""
    cam, state, _ = scenes[0]
    _, model = torch_scene(cam, state)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(model, path)
    ply = os.path.join(os.path.dirname(__file__), "fixtures",
                       "parity_cloud.ply")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GaussianModel.from_checkpoint(path, model.config)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GaussianModel.from_ply(ply)
    assert GaussianModel.from_ply(ply, device="cpu").device.type == "cpu"


def test_max_pairs_cap_reports_overflow(scenes):
    cam, state, _ = scenes[0]
    tcam, model = torch_scene(cam, state)
    with torch.no_grad():
        out = render_gut(tcam, UT, RasterConfig(max_pairs=128), model, 3)
    assert int(out["pairs_overflow"]) > 0
    assert int(out["num_pairs"]) <= 128


def test_fixture_is_current():
    """The saved JAX values agree with a fresh JAX run within 1e-6, so
    the fixture the chip smoke test reads cannot drift."""
    fresh = make_gut_fixture()
    with np.load(FIXTURE) as saved:
        assert set(saved.files) == set(fresh)
        for k, v in fresh.items():
            if saved[k].dtype.kind in "fi":
                np.testing.assert_allclose(saved[k], v, atol=1e-6, rtol=0,
                                           err_msg=k)
            else:
                assert str(saved[k]) == str(v), k
    assert os.path.getsize(FIXTURE) < 200_000


def _port_modules():
    """Every module of threedgrut_tpu_torch, by dotted name."""
    pkg = os.path.join(REPO, "threedgrut_tpu_torch")
    names = []
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                names.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    return sorted(names)


def test_port_imports_no_jax():
    """The port, its serving path and its trainer load without JAX, yaml
    or PIL; and every module of the port loads without JAX and without
    any module of the JAX package (threedgrut_tpu). A subprocess: this
    process already imported jax through tests/conftest.py."""
    code = ("import sys, importlib; import threedgrut_tpu_torch.render.serve, "
            "threedgrut_tpu_torch.render.oracle, "
            "threedgrut_tpu_torch.convert, "
            "threedgrut_tpu_torch.ops.cuda.build, "
            "threedgrut_tpu_torch.train.trainer, "
            "threedgrut_tpu_torch.strategy.gs, "
            "threedgrut_tpu_torch.strategy.mcmc, "
            "threedgrut_tpu_torch.models.nht_decoder, "
            "threedgrut_tpu_torch.models.features, "
            "threedgrut_tpu_torch.synthetic; "
            "bad = [m for m in ('jax', 'flax', 'yaml', 'PIL') "
            "if m in sys.modules]; print(bad); "
            f"[importlib.import_module(m) for m in {_port_modules()!r}]; "
            "import train_torch; "
            "bad += [m for m in sys.modules if m in ('jax', 'flax') or "
            "m == 'threedgrut_tpu' or m.startswith('threedgrut_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(_port_modules()) > 30
    assert {"threedgrut_tpu_torch.strategy.mcmc",
            "threedgrut_tpu_torch.models.nht_decoder",
            "threedgrut_tpu_torch.models.features",
            "threedgrut_tpu_torch.ops.cuda.scatter",
            "threedgrut_tpu_torch.ops.cuda.fill"} <= set(_port_modules())


def _imports_of_jax_package(path):
    """(line, module) of every import of threedgrut_tpu or a submodule
    of it in the file at ``path``, at any depth (lazy imports inside
    functions included); threedgrut_tpu_torch does not count."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        found += [(node.lineno, m) for m in mods
                  if m == "threedgrut_tpu" or m.startswith("threedgrut_tpu.")]
    return found


def test_port_sources_import_nothing_of_the_jax_package():
    """A static check of every .py under threedgrut_tpu_torch/, of
    train_torch.py, playground_torch.py, chip_smoke.py and
    scripts/*_torch.py: no import of threedgrut_tpu, lazy or not. The JAX
    package stays the reference; the port keeps its own copies of what
    it needs."""
    paths = [os.path.join(root, f) for root, _, files in os.walk(
        os.path.join(REPO, "threedgrut_tpu_torch")) for f in files
        if f.endswith(".py")]
    paths += [os.path.join(REPO, f) for f in ("train_torch.py",
                                              "playground_torch.py",
                                              "chip_smoke.py")]
    scripts = os.path.join(REPO, "scripts")
    paths += [os.path.join(scripts, f) for f in sorted(os.listdir(scripts))
              if f.endswith("_torch.py")]
    assert len(paths) > 30
    rel = {os.path.relpath(p, REPO) for p in paths}
    assert {os.path.join("threedgrut_tpu_torch", "strategy", "mcmc.py"),
            os.path.join("threedgrut_tpu_torch", "models", "nht_decoder.py"),
            os.path.join("threedgrut_tpu_torch", "models", "features.py"),
            os.path.join("scripts", "bench_train_torch.py"),
            os.path.join("threedgrut_tpu_torch", "playground", "engine.py"),
            os.path.join("threedgrut_tpu_torch", "ops", "cuda", "scatter.py"),
            os.path.join("threedgrut_tpu_torch", "ops", "cuda", "fill.py"),
            "playground_torch.py"} <= rel
    bad = {os.path.relpath(p, REPO): _imports_of_jax_package(p)
           for p in paths}
    assert not {k: v for k, v in bad.items() if v}, bad
    # the check sees an import inside a function (train.py's lazy
    # ``from threedgrut_tpu.export.ply import import_model``)
    assert any(m == "threedgrut_tpu.export.ply" for _, m in
               _imports_of_jax_package(os.path.join(REPO, "train.py")))


if __name__ == "__main__":
    # regenerate the fixture: PYTHONPATH=. python tests/test_torch_render.py
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (JAX on the CPU, highest precision)
    np.savez_compressed(FIXTURE, **make_gut_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
