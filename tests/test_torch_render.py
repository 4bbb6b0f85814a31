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

import json
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
    or PIL; its CLIs without JAX; and every module of the port loads without JAX and without
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
            "import train_torch, render_torch, validate_torch; "
            "bad += [m for m in sys.modules if m in ('jax', 'flax', 'optax') or "
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
            "threedgrut_tpu_torch.ops.cuda.fill",
            "threedgrut_tpu_torch.export.sh_bake",
            "threedgrut_tpu_torch.export.nurec",
            "threedgrut_tpu_torch.data.ncore",
            "threedgrut_tpu_torch.playground.denoise",
            "threedgrut_tpu_torch.playground.denoise_cnn",
            "threedgrut_tpu_torch.playground.video",
            "threedgrut_tpu_torch.playground.live_gui",
            "threedgrut_tpu_torch.parallel.comm",
            "threedgrut_tpu_torch.parallel.dp",
            "threedgrut_tpu_torch.parallel.particle",
            "threedgrut_tpu_torch.parallel.launch",
            "threedgrut_tpu_torch.parallel.dryrun",
            "threedgrut_tpu_torch.utils.timer",
            "threedgrut_tpu_torch.utils.exif",
            "threedgrut_tpu_torch.utils.logger",
            "threedgrut_tpu_torch.models.geometry"} <= set(_port_modules())


# JAX modules with no counterpart in the port, each with its reason
NOT_PORTED = {
    # the port decodes with PIL: the card's machine has no libjpeg.so.62
    # for native/libdataio.so (ROADMAP.md, known JAX faults)
    "data/native_loader.py": "PIL decodes",
    # the Pallas kernels: served by ops/cuda/ and the CUDA sources in
    # csrc/ (PERF.md, the table of TPU kernels)
    "ops/pallas/*": "ops/cuda/ and csrc/",
}


def _package_files(pkg):
    root = os.path.join(REPO, pkg)
    return {os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
            for d, _, files in os.walk(root) for f in files
            if f.endswith(".py")}


def test_port_covers_every_jax_module():
    """Every module of threedgrut_tpu has its counterpart at the same
    path in threedgrut_tpu_torch, but for NOT_PORTED's two entries."""
    import fnmatch

    jax_files = _package_files("threedgrut_tpu")
    port_files = _package_files("threedgrut_tpu_torch")
    missing = jax_files - port_files
    allowed = {f for f in missing
               if any(fnmatch.fnmatch(f, pat) for pat in NOT_PORTED)}
    assert missing == allowed, sorted(missing - allowed)
    # the allow-list holds nothing the port has covered since
    for pat in NOT_PORTED:
        assert any(fnmatch.fnmatch(f, pat) for f in missing), pat
    assert {"parallel/dp.py", "parallel/particle.py", "utils/timer.py",
            "utils/exif.py", "utils/logger.py",
            "models/geometry.py"} <= port_files


# entry points of the JAX system with no _torch counterpart, each with its
# reason
ENTRY_POINTS_NOT_PORTED = {
    # numpy only, and tested on the port's outputs
    # (tests/test_torch_entry_points.py)
    "scripts/conv_table.py": "numpy only: parses the port's training log",
    "tools/compare_frames.py": "numpy only: compares eval_fps_torch.py "
                               "--save-frame files",
    "tools/convert_ckpt_nht.py": "numpy only: converts the port's "
                                 "checkpoints",
    # censuses of the TPU's layout (lanes, sublanes, MXU terms)
    "tools/measure_lanes.py": "a TPU-layout census",
    "tools/term_analysis.py": "a TPU-layout census",
    # the JAX benchmark: the port gets a benchmark of its own
    "bench.py": "the JAX benchmark; the port's own comes apart",
    # the TPU entry points (a single-chip forward, the multi-chip dry run,
    # whose cases parallel/dryrun.py runs on the port)
    "__graft_entry__.py": "TPU entry points; parallel/dryrun.py ports "
                          "the dry run",
}
# the port's own entry points, which stand for no JAX file
PORT_ONLY = {"chip_smoke.py"}


def entry_points(repo=REPO):
    """The repository's entry points, relative to ``repo``: every .py at
    the root, in scripts/ (not scripts/benchmark/) and in tools/ (with
    tools/ppisp_export/), and every notebooks/*.ipynb."""
    found = set()
    for sub, ext in (("", ".py"), ("scripts", ".py"), ("tools", ".py"),
                     (os.path.join("tools", "ppisp_export"), ".py"),
                     ("notebooks", ".ipynb")):
        d = os.path.join(repo, sub)
        if os.path.isdir(d):
            found |= {os.path.join(sub, f).replace(os.sep, "/")
                      for f in os.listdir(d) if f.endswith(ext)
                      and os.path.isfile(os.path.join(d, f))}
    return found


def counterpart(path):
    stem, ext = os.path.splitext(path)
    return f"{stem}_torch{ext}"


def entry_points_without_counterpart(files):
    """The JAX system's entry points among ``files`` that have neither a
    ``_torch`` counterpart in ``files`` nor a place in
    ENTRY_POINTS_NOT_PORTED."""
    jax_side = {f for f in files if not os.path.splitext(f)[0].endswith(
        "_torch") and f not in PORT_ONLY}
    return {f for f in jax_side if counterpart(f) not in files
            and f not in ENTRY_POINTS_NOT_PORTED}


def test_port_covers_every_entry_point():
    """Every entry point of the JAX system (the root's, scripts/'s,
    tools/'s and the notebooks) has a ``_torch`` counterpart beside it,
    but for ENTRY_POINTS_NOT_PORTED, each with its reason; the allow-list
    holds nothing the port has covered since, nor a file that is gone.
    Removing a counterpart makes the check fail."""
    files = entry_points()
    assert not entry_points_without_counterpart(files), sorted(
        entry_points_without_counterpart(files))
    for f in ENTRY_POINTS_NOT_PORTED:
        assert f in files and counterpart(f) not in files, f
    assert {"scripts/train_denoiser_torch.py",
            "scripts/gen_parity_fixture_torch.py",
            "tools/parity_probe_torch.py",
            "notebooks/playground_headless_torch.ipynb",
            "train_torch.py", "scripts/eval_fps_torch.py",
            "tools/ppisp_export/bake_modes_benchmark_torch.py"} <= files
    assert "scripts/benchmark/profile_dataloader.py" not in files
    for gone in ("tools/parity_probe_torch.py",
                 "notebooks/playground_headless_torch.ipynb",
                 "render_torch.py"):
        assert entry_points_without_counterpart(files - {gone}) == {
            gone.replace("_torch", "")}, gone


# JAX and the libraries built on it, which the port's files never import
JAX_FAMILY = ("jax", "jaxlib", "flax", "optax")


def _imports_of_jax_package(path):
    """(line, module) of every import of threedgrut_tpu or a submodule
    of it, or of JAX or a library of JAX_FAMILY, in the file at ``path``
    (a notebook's code cells, joined), at any depth (lazy imports inside
    functions included); threedgrut_tpu_torch does not count."""
    import ast

    with open(path) as f:
        text = f.read()
    if path.endswith(".ipynb"):
        text = "\n".join("".join(c["source"]) for c in json.loads(text)[
            "cells"] if c["cell_type"] == "code")
    tree = ast.parse(text, path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        found += [(node.lineno, m) for m in mods
                  if m.split(".")[0] in ("threedgrut_tpu",) + JAX_FAMILY]
    return found


def test_port_sources_import_nothing_of_the_jax_package():
    """A static check of every .py under threedgrut_tpu_torch/, of
    train_torch.py, playground_torch.py, render_torch.py,
    validate_torch.py, chip_smoke.py, scripts/*_torch.py and
    tools/ppisp_export/*_torch.py: no import of threedgrut_tpu, JAX,
    flax or optax, lazy or not. The JAX package stays the reference; the
    port keeps its own copies of what it needs."""
    paths = [os.path.join(root, f) for root, _, files in os.walk(
        os.path.join(REPO, "threedgrut_tpu_torch")) for f in files
        if f.endswith(".py")]
    paths += [os.path.join(REPO, f) for f in ("train_torch.py",
                                              "playground_torch.py",
                                              "render_torch.py",
                                              "validate_torch.py",
                                              "chip_smoke.py")]
    scripts = os.path.join(REPO, "scripts")
    paths += [os.path.join(scripts, f) for f in sorted(os.listdir(scripts))
              if f.endswith("_torch.py")]
    for sub in ("tools", os.path.join("tools", "ppisp_export")):
        tools = os.path.join(REPO, sub)
        paths += [os.path.join(tools, f) for f in sorted(os.listdir(tools))
                  if f.endswith("_torch.py")]
    notebooks = os.path.join(REPO, "notebooks")
    paths += [os.path.join(notebooks, f) for f in sorted(os.listdir(
        notebooks)) if f.endswith("_torch.ipynb")]
    assert len(paths) > 30
    rel = {os.path.relpath(p, REPO) for p in paths}
    assert {os.path.join("threedgrut_tpu_torch", "strategy", "mcmc.py"),
            os.path.join("threedgrut_tpu_torch", "models", "nht_decoder.py"),
            os.path.join("threedgrut_tpu_torch", "models", "features.py"),
            os.path.join("scripts", "bench_train_torch.py"),
            os.path.join("threedgrut_tpu_torch", "playground", "engine.py"),
            os.path.join("threedgrut_tpu_torch", "ops", "cuda", "scatter.py"),
            os.path.join("threedgrut_tpu_torch", "ops", "cuda", "fill.py"),
            os.path.join("threedgrut_tpu_torch", "utils", "lpips.py"),
            os.path.join("scripts", "gen_synthetic_scene_torch.py"),
            "playground_torch.py", "render_torch.py",
            "validate_torch.py"} <= rel
    export = ("crate", "nurec", "partition", "sh_bake", "sh_rotation",
              "transcode", "transforms", "usd", "view_interpolation")
    assert {os.path.join("threedgrut_tpu_torch", "export", f"{m}.py")
            for m in export} <= rel
    assert {os.path.join("threedgrut_tpu_torch", *m.split("/")) + ".py"
            for m in ("data/ncore", "playground/denoise",
                      "playground/denoise_cnn", "playground/video",
                      "playground/live_gui", "parallel/comm",
                      "parallel/dp", "parallel/particle", "parallel/launch",
                      "parallel/dryrun", "utils/timer", "utils/exif",
                      "utils/logger", "models/geometry")} <= rel
    assert "chip_smoke.py" in rel
    assert {os.path.join("scripts", f"{s}_torch.py") for s in (
        "export_usd", "transcode", "ply_to_usd", "add_mesh_to_usdz",
        "sh_bake_validation", "filter_visibility")} <= rel
    assert os.path.join("tools", "ppisp_export",
                        "bake_modes_benchmark_torch.py") in rel
    assert {os.path.join("tools", "parity_probe_torch.py"),
            os.path.join("scripts", "train_denoiser_torch.py"),
            os.path.join("scripts", "gen_parity_fixture_torch.py"),
            os.path.join("notebooks",
                         "playground_headless_torch.ipynb")} <= rel
    bad = {os.path.relpath(p, REPO): _imports_of_jax_package(p)
           for p in paths}
    assert not {k: v for k, v in bad.items() if v}, bad
    # the check sees an import inside a function (train.py's lazy
    # ``from threedgrut_tpu.export.ply import import_model``)
    assert any(m == "threedgrut_tpu.export.ply" for _, m in
               _imports_of_jax_package(os.path.join(REPO, "train.py")))
    # and JAX's own family (the JAX bake's lazy ``import optax``)
    found = {m for _, m in _imports_of_jax_package(os.path.join(
        REPO, "threedgrut_tpu", "export", "sh_bake.py"))}
    assert {"jax", "jax.numpy", "optax"} <= found
    # and a notebook's code cells (the JAX notebook imports the package)
    assert any(m.startswith("threedgrut_tpu.playground") for _, m in
               _imports_of_jax_package(os.path.join(
                   REPO, "notebooks", "playground_headless.ipynb")))


if __name__ == "__main__":
    # regenerate the fixture: PYTHONPATH=. python tests/test_torch_render.py
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (JAX on the CPU, highest precision)
    np.savez_compressed(FIXTURE, **make_gut_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
