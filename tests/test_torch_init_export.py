"""The port's PLY export and import, its initialisations, gsplat's COLMAP
options and the cuSFM training CLI against the JAX package (CPU).

Tolerances, with reasons:
  * the PLY writer byte for byte, the readers and every initialisation
    equal (the same numpy arithmetic on the same bytes and draws), but
    the log-scales of kNN distances, which may differ in the last bit
    (XLA's and PyTorch's fp32 log round differently; 2.4e-7 relative, as
    tests/test_torch_strategy.py holds them);
  * gsplat-normalised poses within 1e-6: the float64 transform rounds
    to float32 in both; intrinsics, extent, points and the cached PNG
    files equal;
  * render_torch.py on the CLI's PPISP checkpoint within 1e-3 dB of
    render.py (the render differs by ~1e-5, tests/test_torch_eval.py).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import train as j_train  # noqa: E402
import train_torch  # noqa: E402
from test_torch_trainer import _write_nerf_dataset
from threedgrut_tpu.config.loader import load_config as j_load_config
from threedgrut_tpu.config.loader import to_trainer_config
from threedgrut_tpu.data.colmap import ColmapDataset as JColmapDataset
from threedgrut_tpu.export import ply as j_ply
from threedgrut_tpu.models.gaussians import (GaussianModelConfig as JCfg,
                                             initialize_from_points)
from threedgrut_tpu.train.trainer import Trainer as JTrainer
from threedgrut_tpu_torch.config.loader import load_config
from threedgrut_tpu_torch.convert import model_from_state, save_checkpoint
from threedgrut_tpu_torch.data.colmap import ColmapDataset
from threedgrut_tpu_torch.export import ply as t_ply
from threedgrut_tpu_torch.models.gaussians import param_names

# an odd size: the factor-2 cache rounds 23.5 and 17.5 up, past the
# floor-divided 23 and 17, so the intrinsics are corrected
RES = (47, 35)


def write_capture(path, n_views=9, n_points=300):
    """A pinhole COLMAP capture of a 2,000-Gaussian teacher
    (synthetic.py:write_colmap_scene): ``n_views`` views, the teacher's
    points as sparse points; test split: views 0 and 8."""
    from threedgrut_tpu_torch.synthetic import (build_teacher,
                                                teacher_dataset,
                                                write_colmap_scene)

    teacher = build_teacher(2000, seed=0)
    ds = teacher_dataset(teacher, n_views=n_views, resolution=RES)
    write_colmap_scene(path, ds, teacher, n_points=n_points)
    return path


def write_point_cloud(path, xyz, rgb=None, rgb_type="uchar"):
    """A plain point-cloud PLY (x, y, z, normals, optional colours)."""
    fields = [(k, "f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
    if rgb is not None:
        fields += [(k, "u1" if rgb_type == "uchar" else "f4")
                   for k in ("red", "green", "blue")]
    arr = np.zeros(len(xyz), fields)
    arr["x"], arr["y"], arr["z"] = xyz.T
    arr["nz"] = 1.0
    if rgb is not None:
        arr["red"], arr["green"], arr["blue"] = rgb.T
    names = {"f4": "float", "u1": "uchar"}
    header = (["ply", "format binary_little_endian 1.0",
               f"element vertex {len(xyz)}"]
              + [f"property {names[t]} {k}" for k, t in fields]
              + ["end_header"])
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(arr.tobytes())
    return path


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """A COLMAP capture, a NeRF capture, a fused cloud from the COLMAP
    capture's points (uchar colours) and a checkpoint of a random
    model."""
    root = tmp_path_factory.mktemp("init")
    colmap = write_capture(str(root / "colmap"))
    nerf = str(root / "nerf")
    _write_nerf_dataset(nerf, side=32)
    pts, rgb, _ = ColmapDataset(colmap).load_points3d()
    fused = write_point_cloud(str(root / "fused.ply"), pts, rgb)
    rng = np.random.default_rng(0)
    state = initialize_from_points(
        JCfg(max_sh_degree=3), rng.uniform(-1, 1, (200, 3)).astype(
            np.float32), capacity=512)
    ckpt = str(root / "ckpt.npz")
    save_checkpoint(model_from_state(state), ckpt)
    return dict(root=root, colmap=colmap, nerf=nerf, fused=fused,
                ckpt=ckpt)


def _random_state(n=100, capacity=256, seed=1):
    """A JAX state with non-zero parameters in every leaf."""
    rng = np.random.default_rng(seed)
    state = initialize_from_points(
        JCfg(max_sh_degree=3), rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        capacity=capacity)
    spec = rng.normal(size=np.shape(state.params.features_specular))
    return state.replace(params=state.params.replace(
        features_specular=spec.astype(np.float32)))


def test_export_ply_matches_jax_bytes(tmp_path):
    """export_ply and export_model write JAX's file byte for byte, and
    import_ply reads both packages' files to the same arrays."""
    state = _random_state()
    ref, got = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    j_ply.export_model(state, ref)
    t_ply.export_model(model_from_state(state), got)
    with open(ref, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    p = {k: np.asarray(getattr(state.params, k))[:50] for k in
         ("positions", "rotation", "scale", "density", "features_albedo",
          "features_specular")}
    j_ply.export_ply(ref, **p)
    t_ply.export_ply(got, **p)
    with open(ref, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    for path in (got, os.path.join(REPO, "tests", "fixtures",
                                   "parity_cloud.ply")):
        a, b = t_ply.import_ply(path), j_ply.import_ply(path)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("colors", ["uchar", "float", "none"])
def test_read_point_cloud_ply_matches_jax(tmp_path, colors):
    """uchar colours (scaled to [0, 1]), float colours (kept) and none
    (mid-grey)."""
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(64, 3)).astype(np.float32)
    rgb = {"uchar": rng.integers(0, 256, (64, 3)).astype(np.uint8),
           "float": rng.uniform(0, 1, (64, 3)).astype(np.float32),
           "none": None}[colors]
    path = write_point_cloud(str(tmp_path / "c.ply"), xyz, rgb, colors)
    got, ref = t_ply.read_point_cloud_ply(path), \
        j_ply.read_point_cloud_ply(path)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if colors == "none":
        assert (got[1] == 0.5).all()


# (config, overrides, capture) of each make_model case; colmap_on_nerf
# and point_cloud_on_colmap ask for points the dataset cannot serve and
# fall through to random initialisation, as in train.py
MAKE_MODEL = {
    "import_ply": ("apps/nerf_synthetic_3dgut", [
        "import_ply.enabled=true",
        "import_ply.path=" + os.path.join(REPO, "tests", "fixtures",
                                          "parity_cloud.ply")], "nerf"),
    "fused_point_cloud": ("apps/cusfm_3dgut_mcmc", [
        "strategy.add.max_n_gaussians=1000"], "colmap"),
    "fused_point_cloud_gs": ("apps/cusfm_3dgut", [], "colmap"),
    "checkpoint": ("apps/colmap_3dgut", ["initialization.method=checkpoint"],
                   "colmap"),
    "colmap_on_nerf": ("apps/nerf_synthetic_3dgut", [
        "initialization.method=colmap", "initialization.num_gaussians=500"],
        "nerf"),
    "point_cloud_on_colmap": ("apps/colmap_3dgut", [
        "initialization.method=point_cloud",
        "initialization.num_gaussians=500"], "colmap"),
}


@pytest.mark.parametrize("case", sorted(MAKE_MODEL))
def test_make_model_matches_jax(captures, case):
    """train_torch.make_model against train.make_model: every parameter
    array, n_active, the capacity and the SH degree, in each branch of
    JAX's dispatch; a PLY import pads to default_capacity_for(n) and a
    checkpoint keeps its own capacity."""
    name, overrides, kind = MAKE_MODEL[case]
    overrides = [f"path={captures[kind]}", *overrides,
                 f"initialization.fused_point_cloud_path={captures['fused']}",
                 f"initialization.path={captures['ckpt']}"]
    conf = load_config(name, overrides=overrides)
    conf_j = j_load_config(name, overrides=overrides)
    ds = train_torch.make_dataset(conf, "train")
    got = train_torch.make_model(conf, ds, "cpu")
    ref = j_train.make_model(conf_j, j_train.make_dataset(conf_j, "train"))
    assert got.n_active == int(ref.n_active)
    assert got.capacity == ref.capacity
    assert got.n_active_features == int(ref.n_active_features)
    assert got.config.max_sh_degree == ref.config.max_sh_degree
    for k in param_names(got.config.feature_type):
        a, b = getattr(got, k).detach().numpy(), np.asarray(
            getattr(ref.params, k))
        if k == "scale" and case.startswith("fused"):
            np.testing.assert_allclose(a, b, rtol=2.4e-7, atol=0)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    expect = {"import_ply": (512, 512), "checkpoint": (200, 512),
              "fused_point_cloud": (300, 1024),
              "fused_point_cloud_gs": (300, 1280),
              "colmap_on_nerf": (500, 2048),
              "point_cloud_on_colmap": (500, 2048)}[case]
    assert (got.n_active, got.capacity) == expect


@pytest.mark.parametrize("option", ["gsplat_normalize",
                                    "gsplat_image_downscale"])
def test_gsplat_colmap_matches_jax(captures, option, tmp_path):
    """gsplat_normalize moves the poses, the points and the extent into
    the normalised world of each split's cameras; gsplat_image_downscale
    at factor 2 builds the bicubic images_2_png cache inside the capture
    (each package its own copy) and corrects the intrinsics."""
    if option == "gsplat_normalize":
        path_p = path_j = captures["colmap"]
        kw = dict(gsplat_normalize=True)
    else:
        path_p = write_capture(str(tmp_path / "port"))
        path_j = write_capture(str(tmp_path / "jax"))
        kw = dict(downsample=2, gsplat_image_downscale=True)
    for split in ("train", "test"):
        got = ColmapDataset(path_p, split, **kw)
        ref = JColmapDataset(path_j, split, **kw)
        plain = ColmapDataset(path_p, split)
        assert len(got) == len(ref) > 0
        np.testing.assert_allclose(got.get_poses(), ref.get_poses(),
                                   atol=1e-6, rtol=0)
        assert got.get_scene_extent() == ref.get_scene_extent()
        for a, b in zip(got.load_points3d(), ref.load_points3d()):
            np.testing.assert_array_equal(a, b)
        for i in range(len(got)):
            g, r = got[i], ref[i]
            np.testing.assert_array_equal(g.rgb_gt, r.rgb_gt)
            assert g.intrinsics == r.intrinsics
            assert g.rgb_gt.shape[:2] == r.rgb_gt.shape[:2]
        if option == "gsplat_normalize":
            assert not np.allclose(got.get_poses(), plain.get_poses())
            np.testing.assert_array_equal(got.world_transform,
                                          ref.world_transform)
        else:
            assert got[0].rgb_gt.shape[:2] == (18, 24)
            assert got[0].intrinsics[0] == pytest.approx(
                plain[0].intrinsics[0] / 2 * 24 / 23)
    if option == "gsplat_image_downscale":
        names = sorted(os.listdir(os.path.join(path_j, "images_2_png")))
        assert names == sorted(os.listdir(os.path.join(path_p,
                                                       "images_2_png")))
        for n in names:
            with open(os.path.join(path_p, "images_2_png", n), "rb") as a, \
                    open(os.path.join(path_j, "images_2_png", n), "rb") as b:
                assert a.read() == b.read(), n


def test_train_cli_cusfm_mcmc_ppisp(captures, monkeypatch):
    """train_torch.py --config-name apps/cusfm_3dgut_mcmc on the CPU: 4
    steps from the fused cloud with PPISP, a 3-step distillation,
    export_ply: the checkpoint holds params/ppisp//* and loads into JAX's
    Trainer (composed as render.py composes it), the export holds the
    checkpoint's live particles, and render_torch.py scores it within
    1e-3 dB of render.py."""
    import jax

    import render as j_render
    import render_torch
    from threedgrut_tpu.render import gut as j_gut

    root = captures["root"]
    out = str(root / "out")
    args = [f"path={captures['colmap']}",
            f"initialization.fused_point_cloud_path={captures['fused']}",
            "n_iterations=4", "post_processing.n_distillation_steps=3",
            "export_ply.enabled=true", "strategy.add.max_n_gaussians=512",
            f"out_dir={out}", "experiment_name=cusfm", "log_frequency=0.02"]
    train_torch.main(["--config-name", "apps/cusfm_3dgut_mcmc", "--device",
                      "cpu", *args])
    run = os.path.join(out, "cusfm")
    ckpt = os.path.join(run, "ckpt_last.npz")
    with np.load(ckpt) as f:
        files = set(f.files)
        isp = {k: f[k] for k in f.files if k.startswith("params/ppisp//")}
        live = {k: f[f"params/{k}"][:int(f["n_active"])]
                for k in ("positions", "density", "features_specular")}
    assert {k.split("//")[1] for k in isp} == {
        "exposure", "color_latents", "responsivity", "vig_center",
        "vig_alpha", "crf"}
    assert {f"opt/m/ppisp//exposure", "opt/v/ppisp//crf"} <= files
    assert isp["params/ppisp//exposure"].shape == (7,)   # 7 train frames
    conf_j = j_load_config("apps/cusfm_3dgut_mcmc", overrides=args)
    ds_j = j_train.make_dataset(conf_j, "train")
    jt = JTrainer(to_trainer_config(conf_j), ds_j,
                  j_train.make_model(conf_j, ds_j))
    jt.load_checkpoint(ckpt)
    for k, v in isp.items():
        np.testing.assert_array_equal(
            np.asarray(jt.ppisp_params[k.split("//")[1]]), v)
    exported = t_ply.import_ply(os.path.join(run, "export_last.ply"))
    for k, v in live.items():
        np.testing.assert_array_equal(exported[k], v, err_msg=k)
    with open(os.path.join(run, "final_metrics.json")) as f:
        assert np.isfinite(json.load(f)["psnr"])

    argv = ["--checkpoint", ckpt, "--path", captures["colmap"]]
    got = render_torch.main([*argv, "--out-dir", str(root / "eval_port"),
                             "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["render.py", *argv, "--out-dir",
                                      str(root / "eval_jax")])
    # render.py renders each view eagerly, ~15 s of interpret-mode
    # dispatch on the CPU; the same function jitted
    monkeypatch.setattr(j_gut, "render_gut", jax.jit(
        j_gut.render_gut, static_argnums=(1, 2, 4)))
    j_render.main()
    with open(os.path.join(str(root / "eval_jax"), "metrics.json")) as f:
        ref = json.load(f)
    assert len(got["per_frame"]) == len(ref["per_frame"]) == 2
    for g, r in zip(got["per_frame"], ref["per_frame"]):
        assert g["psnr"] == pytest.approx(r["psnr"], abs=1e-3)
    assert torch.tensor(0.0).device.type == "cpu"
