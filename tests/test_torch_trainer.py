"""The PyTorch port's Trainer against the JAX package's, and the port's
training CLI.

CPU. Both trainers start from the same initialisation and train 3 steps
on the same 48x32 views (test_training.py's synthetic scene: GT from the
JAX oracle), white background, exact kill, the JAX pair budget pinned.
The GS events fire inside the 3 steps with deterministic outcomes (clone
only: split needs random normals). Tolerances, with reasons:
  * loss of every step within 1e-4 relative (the render agrees to ~1e-5,
    tests/test_torch_train_render.py);
  * parameters after 3 steps within 1e-4: Adam's first steps move each
    element by ~lr * g / |g|, which turns the ~1e-5 relative gradient
    differences of the smallest gradients into ~1e-5 absolute ones
    (densities, lr 0.05); the initial scales are made anisotropic, or
    the rotation gradient is rounding noise that Adam amplifies to
    +-lr steps of random sign on either side;
  * n_active, the GS event counts, the gradient buffers' counts and the
    optimizer step equal.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from threedgrut_tpu.data.protocols import Batch
from threedgrut_tpu.models import background as j_bg
from threedgrut_tpu.models.gaussians import (GaussianModelConfig as JCfg,
                                             initialize_from_points,
                                             state_from_checkpoint)
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu.render.oracle import render_oracle
from threedgrut_tpu.train import trainer as j_tr
from threedgrut_tpu_torch.convert import model_from_state
from threedgrut_tpu_torch.models.background import BackgroundConfig
from threedgrut_tpu_torch.models.gaussians import PARAM_NAMES
from threedgrut_tpu_torch.train import trainer as t_tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (48, 32)
STEPS = 3


class Views:
    """test_training.py's SyntheticDataset: oracle renders of a hidden
    scene from jittered cameras, as JAX Batches (numpy fields, which
    both trainers read)."""

    def __init__(self, n_views=STEPS, seed=0):
        cam0, gt_model = make_test_scene(n=64, seed=seed, res=RES)
        rng = np.random.default_rng(seed)
        ut, rc = JUTConfig(), JRasterConfig(max_pairs=1 << 13)
        render = jax.jit(lambda cam: render_oracle(cam, ut, rc, gt_model,
                                                   sh_degree=2))
        self.batches = []
        w, h = RES
        for v in range(n_views):
            t = np.zeros(3, np.float32)
            t[:2] = rng.uniform(-0.3, 0.3, 2)
            cam = cam0.replace(t_start=jnp.asarray(t), t_end=jnp.asarray(t))
            out = render(cam)
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, 3] = -t
            self.batches.append(Batch(
                rays_ori=np.zeros((h, w, 3), np.float32),
                rays_dir=np.zeros((h, w, 3), np.float32), T_to_world=c2w,
                rgb_gt=np.asarray(jnp.clip(out["pred_features"], 0, 1)),
                intrinsics=[0.9 * w, 0.9 * w, w / 2, h / 2], frame_idx=v))

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return self.batches[i]

    def get_scene_extent(self):
        return 3.0

    def get_poses(self):
        return np.stack([b.T_to_world for b in self.batches])


GS_EVENTS = dict(densify_start=1, densify_frequency=2, densify_end=100,
                 clone_grad_threshold=1e-7, split_grad_threshold=1e9,
                 relative_size_threshold=10.0, prune_start=1,
                 prune_frequency=3, prune_end=100,
                 prune_density_threshold=0.099, reset_density_frequency=0)


def _init_state():
    """test_training.py's init, made anisotropic: the kNN scales are
    isotropic, which leaves the rotation gradient at rounding noise, and
    Adam turns noise into full +-lr steps of either sign."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.2, 1.2, (96, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(3.0, 5.5, 96)
    state = initialize_from_points(JCfg(max_sh_degree=2), pts, capacity=256)
    scale = np.asarray(state.params.scale).copy()
    scale[:96] += rng.normal(0.0, 0.4, (96, 3)).astype(np.float32)
    return state.replace(params=state.params.replace(
        scale=jnp.asarray(scale)))


def _trainers(views, post_processing=None):
    state = _init_state()
    j_conf = j_tr.TrainerConfig(
        raster=JRasterConfig(max_pairs=1 << 13, exact_kill=True),
        auto_max_pairs=False, init_n_features=0, max_n_features=2,
        increase_frequency=2,
        background=j_bg.BackgroundConfig(color="white"),
        post_processing=post_processing)
    j_conf.gs = j_conf.gs.replace(**GS_EVENTS)
    t_conf = t_tr.TrainerConfig(
        init_n_features=0, max_n_features=2, increase_frequency=2,
        background=BackgroundConfig(color="white"),
        post_processing=post_processing)
    t_conf.gs = t_conf.gs.replace(**GS_EVENTS)
    return (j_tr.Trainer(j_conf, views, state),
            t_tr.Trainer(t_conf, views, model_from_state(state)))


@pytest.fixture(scope="module")
def views():
    return Views()


def test_trainer_three_steps_match_jax(views):
    jt, tt = _trainers(views)
    for step in range(STEPS):
        batch = views[step % len(views)]
        jm = jt.train_iteration(batch)
        tm = tt.train_iteration(batch)
        np.testing.assert_allclose(tm["total"], float(jm["total"]),
                                   rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(tm["psnr"], float(jm["psnr"]), atol=1e-3)
    assert tt.global_step == jt.global_step == STEPS
    assert tt.opt_state.step == int(jt.opt_state.step)
    assert tt.n_active_features == jt.n_active_features == 1
    # the events fired and agree: a clone at step 2, a prune at step 3
    assert tt.model.n_active == int(jt.model.n_active)
    assert [k for _, k, _ in tt.event_stats] == ["densify", "pruned"]
    assert tt.event_stats[0][2]["n_cloned"] > 0
    assert tt.event_stats[1][2]["n_pruned"] > 0
    np.testing.assert_array_equal(
        tt.gs_buffers.grad_norm_denom.numpy(),
        np.asarray(jt.gs_buffers.grad_norm_denom))
    for k in PARAM_NAMES:
        np.testing.assert_allclose(getattr(tt.model, k).detach().numpy(),
                                   np.asarray(getattr(jt.model.params, k)),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_linear_to_srgb_step_matches_jax(views):
    """post_processing linear-to-srgb after the background, in the loss
    (JAX trainer.py:483-485) and in validation (:1264-1266): one step and
    one validated view against JAX's, at the three-step test's
    tolerances."""
    jt, tt = _trainers(views, post_processing="linear-to-srgb")
    batch = views[0]
    jm = jt.train_iteration(batch)
    tm = tt.train_iteration(batch)
    np.testing.assert_allclose(tm["total"], float(jm["total"]), rtol=1e-4)
    np.testing.assert_allclose(tm["psnr"], float(jm["psnr"]), atol=1e-3)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(getattr(tt.model, k).detach().numpy(),
                                   np.asarray(getattr(jt.model.params, k)),
                                   atol=1e-4, rtol=0, err_msg=k)
    one = Views.__new__(Views)
    one.batches = views.batches[1:2]
    got, ref = tt.validate(one), jt.validate(one)
    for k in ("psnr", "ssim"):
        assert got[k] == pytest.approx(ref[k], abs=1e-3), k
    plain = _trainers(views)[1].validate(one)
    assert abs(plain["psnr"] - got["psnr"]) > 0.1   # the transfer applies


def test_current_lrs_match_jax(views):
    jt, tt = _trainers(views)
    for step in (0, 1, 5000, 19800, 25000, 30000):
        ref = jt.current_lrs(step)
        got = tt.current_lrs(step)
        assert set(got) == set(ref)
        for k in got:
            assert got[k] == pytest.approx(ref[k], rel=1e-12), (step, k)


def test_checkpoints_load_across_packages(views, tmp_path):
    """A port checkpoint loads into the JAX trainer and back, with the
    same npz keys, and a resumed port step repeats the loss."""
    jt, tt = _trainers(views)
    for step in range(2):
        tt.train_iteration(views[step])
    path = str(tmp_path / "port.npz")
    tt.save_checkpoint(path)
    jt.load_checkpoint(path)
    assert jt.global_step == tt.global_step == 2
    assert int(jt.model.n_active) == tt.model.n_active
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(jt.model.params, k)),
                                      getattr(tt.model, k).detach().numpy())
        np.testing.assert_array_equal(np.asarray(jt.opt_state.exp_avg[k]),
                                      tt.opt_state.exp_avg[k].numpy())
    back = str(tmp_path / "jax.npz")
    jt.save_checkpoint(back)
    with np.load(path) as a, np.load(back) as b:
        assert set(a.files) == set(b.files)
    _, resumed = _trainers(views)
    resumed.load_checkpoint(back)
    loss_a = tt.train_iteration(views[2])["total"]
    loss_b = resumed.train_iteration(views[2])["total"]
    assert loss_a == loss_b


def _camera_batches(views):
    """The views' pinhole batches, and fisheye, FTheta (both reference
    polynomials) and rolling-shutter batches on the first view's pose."""
    b0 = views.batches[0]
    end = np.array(b0.T_to_world, np.float64)
    end[:3, 3] += [0.05, -0.02, 0.01]
    c, s = np.cos(0.01), np.sin(0.01)
    end[:3, :3] = end[:3, :3] @ np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def like(**kw):
        return Batch(rays_ori=b0.rays_ori, rays_dir=b0.rays_dir,
                     T_to_world=b0.T_to_world, intrinsics=b0.intrinsics,
                     **kw)

    fish = dict(fx=30.0, fy=31.0, cx=24.0, cy=16.0,
                radial=np.array([-0.03, -0.005, 0.001, -0.0002]),
                max_angle=np.pi / 2)
    out = list(views.batches[:2])
    out.append(like(intrinsics_OpenCVFisheyeCameraModelParameters=fish))
    for ref in (0, 1):
        out.append(like(intrinsics_FThetaCameraModelParameters=dict(
            cx=24.0, cy=16.0, angle_to_pixeldist=[0.0, 30.0, 0.0, -1.0],
            pixeldist_to_angle=[0.0, 1 / 30.0, 0.0, 1e-6],
            reference_poly=ref, linear_cde=(1.0, 0.001, -0.002),
            max_angle=1.2)))
    for shutter in ("rolling_top_to_bottom", "rolling_right_to_left"):
        out.append(like(T_to_world_end=end, shutter_type=shutter))
    out.append(like(T_to_world_end=end, shutter_type=shutter,
                    intrinsics_OpenCVFisheyeCameraModelParameters=fish))
    return out


def test_camera_from_batch_matches_jax(views):
    """Pinhole, fisheye, FTheta and rolling-shutter batches give the JAX
    trainer's camera, field for field."""
    from torch_port_utils import CAMERA_TENSORS

    for b in _camera_batches(views):
        jc = j_tr.camera_from_batch(b, JUTConfig())
        tc = t_tr.camera_from_batch(b)
        for k in ("resolution", "model_type", "shutter_type",
                  "ftheta_reference_poly"):
            assert getattr(tc, k) == getattr(jc, k), k
        for k in CAMERA_TENSORS:
            np.testing.assert_allclose(getattr(tc, k).numpy(),
                                       np.asarray(getattr(jc, k)),
                                       atol=1e-7, err_msg=k)


def test_validate_matches_jax(views):
    """PSNR, SSIM and hit statistics of the validation pass on one view
    (the JAX one adds LPIPS only where VGG weights are installed)."""
    jt, tt = _trainers(views)
    one = Views.__new__(Views)
    one.batches = views.batches[:1]
    ref = jt.validate(one)
    got = tt.validate(one)
    assert got["n_views"] == ref["n_views"] == 1
    for k in ("psnr", "psnr_best", "psnr_worst"):
        assert got[k] == pytest.approx(ref[k], abs=1e-3), k
    for k in ("ssim", "hits_mean", "hits_std", "hits_min", "hits_max"):
        assert got[k] == pytest.approx(ref[k], abs=1e-3), k


def test_selective_adam_keeps_invisible_rows(views):
    """optimizer.type selective_adam: rows the view does not see (here
    the capacity's dead rows and particles behind the camera) keep their
    parameters and moments."""
    conf = t_tr.TrainerConfig(optimizer=t_tr.OptimizerConfig(
        type="selective_adam"), background=BackgroundConfig(color="white"))
    state = _init_state()
    model = model_from_state(state)
    with torch.no_grad():
        model.positions[:8, 2] = -5.0          # behind the camera
    before = model.positions.detach().clone()
    tt = t_tr.Trainer(conf, views, model)
    m = tt.train_iteration(views[0])
    assert np.isfinite(m["total"])
    after = model.positions.detach()
    torch.testing.assert_close(after[:8], before[:8], rtol=0, atol=0)
    assert float(tt.opt_state.exp_avg["positions"][:8].abs().max()) == 0.0
    assert not torch.equal(after[8:96], before[8:96])


def test_trainer_prunes_by_weight_like_jax(views):
    """Weight pruning is no longer refused now that the telemetry kernel
    (kernel E) is ported: both trainers sample the blend weights every
    step and prune by them at step 2, beside the clone and the density
    prune, and agree on the rows kept and on the running max after."""
    jt, tt = _trainers(views)
    for tr in (jt, tt):
        tr.conf.gs = tr.conf.gs.replace(
            prune_weight_frequency=2, prune_weight_start=1,
            prune_weight_end=100, weight_telemetry_frequency=1,
            prune_weight_threshold=0.02)
    for step in range(STEPS):
        batch = views[step % len(views)]
        jt.train_iteration(batch)
        tt.train_iteration(batch)
        assert tt.model.n_active == int(jt.model.n_active), step
    kinds = [k for _, k, _ in tt.event_stats]
    assert kinds == ["densify", "weight-pruned", "pruned"]
    assert tt.event_stats[1][2]["n_pruned"] > 0
    np.testing.assert_allclose(tt.gs_weight_buf.numpy(),
                               np.asarray(jt.gs_weight_buf), atol=1e-4,
                               rtol=0)


def _write_nerf_dataset(root, side=48):
    """test_integration.py's tiny NeRF-synthetic dataset (a colored blob
    on a camera ring), written as PNG files."""
    from PIL import Image

    for split, n_frames in (("train", 6), ("val", 2)):
        frames = []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(n_frames):
            theta = 2 * np.pi * i / n_frames + (0.1 if split != "train"
                                                else 0.0)
            eye = np.array([4 * np.sin(theta), 0.5, 4 * np.cos(theta)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(np.array([0, 1.0, 0]), -fwd)
            right /= np.linalg.norm(right)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1] = right, np.cross(-fwd, right)
            c2w[:3, 2], c2w[:3, 3] = -fwd, eye
            ys, xs = np.meshgrid(np.linspace(-1, 1, side),
                                 np.linspace(-1, 1, side), indexing="ij")
            blob = np.clip(1.0 - np.sqrt(xs ** 2 + ys ** 2) * 1.5, 0, 1)
            img = np.zeros((side, side, 4), np.uint8)
            img[..., 0] = (blob * (128 + 100 * np.sin(theta))).astype(
                np.uint8)
            img[..., 1] = (blob * 180).astype(np.uint8)
            img[..., 2] = (blob * (128 + 100 * np.cos(theta))).astype(
                np.uint8)
            img[..., 3] = (blob > 0.05).astype(np.uint8) * 255
            name = f"{split}/r_{i}"
            Image.fromarray(img).save(os.path.join(root, f"{name}.png"))
            frames.append({"file_path": f"./{name}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)


def test_cli_decodes_with_pil_when_native_library_fails(monkeypatch,
                                                       tmp_path):
    """The port's NeRF loader decodes with PIL alone, so a prebuilt native
    decoder that cannot load (a missing libjpeg) cannot stop the CLI: it
    reads what the JAX loader reads through its PIL path."""
    from threedgrut_tpu.data import native_loader
    from threedgrut_tpu.data.nerf import NeRFDataset as JNeRFDataset
    from threedgrut_tpu_torch.data.nerf import NeRFDataset

    monkeypatch.setattr(native_loader, "_load_lib", lambda: None)
    _write_nerf_dataset(str(tmp_path))
    for split in ("train", "val"):
        ds = NeRFDataset(str(tmp_path), split, bg_color="white")
        ref = JNeRFDataset(str(tmp_path), split, bg_color="white")
        assert len(ds) == len(ref) and ds.focal == ref.focal
        np.testing.assert_array_equal(ds.get_poses(), ref.get_poses())
        for i in range(len(ds)):
            assert ds[i].rgb_gt.shape == (48, 48, 3)
            np.testing.assert_array_equal(ds[i].rgb_gt, ref[i].rgb_gt)
            np.testing.assert_array_equal(ds[i].rays_dir, ref[i].rays_dir)


def test_train_cli_runs_five_steps(tmp_path):
    data = str(tmp_path / "lego_mini")
    _write_nerf_dataset(data)
    out = str(tmp_path / "out")
    res = subprocess.run(
        [sys.executable, "train_torch.py", "--config-name",
         "apps/nerf_synthetic_3dgut", "--device", "cpu", f"path={data}",
         "n_iterations=5", "initialization.num_gaussians=300",
         f"out_dir={out}", "experiment_name=cli", "log_frequency=0.05"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "step 5:" in res.stdout
    ckpt = os.path.join(out, "cli", "ckpt_last.npz")
    with np.load(ckpt) as f:
        assert int(f["global_step"]) == 5
    # the JAX package reads the port's checkpoint
    state = state_from_checkpoint(ckpt)
    assert int(state.n_active) == 300
    with open(os.path.join(out, "cli", "final_metrics.json")) as f:
        final = json.load(f)
    assert final["n_iterations"] == 5 and np.isfinite(final["psnr"])
    assert torch.tensor(0.0).device.type == "cpu"


# keys train.py acts on that train_torch.py refuses while they ask for an
# action: (config, overrides, the key and train.py line it must name)
REFUSED = {
    "import_ply": ("apps/nerf_synthetic_3dgut",
                   ["import_ply.enabled=true"], "train.py:95-97"),
    "export_ply": ("apps/nerf_synthetic_3dgut",
                   ["export_ply.enabled=true"], "train.py:205-208"),
    "gsplat_normalize": ("apps/colmap_3dgut",
                         ["dataset.gsplat_normalize=true"], "train.py:32"),
    "gsplat_image_downscale": ("apps/colmap_3dgut_mcmc_nht",
                               ["dataset.downsample_factor=2"],
                               "train.py:33-34"),
    "post_processing": ("apps/nerf_synthetic_3dgut",
                        ["post_processing.method=ppisp"],
                        "train.py:196-199"),
    "with_gui": ("apps/nerf_synthetic_3dgut", ["with_gui=true"],
                 "train.py:162-174"),
}
# the configs the port trains (gsplat_image_downscale is set without a
# downsample in colmap_3dgut_mcmc_nht: JAX then reads the same images)
TRAINED = ("apps/nerf_synthetic_3dgut", "apps/nerf_synthetic_3dgrt",
           "paper/3dgut/sorted_nerf_synthetic", "apps/nerf_synthetic_3dgut_mcmc",
           "apps/nerf_synthetic_3dgut_mcmc_nht",
           "apps/nerf_synthetic_3dgrt_mcmc_nht", "apps/colmap_3dgut",
           "apps/colmap_3dgut_mcmc_nht", "apps/scannetpp_3dgut")


@pytest.mark.parametrize("case", sorted(REFUSED) + ["trained_configs_load"])
def test_train_cli_refuses_unported_keys(case):
    """train_torch.py stops on each key train.py acts on and the port
    does not, naming it and the train.py line; the configs it trains
    still load."""
    sys.path.insert(0, REPO)
    import train_torch
    from threedgrut_tpu_torch.config.loader import load_config

    if case == "trained_configs_load":
        for name in TRAINED:
            conf = load_config(name)
            train_torch.refuse_unported(conf)
            train_torch.trainer_config(conf)
        return
    name, overrides, line = REFUSED[case]
    train_torch.refuse_unported(load_config(name))   # the default is fine
    with pytest.raises(SystemExit) as err:
        train_torch.main(["--config-name", name, "--device", "cpu",
                          *overrides])
    key = overrides[0].split("=")[0] if case != "gsplat_image_downscale" \
        else "dataset.gsplat_image_downscale"
    assert key in str(err.value) and line in str(err.value)


def test_train_cli_writes_periodic_checkpoint(tmp_path):
    """checkpoint.frequency overwrites ckpt_periodic.npz, as train.py
    does (train.py:187-193)."""
    sys.path.insert(0, REPO)
    import train_torch

    data = str(tmp_path / "lego_mini")
    _write_nerf_dataset(data, side=32)
    out = str(tmp_path / "out")
    train_torch.main(["--config-name", "apps/nerf_synthetic_3dgut",
                      "--device", "cpu", f"path={data}", "n_iterations=3",
                      "initialization.num_gaussians=200", f"out_dir={out}",
                      "experiment_name=p", "log_frequency=0.02",
                      "checkpoint.frequency=2", "test_last=false",
                      "val_frequency=0"])
    with np.load(os.path.join(out, "p", "ckpt_periodic.npz")) as f:
        assert int(f["global_step"]) == 2
    assert os.path.exists(os.path.join(out, "p", "ckpt_last.npz"))


def test_teacher_scene_matches_jax():
    """synthetic.build_teacher draws gen_synthetic_scene.py's arrays, and
    one downsized teacher view (camera from the script's orbit, RGB and
    opacity cut to uint8 as its PNG files are) agrees with the JAX
    render of it: the render differs by ~1e-5 (the JAX kernel's
    split-bf16 products), so a value near a uint8 step may land one
    step over; on < 1% of the pixels."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from gen_synthetic_scene import build_teacher as j_build_teacher
    from threedgrut_tpu.render.gut import render_gut as j_render_gut
    from threedgrut_tpu_torch.synthetic import build_teacher, teacher_dataset

    n, side = 1000, 48
    js = j_build_teacher(n, seed=0)
    model = build_teacher(n, seed=0)
    assert model.n_active == int(js.n_active)
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(),
                                      np.asarray(getattr(js.params, k)),
                                      err_msg=k)
    view = teacher_dataset(model, n_views=1, side=side)[0]
    batch = Batch(rays_ori=np.zeros((side, side, 3), np.float32),
                  rays_dir=np.zeros((side, side, 3), np.float32),
                  T_to_world=view.T_to_world, intrinsics=view.intrinsics)
    out = j_render_gut(j_tr.camera_from_batch(batch, JUTConfig()),
                       JUTConfig(), JRasterConfig(max_pairs=1 << 15), js,
                       sh_degree=3, interpret=True)
    rgb = np.floor(np.clip(np.asarray(out["pred_features"]), 0, 1) * 255)
    op = np.floor(np.clip(np.asarray(out["pred_opacity"]), 0, 1) * 255)
    ref = rgb / 255.0 * (op / 255.0) + (1.0 - op / 255.0)
    got = view.rgb_gt.numpy()
    off = np.abs(got - ref).max(axis=-1) > 1e-6
    assert off.mean() < 0.01
    np.testing.assert_allclose(got, ref, atol=2.0 / 255.0 + 1e-6)
    assert float(np.asarray(out["pred_opacity"]).mean()) > 0.01   # not empty
