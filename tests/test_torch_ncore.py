"""The port's NCore loader (threedgrut_tpu_torch/data/ncore.py) against the
JAX loader, both under tests/test_ncore.py's fake SDK, and the NCore apps
through train_torch.py on the port's synthetic sequence.

CPU, numpy only on the JAX side (the JAX loader reaches JAX for its rays
and trainer cameras, no Pallas). Tolerances, with reasons:
  * frames, poses, extents, point clouds, lidar subsamples, masks,
    windowed batches and the PIL backend's images are equal bit for bit:
    the same numpy code on the same arrays;
  * rays within 1e-6: the port's torch ray functions against JAX's jnp
    ones (float32, a Newton inversion for the fisheye);
  * the "native" backend decodes the SDK's JPEG bytes with PIL where JAX
    calls its native libjpeg loader: equal at full size and at a
    downsample of 3 (full decode and the same truncating box mean); at a
    downsample of 2, PIL scales in libjpeg's DCT (``Image.draft``) where
    the native loader box-filters the full decode, within 8 levels of
    255 and a mean of 1.5 levels on the fake's frames;
  * FTheta polynomials fitted at a downsample within 1e-9 (np.polyfit of
    the same samples in both).
"""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import threedgrut_tpu.data.ncore as j_ncore
import threedgrut_tpu_torch.data.ncore as t_ncore
from test_ncore import FakeSequence
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.train import trainer as j_tr
from threedgrut_tpu_torch.train import trainer as t_tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMS = ("cam_front", "cam_fish", "cam_omni")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _install(monkeypatch, modules):
    for name, mod in modules.items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setattr(j_ncore, "_HAVE_NCORE", True)
    monkeypatch.setattr(t_ncore, "_HAVE_NCORE", True)


@pytest.fixture()
def fake(monkeypatch):
    """tests/test_ncore.py's fake SDK, one FakeSequence shared by both
    loaders (its images hash the sensor name per process)."""
    seq = FakeSequence()
    root = types.ModuleType("ncore")
    data = types.ModuleType("ncore.data")
    v4 = types.ModuleType("ncore.data.v4")
    v4.open_sequence = lambda path: seq
    root.data, data.v4 = data, v4
    _install(monkeypatch, {"ncore": root, "ncore.data": data,
                           "ncore.data.v4": v4})
    return seq


def _pair(**kw):
    return (j_ncore.NCoreDataset("/fake/seq", **kw),
            t_ncore.NCoreDataset("/fake/seq", **kw))


def _assert_batches_equal(jb, tb, rays_atol=0.0):
    for f in dataclasses.fields(jb):
        a, b = getattr(jb, f.name), getattr(tb, f.name)
        if f.name in ("rays_ori", "rays_dir"):
            np.testing.assert_allclose(b, np.asarray(a), atol=rays_atol,
                                       rtol=0, err_msg=f.name)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        elif isinstance(a, dict):
            assert a.keys() == b.keys(), f.name
            for k in a:
                np.testing.assert_array_equal(np.asarray(b[k]),
                                              np.asarray(a[k]))
        else:
            assert a == b, f.name


def test_gated_without_sdk():
    """No SDK here: the port's loader and make_dataset raise ImportError,
    as JAX's loader does."""
    sys.path.insert(0, REPO)
    import train_torch
    from threedgrut_tpu_torch.config.loader import load_config

    assert not t_ncore._HAVE_NCORE and not j_ncore._HAVE_NCORE
    with pytest.raises(ImportError):
        j_ncore.NCoreDataset("/nonexistent")
    with pytest.raises(ImportError):
        t_ncore.NCoreDataset("/nonexistent")
    conf = load_config("apps/ncore_3dgut", overrides=["path=/nonexistent"])
    with pytest.raises(ImportError, match="ncore"):
        train_torch.make_dataset(conf, "train")


@pytest.mark.parametrize("split", ["train", "val"])
def test_frames_poses_extent_bbox_match_jax(fake, split):
    jd, td = _pair(split=split, val_frame_interval=3)
    assert td.camera_ids == jd.camera_ids == ["cam_front", "cam_fish"]
    assert td.frames == jd.frames and len(td) == len(jd)
    np.testing.assert_array_equal(td.get_poses(), jd.get_poses())
    np.testing.assert_array_equal(td.get_observer_points(),
                                  jd.get_observer_points())
    assert td.get_scene_extent() == jd.get_scene_extent()
    for a, b in zip(td.get_scene_bbox(), jd.get_scene_bbox()):
        np.testing.assert_array_equal(a, b)


def test_sensor_selection_and_time_window_match_jax(fake):
    for kw in (dict(camera_ids=["cam_fish"]),
               dict(camera_ids=["cam_omni"], camera_max_fov_deg=200.0),
               dict(camera_max_fov_deg=100.0),
               dict(seek_offset_sec=0.15, duration_sec=0.2),
               dict(seek_offset_sec=0.25),
               dict(duration_sec=0.35, split="val")):
        jd, td = _pair(val_frame_interval=3, **kw)
        assert td.camera_ids == jd.camera_ids, kw
        assert td.frames == jd.frames, kw
        assert td._time_range_us == jd._time_range_us, kw
        # lidar sweeps in the window
        assert (len(list(td.get_point_clouds()))
                == len(list(jd.get_point_clouds()))), kw
    for bad in (dict(camera_ids=["nope"]),
                dict(camera_ids=["cam_omni"])):
        for cls in (j_ncore.NCoreDataset, t_ncore.NCoreDataset):
            with pytest.raises(ValueError):
                cls("/fake/seq", **bad)


def test_point_clouds_and_lidar_init_match_jax(fake):
    jd, td = _pair(val_frame_interval=3)
    for dyn in (True, False):
        jc = list(jd.get_point_clouds(non_dynamic_points_only=dyn))
        tc = list(td.get_point_clouds(non_dynamic_points_only=dyn))
        assert len(tc) == len(jc) == 3
        for a, b in zip(jc, tc):
            for k in ("xyz_start", "xyz_end", "color"):
                np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    np.testing.assert_array_equal(td.get_point_clouds_xyz(step_frame=2),
                                  jd.get_point_clouds_xyz(step_frame=2))
    for seed in (0, 3):
        jd, td = _pair(val_frame_interval=3, seed=seed)
        for n in (100, None, 1000):
            for a, b in zip(jd.load_lidar_init(n), td.load_lidar_init(n)):
                np.testing.assert_array_equal(b, a)


def test_rays_match_jax(fake):
    jd, td = _pair(camera_max_fov_deg=200.0)
    for cam in CAMS:
        for res in ((32, 24), (16, 12)):
            for a, b in zip(jd.camera_rays(cam, res),
                            td.camera_rays(cam, res)):
                assert b.dtype == np.float32
                np.testing.assert_allclose(b, np.asarray(a), atol=1e-6,
                                           rtol=0, err_msg=cam)
    assert td.camera_rays("cam_front", (32, 24))[1] is td.camera_rays(
        "cam_front", (32, 24))[1]


@pytest.mark.parametrize("dilation", [0, 2, 30])
def test_masks_match_jax(fake, dilation):
    for split, sub in (("train", 1), ("val", 2)):
        jd, td = _pair(split=split, val_frame_interval=3,
                       n_val_image_subsample=sub,
                       n_camera_mask_dilation_iterations=dilation)
        for i in range(len(jd)):
            np.testing.assert_array_equal(td[i].mask, jd[i].mask)
        if dilation == 0 and split == "train":
            m = td[0].mask
            assert m[:2].sum() == 0 and m[2:].min() == 1.0


def test_batches_match_jax(fake):
    """Full frames (train), subsampled validation frames and windowed
    train batches at the same seed, with the PIL backend: equal but for
    the rays' float32 rounding."""
    for kw in (dict(split="train"), dict(split="val",
                                         n_val_image_subsample=2),
               dict(split="train", sample_full_image=False, window_size=8,
                    n_samples_per_epoch=7, seed=5)):
        jd, td = _pair(val_frame_interval=3, jpeg_backend_cpu="PIL", **kw)
        assert len(td) == len(jd)
        for i in range(len(jd)):
            _assert_batches_equal(jd[i], td[i], rays_atol=1e-6)


def test_downsampled_intrinsics_and_images_match_jax(fake):
    """downsample 0.5: intrinsics (the FTheta polyfit included), the
    camera-model dicts and the box-mean images of the PIL backend."""
    jd, td = _pair(camera_max_fov_deg=200.0, downsample=0.5,
                   jpeg_backend_cpu="PIL", val_frame_interval=3)
    for cam in CAMS:
        a, b = jd._intrinsics(cam), td._intrinsics(cam)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(np.asarray(b[k], np.float64)
                                       if k != "model" else 0,
                                       np.asarray(a[k], np.float64)
                                       if k != "model" else 0,
                                       atol=1e-9, rtol=0, err_msg=k)
    omni = td._intrinsics("cam_omni")
    assert omni["angle_to_pixeldist"][1] == 5.0
    for i in range(len(jd)):
        jb, tb = jd[i], td[i]
        assert tb.rgb_gt.shape == (12, 16, 3)
        _assert_batches_equal(jb, tb, rays_atol=1e-6)


def test_camera_from_batch_matches_jax(fake):
    """The trainers' cameras of every sensor's batches, field by field
    (rolling pinhole, fisheye, FTheta; full frames and windows)."""
    from torch_port_utils import CAMERA_TENSORS

    batches = []
    for kw in (dict(camera_max_fov_deg=200.0),
               dict(sample_full_image=False, window_size=8,
                    n_samples_per_epoch=6, seed=1)):
        jd, td = _pair(val_frame_interval=3, **kw)
        batches += [(jd[i], td[i]) for i in range(len(jd))]
    kinds = set()
    for jb, tb in batches:
        jc = j_tr.camera_from_batch(jb, JUTConfig())
        tc = t_tr.camera_from_batch(tb)
        kinds.add((tc.model_type, tc.shutter_type, tc.resolution))
        for k in ("resolution", "model_type", "shutter_type",
                  "ftheta_reference_poly"):
            assert getattr(tc, k) == getattr(jc, k), k
        for k in CAMERA_TENSORS:
            np.testing.assert_allclose(getattr(tc, k).numpy(),
                                       np.asarray(getattr(jc, k)),
                                       atol=1e-7, err_msg=k)
    assert {k[:2] for k in kinds} == {(0, 1), (1, 0), (2, 0)}


def test_native_backend_decodes_with_pil_within_tolerance(fake):
    """The port decodes the SDK's JPEG bytes with PIL where JAX uses its
    native libjpeg loader (which the card cannot load): equal at full
    size and at a downsample of 3, within the module docstring's bound
    at 2. The "PIL" backend equals JAX's bit for bit."""
    from threedgrut_tpu.data.native_loader import native_available

    if not native_available():
        pytest.skip("JAX's native loader (native/libdataio.so) does not "
                    "load here")
    for ds, down in ((1, 1.0), (2, 0.5), (3, 1 / 3)):
        jd, td = _pair(val_frame_interval=3, downsample=down,
                       camera_max_fov_deg=200.0)
        errs = []
        for cam, fidx in jd.frames:
            a = jd._decode_image(cam, fidx).astype(np.int32)
            b = td._decode_image(cam, fidx).astype(np.int32)
            assert a.shape == b.shape
            errs.append(np.abs(a - b))
        err = np.concatenate([e.ravel() for e in errs])
        if ds == 2:
            assert err.max() <= 8 and err.mean() <= 1.5, (err.max(),
                                                          err.mean())
        else:
            assert err.max() == 0, ds
    jd, td = _pair(val_frame_interval=3, jpeg_backend_cpu="PIL")
    for cam, fidx in jd.frames:
        np.testing.assert_array_equal(td._decode_image(cam, fidx),
                                      jd._decode_image(cam, fidx))


def test_make_dataset_and_model_match_train_py(fake):
    """train_torch.py's make_dataset (train and val) and make_model
    (lidar initialisation, observer-distance scales) for each NCore app
    against train.py's, on the fake sequence."""
    sys.path.insert(0, REPO)
    import train
    import train_torch
    from threedgrut_tpu.config.loader import load_config as j_load
    from threedgrut_tpu_torch.config.loader import load_config as t_load

    for name in ("apps/ncore_3dgut", "apps/ncore_3dgrt_mcmc"):
        over = ["path=/fake/seq", "initialization.num_points=120",
                "dataset.val_frame_interval=3",
                "strategy.add.max_n_gaussians=300"]
        jc, tc = j_load(name, overrides=over), t_load(name, overrides=over)
        for j_split, t_split in (("train", "train"), ("test", "val")):
            jd = train.make_dataset(jc, j_split)
            td = train_torch.make_dataset(tc, t_split)
            assert td.frames == jd.frames and td.split == jd.split
            for k in ("downsample", "sample_full_image", "window_size",
                      "n_samples_per_epoch", "n_train_sample_camera_rays",
                      "n_val_image_subsample", "val_frame_interval",
                      "jpeg_backend_cpu", "lidar_color_generic_data_name",
                      "n_mask_dilation", "_time_range_us", "camera_ids",
                      "lidar_ids"):
                assert getattr(td, k) == getattr(jd, k), (name, k)
        jm = train.make_model(jc, train.make_dataset(jc, "train"))
        tm = train_torch.make_model(tc, train_torch.make_dataset(tc,
                                                                 "train"),
                                    "cpu")
        assert tm.n_active == int(jm.n_active) == 120
        assert tm.capacity == jm.params.positions.shape[0]
        for k in ("positions", "rotation", "scale", "density",
                  "features_albedo", "features_specular"):
            np.testing.assert_allclose(
                getattr(tm, k).detach().numpy(),
                np.asarray(getattr(jm.params, k)), rtol=1e-6, atol=1e-7,
                err_msg=f"{name} {k}")


# --- the JAX loader's quirks, which the port keeps ------------------------

def test_quirk_window_keeps_full_frame_intrinsics(fake):
    """A windowed crop keeps the frame's fx, fy, cx, cy (ncore.py:464-478),
    so the trainers' window-sized camera has the full frame's principal
    point: the crop it renders is not the GT window."""
    jd, td = _pair(val_frame_interval=3, sample_full_image=False,
                   window_size=8, n_samples_per_epoch=4, seed=2)
    full = t_ncore.NCoreDataset("/fake/seq", val_frame_interval=3)
    for i in range(4):
        jb, tb = jd[i], td[i]
        assert tb.resolution == jb.resolution == (8, 8)
        fb = next(full[k] for k in range(len(full))
                  if full.frames[k][0] == td.camera_ids[tb.camera_idx])
        assert tb.intrinsics == jb.intrinsics == fb.intrinsics
        tc = t_tr.camera_from_batch(tb)
        jc = j_tr.camera_from_batch(jb, JUTConfig())
        np.testing.assert_array_equal(tc.principal.numpy(),
                                      np.asarray(jc.principal))
        assert float(tc.principal[0]) == 16.0 and tc.resolution == (8, 8)


def test_quirk_ftheta_rays_are_unit_focal_pinhole(fake):
    """An FTheta sensor's cached rays are pinhole rays with fx = fy = 1
    (ncore.py:368-371), though its camera is built from the polynomial."""
    from threedgrut_tpu_torch.ops.cameras import (CameraModelType,
                                                  pinhole_camera_rays)

    jd, td = _pair(camera_ids=["cam_omni"], camera_max_fov_deg=200.0)
    o, d = pinhole_camera_rays(32, 24, 1.0, 1.0, 16.0, 12.0)
    np.testing.assert_array_equal(td.camera_rays("cam_omni", (32, 24))[1],
                                  d.numpy())
    np.testing.assert_allclose(np.asarray(jd.camera_rays("cam_omni",
                                                         (32, 24))[1]),
                               d.numpy(), atol=1e-6)
    cam = t_tr.camera_from_batch(td[0])
    assert cam.model_type == int(CameraModelType.FTHETA)
    assert td[0].intrinsics[:2] == jd[0].intrinsics[:2] == [1.0, 1.0]


class _Spy:
    """A batch that records which of its fields are read."""

    def __init__(self, batch):
        object.__setattr__(self, "_b", batch)
        object.__setattr__(self, "read", set())

    def __getattr__(self, name):
        self.read.add(name)
        return getattr(self._b, name)

    @property
    def resolution(self):
        h, w = self._b.rays_dir.shape[:2]
        return (w, h)


def test_quirk_trainers_read_no_mask_or_rays(fake):
    """Neither trainer reads a batch's mask or cached rays: JAX's
    camera_from_batch and the port's Trainer step read the poses,
    intrinsics and GT only (the dilated masks never reach the loss), and
    a step on a batch whose mask and rays are scrambled gives the same
    loss."""
    from threedgrut_tpu_torch.synthetic import bench_cloud
    from threedgrut_tpu_torch.train.trainer import Trainer, TrainerConfig

    jd, td = _pair(val_frame_interval=3)
    spy = _Spy(jd[0])
    j_tr.camera_from_batch(spy, JUTConfig())
    assert not spy.read & {"mask", "rays_ori", "rays_dir"}
    losses = []
    for scramble in (False, True):
        b = td[0]
        if scramble:
            b = dataclasses.replace(
                b, mask=np.zeros_like(b.mask),
                rays_dir=np.random.default_rng(0).normal(
                    size=b.rays_dir.shape).astype(np.float32),
                rays_ori=np.ones_like(b.rays_ori))
        spy = _Spy(b)
        model = bench_cloud(300, seed=1)
        tr = Trainer(TrainerConfig(n_iterations=1), td, model)
        losses.append(tr.train_iteration(spy, frame_idx=0)["total"])
        assert not spy.read & {"mask", "rays_ori", "rays_dir"}, spy.read
    assert losses[0] == losses[1]


# --- the NCore apps through train_torch.py on the synthetic sequence -----

@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A tiny synthetic NCore sequence of an 800-point teacher: both
    sensors at 48x32, 8 frames each, two lidar sweeps of 700 points (~5%
    dynamic)."""
    from threedgrut_tpu_torch.synthetic import (build_teacher,
                                                write_ncore_sequence)

    path = str(tmp_path_factory.mktemp("ncore") / "seq")
    return write_ncore_sequence(path, build_teacher(800, seed=0),
                                resolution=(48, 32), n_sweeps=2,
                                sweep_points=700)


@pytest.fixture()
def stub(monkeypatch):
    from threedgrut_tpu_torch.synthetic import ncore_stub_modules

    _install(monkeypatch, ncore_stub_modules())


def test_synthetic_sequence_serves_both_sensors(sequence, stub):
    """The stub SDK over write_ncore_sequence's directory: a rolling
    pinhole and a 120-degree fisheye, JPEG frames (bytes and decoded),
    a hood band in the mask, lidar sweeps with ~5% dynamic points."""
    from threedgrut_tpu_torch.synthetic import NCORE_CAMERAS

    ds = t_ncore.NCoreDataset(sequence, n_camera_mask_dilation_iterations=0)
    assert ds.camera_ids == list(NCORE_CAMERAS)
    assert len(ds) == 14 and ds.get_scene_extent() > 0
    shutters = {ds[i].shutter_type for i in range(len(ds))}
    assert shutters == {"rolling_top_to_bottom", "global"}
    fish = next(ds[i] for i in range(len(ds)) if ds[i].camera_idx == 1)
    assert fish.intrinsics_OpenCVFisheyeCameraModelParameters is not None
    assert ds.seq.camera_fov_deg(ds.camera_ids[1]) == 120.0
    b = ds[0]
    assert b.rgb_gt.shape == (32, 48, 3) and b.rgb_gt.max() > 0.2
    assert b.mask[-3:].sum() == 0 and b.mask[:-3].min() == 1.0
    assert not np.allclose(b.T_to_world, b.T_to_world_end)
    np.testing.assert_array_equal(
        t_ncore.decode_jpeg(ds.seq.camera_frame_encoded(ds.camera_ids[0],
                                                        1)),
        ds.seq.camera_image(ds.camera_ids[0], 1))
    clouds = list(ds.get_point_clouds(non_dynamic_points_only=False))
    static = list(ds.get_point_clouds())
    n_all = sum(len(c.xyz_end) for c in clouds)
    n_static = sum(len(c.xyz_end) for c in static)
    assert n_all == 1400 and 0.9 < n_static / n_all < 0.99
    pts, cols, dists = ds.load_lidar_init(1000)
    assert pts.shape == (1000, 3) and cols.max() <= 1.0
    assert (dists > 1.0).all()


@pytest.mark.parametrize("name,extra", [
    ("apps/ncore_3dgut", []),
    ("apps/ncore_3dgrt_mcmc", ["strategy.add.max_n_gaussians=1024"]),
])
def test_train_cli_two_steps(sequence, stub, tmp_path, name, extra):
    """Two steps of train_torch.py --device cpu on the synthetic
    sequence with lidar initialisation: a checkpoint and the final
    metrics on the validation frames."""
    sys.path.insert(0, REPO)
    import train_torch

    out = str(tmp_path / "out")
    train_torch.main(["--config-name", name, "--device", "cpu",
                      f"path={sequence}", "n_iterations=2",
                      "initialization.num_points=600", f"out_dir={out}",
                      "experiment_name=nc", *extra])
    with np.load(os.path.join(out, "nc", "ckpt_last.npz")) as f:
        assert int(f["global_step"]) == 2
        assert int(f["n_active"]) >= 600
    with open(os.path.join(out, "nc", "final_metrics.json")) as f:
        final = json.load(f)
    assert final["n_views"] == 2 and np.isfinite(final["psnr"])
    assert torch.tensor(0.0).device.type == "cpu"
