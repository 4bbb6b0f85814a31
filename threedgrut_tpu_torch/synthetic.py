"""The repository's synthetic scenes, built without JAX.

``bench_cloud`` makes the cloud of bench.py:130-152 from
``np.random.default_rng(seed)``: ``n`` Gaussians in the box x, y in
[-2.5, 2.5], z in [2, 9] in front of a camera at the origin, random
rotations, scales 0.01-0.05, logit densities N(0, 0.5), RGB albedo and
small degree-3 SH terms; capacity rounded up to a multiple of 256 with
the dead rows parked far away; ``nht_cloud`` gives it NHT features.

``build_teacher`` and ``camera_pose`` are those of
scripts/gen_synthetic_scene.py:29-126 (the "lego-class" teacher: towers,
an arch and a ground slab), drawing the same numpy arrays.
``teacher_dataset`` renders its views through the port's renderer and
quantises them as that script's PNG files are, into an in-memory
dataset the trainer reads: pinhole views, or the two other cameras of
``CAMERA_KINDS`` (a ScanNet++-like fisheye, an NCore-like rolling
shutter). ``write_colmap_scene`` writes such views as a COLMAP /
ScanNet++ capture folder for the training CLI.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np
import torch

from .models.gaussians import GaussianModel, GaussianModelConfig
from .ops.sh import SH_C0


def bench_cloud(n: int = 100_000, seed: int = 0,
                device="cpu") -> GaussianModel:
    cap = ((n + 255) // 256) * 256
    rng = np.random.default_rng(seed)
    pos = np.zeros((cap, 3), np.float32)
    pos[:n, 0:2] = rng.uniform(-2.5, 2.5, (n, 2))
    pos[:n, 2] = rng.uniform(2.0, 9.0, n)
    pos[n:, 2] = 1e6
    quat = rng.normal(size=(cap, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    scales = np.log(rng.uniform(0.01, 0.05, (cap, 3)).astype(np.float32))
    dens = (rng.normal(size=(cap, 1)) * 0.5).astype(np.float32)
    rgb = rng.uniform(0, 1, (cap, 3)).astype(np.float32)
    albedo = ((rgb - 0.5) / np.float32(SH_C0)).astype(np.float32)
    spec = (rng.normal(size=(cap, 45)) * 0.02).astype(np.float32)
    arrays = dict(positions=pos, rotation=quat, scale=scales, density=dens,
                  features_albedo=albedo, features_specular=spec)
    return GaussianModel.from_numpy(arrays, n_active=n, n_active_features=3,
                                    config=GaussianModelConfig(),
                                    device=device)


def nht_cloud(n: int = 100_000, seed: int = 0, dim: int = 48,
              device="cpu") -> GaussianModel:
    """The bench cloud's geometry with NHT features: ``dim`` control
    features per particle (dim / 4 per tetrahedron vertex), uniform in
    (-pi/2, pi/2) as the NHT initialisation draws them
    (models/gaussians.py), from ``np.random.default_rng(seed + 1)``."""
    sh = bench_cloud(n, seed, device="cpu")
    rng = np.random.default_rng(seed + 1)
    arrays = {k: getattr(sh, k).detach().numpy()
              for k in ("positions", "rotation", "scale", "density")}
    arrays["features"] = rng.uniform(-np.pi / 2, np.pi / 2, (
        sh.capacity, dim)).astype(np.float32)
    return GaussianModel.from_numpy(
        arrays, n_active=n, n_active_features=0,
        config=GaussianModelConfig(feature_type="nht", nht_feature_dim=dim),
        device=device)


def orbit_geometry(model: GaussianModel):
    """(center, distance) of an orbit around the live cloud, as
    scripts/eval_fps.py picks it: the mean, and 2.2 times the 95th
    percentile of the distances to it."""
    pos = model.positions.detach()[:model.n_active].cpu().numpy()
    center = pos.mean(axis=0)
    radius = float(np.percentile(np.linalg.norm(pos - center, axis=1), 95))
    return center, max(2.2 * radius, 1e-3)


def build_teacher(n: int = 60000, seed: int = 0,
                  device="cpu") -> GaussianModel:
    """Structured teacher: towers + arch + ground, piecewise colors."""
    rng = np.random.default_rng(seed)
    groups, cols = [], []

    def add(pts, rgb):
        groups.append(pts)
        cols.append(np.broadcast_to(np.asarray(rgb, np.float32),
                                    (len(pts), 3)).copy())

    n_ground = n // 4
    g = rng.uniform(-1.0, 1.0, (n_ground, 3)).astype(np.float32)
    g[:, 1] = 0.62 + rng.normal(0, 0.01, n_ground)
    add(g, (0.45, 0.42, 0.38))

    n_tower = n // 4
    for cx, cz, rgb in [(-0.45, 0.0, (0.85, 0.2, 0.15)),
                        (0.45, 0.1, (0.15, 0.45, 0.85))]:
        t = np.zeros((n_tower // 2, 3), np.float32)
        t[:, 1] = rng.uniform(-0.35, 0.6, n_tower // 2)
        radius = 0.16 * (1.0 - 0.4 * (0.6 - t[:, 1]) / 0.95)
        ang = rng.uniform(0, 2 * np.pi, n_tower // 2)
        rr = radius * np.sqrt(rng.uniform(0.6, 1.0, n_tower // 2))
        t[:, 0] = cx + rr * np.cos(ang)
        t[:, 2] = cz + rr * np.sin(ang)
        add(t, rgb)

    n_arch = n // 4
    th = rng.uniform(0, np.pi, n_arch)
    a = np.zeros((n_arch, 3), np.float32)
    a[:, 0] = 0.55 * np.cos(th) + rng.normal(0, 0.02, n_arch)
    a[:, 1] = -0.35 - 0.35 * np.sin(th) + rng.normal(0, 0.02, n_arch)
    a[:, 2] = rng.normal(0, 0.05, n_arch)
    add(a, (0.9, 0.75, 0.2))

    n_rest = n - sum(len(p) for p in groups)
    sph = rng.normal(0, 1, (n_rest, 3)).astype(np.float32)
    sph /= np.maximum(np.linalg.norm(sph, axis=1, keepdims=True), 1e-9)
    sph = sph * 0.22 + np.asarray([0.0, -0.05, -0.45], np.float32)
    add(sph, (0.2, 0.8, 0.35))

    pos = np.concatenate(groups)
    rgb = np.concatenate(cols)
    rgb = np.clip(rgb + rng.normal(0, 0.06, rgb.shape), 0.02, 0.98)
    n_total = len(pos)
    cap = ((n_total + 255) // 256) * 256
    pad = cap - n_total

    def padded(x, fill=0.0):
        return np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)])

    quat = rng.normal(size=(cap, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    scales = np.log(rng.uniform(0.006, 0.016, (cap, 3)).astype(np.float32))
    dens = np.full((cap, 1), 2.0, np.float32)      # sigmoid(2) ~ 0.88
    pos_p = padded(pos)
    pos_p[n_total:, 1] = 1e6
    albedo = (padded(rgb).astype(np.float32) - 0.5) / np.float32(SH_C0)
    spec = (rng.normal(size=(cap, 45)) * 0.12).astype(np.float32)
    arrays = dict(positions=pos_p, rotation=quat, scale=scales, density=dens,
                  features_albedo=albedo, features_specular=spec)
    return GaussianModel.from_numpy(arrays, n_active=n_total,
                                    n_active_features=3,
                                    config=GaussianModelConfig(),
                                    device=device)


def camera_pose(azimuth, elevation, radius):
    """NeRF-synthetic c2w (OpenGL convention: -z forward, y up)."""
    eye = radius * np.asarray([
        np.cos(elevation) * np.sin(azimuth),
        np.sin(elevation),
        np.cos(elevation) * np.cos(azimuth)])
    fwd = -eye / np.linalg.norm(eye)              # look at origin
    up = np.asarray([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


@dataclasses.dataclass
class View:
    """One training view, with the fields of the trainer's batches
    (``data/protocols.py:Batch``) that ``camera_from_batch`` reads."""
    T_to_world: np.ndarray     # [4, 4] camera-to-world, OpenCV convention
    intrinsics: list           # [fx, fy, cx, cy]
    rgb_gt: torch.Tensor       # [H, W, 3] f32 on the device
    T_to_world_end: Optional[np.ndarray] = None   # rolling shutter's end
    shutter_type: str = "global"
    intrinsics_OpenCVFisheyeCameraModelParameters: Optional[dict] = None

    @property
    def resolution(self):
        h, w = self.rgb_gt.shape[:2]
        return (w, h)


class ViewDataset:
    """In-memory views with the dataset interface the trainer reads."""

    def __init__(self, views: List[View]):
        self.views = views

    def __len__(self):
        return len(self.views)

    def __getitem__(self, i) -> View:
        return self.views[i]

    def get_poses(self) -> np.ndarray:
        return np.stack([v.T_to_world for v in self.views])

    def get_scene_extent(self) -> float:
        """Median camera distance from the median camera center, times
        1.1 (threedgrut_tpu/data/protocols.py:compute_scene_extent)."""
        centers = self.get_poses()[:, :3, 3]
        center = np.median(centers, axis=0, keepdims=True)
        return float(np.median(np.linalg.norm(centers - center, axis=1))
                     * 1.1)


# The cameras teacher_dataset renders with: (resolution, focal as a
# fraction of the height, fisheye k1-k4 or None, rolling shutter).
#   pinhole: NeRF-synthetic-like, side x side, focal 1.111 side;
#   fisheye: ScanNet++-like DSLR (OPENCV_FISHEYE, 1752x1168), focal
#     0.675 H (= 0.45 W, ~788 px), k = (-0.03, -0.005, 0.001, -0.0002),
#     max_angle pi/2;
#   rolling: NCore-like (configs/dataset/ncore.yaml: 1920x1280) pinhole,
#     focal 1.1 H, rolling shutter top to bottom: over the readout the
#     end pose moves ROLLING_SHIFT world units along the camera's right
#     axis and turns ROLLING_YAW radians about its down axis.
CAMERA_KINDS = {
    "pinhole": (None, 1.111, None, False),
    "fisheye": ((1752, 1168), 0.675, (-0.03, -0.005, 0.001, -0.0002), False),
    "rolling": ((1920, 1280), 1.1, None, True),
}
ROLLING_SHIFT = 0.05
ROLLING_YAW = 0.01


def _rolling_end_pose(c2w: np.ndarray) -> np.ndarray:
    """The camera-to-world pose at the end of the rolling readout."""
    c, s = math.cos(ROLLING_YAW), math.sin(ROLLING_YAW)
    yaw = np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    end = np.array(c2w, np.float64)
    end[:3, :3] = c2w[:3, :3] @ yaw
    end[:3, 3] = c2w[:3, 3] + ROLLING_SHIFT * c2w[:3, 0]
    return end.astype(np.float32)


# bench.py's pinhole view
BENCH_SIDE = 800


def bench_camera(kind: str = "pinhole", resolution=None, device="cpu"):
    """The bench view of ``bench_cloud`` (a camera at the origin looking
    down +z) with the ``kind`` of CAMERA_KINDS at ``resolution`` (W, H;
    default the kind's own): the pinhole of bench.py (800x800, focal 1.1
    W), the ScanNet++-like fisheye (1752x1168) or the NCore-like rolling
    shutter (1920x1280; the end pose of ``_rolling_end_pose``), their
    focal the table's fraction of H."""
    from .ops.cameras import (ShutterType, make_fisheye, make_pinhole,
                              world_to_camera_pose)

    own, focal_frac, radial4, _ = CAMERA_KINDS[kind]
    w, h = resolution or own or (BENCH_SIDE, BENCH_SIDE)
    if kind == "pinhole":
        return make_pinhole((w, h), (1.1 * w, 1.1 * w), (w / 2, h / 2),
                            device=device)
    f = focal_frac * h
    if radial4 is not None:
        return make_fisheye((w, h), (f, f), (w / 2, h / 2), radial4,
                            math.pi / 2, device=device)
    t_end, q_end = world_to_camera_pose(_rolling_end_pose(np.eye(4)))
    return make_pinhole((w, h), (f, f), (w / 2, h / 2), t_end=t_end,
                        q_end=q_end,
                        shutter_type=int(ShutterType.ROLLING_TOP_TO_BOTTOM),
                        device=device)


def orbit_cameras(model: GaussianModel, n_views: int, kind: str = "pinhole",
                  resolution=None, elevation: float = 0.35, device="cpu"):
    """``n_views`` cameras on the orbit of ``orbit_geometry`` around the
    live cloud (scripts/eval_fps.py's serving views) at ``resolution``
    (W, H; default the kind's own): ``orbit_camera``'s pinhole, or its
    poses with the intrinsics of ``bench_camera(kind)`` (and, rolling,
    the end pose of ``_rolling_end_pose``)."""
    from .ops.cameras import orbit_camera, world_to_camera_pose
    from .ops.quaternion import quat_to_rotmat

    center, dist = orbit_geometry(model)
    base = bench_camera(kind, resolution, device)
    cams = []
    for az in np.linspace(0.0, 2 * math.pi, n_views, endpoint=False):
        o = orbit_camera(az, elevation, dist, center=center,
                         resolution=base.resolution, device=device)
        if kind == "pinhole":
            cams.append(o)
            continue
        cam = dataclasses.replace(base, t_start=o.t_start, q_start=o.q_start,
                                  t_end=o.t_start, q_end=o.q_start)
        if kind == "rolling":
            r_wc = quat_to_rotmat(o.q_start).double().cpu().numpy()
            c2w = np.eye(4)
            c2w[:3, :3] = r_wc.T
            c2w[:3, 3] = -r_wc.T @ o.t_start.double().cpu().numpy()
            t_end, q_end = world_to_camera_pose(_rolling_end_pose(c2w))
            cam.t_end = torch.tensor(t_end, device=device)
            cam.q_end = torch.tensor(q_end, device=device)
        cams.append(cam)
    return cams


def orbit_poses(n_views: int, seed: int = 0, split_offset: int = 1
                ) -> List[np.ndarray]:
    """The OpenGL camera-to-world poses (float64) of
    gen_synthetic_scene.py's ``write_split``, drawn from
    ``default_rng(seed + split_offset)`` in its order."""
    r2 = np.random.default_rng(seed + split_offset)
    poses = []
    for i in range(n_views):
        az = i / n_views * 2 * math.pi + r2.uniform(0, 0.05)
        el = np.deg2rad(r2.uniform(15, 45))
        radius = r2.uniform(3.6, 4.4)
        poses.append(camera_pose(az, el, radius))
    return poses


def teacher_views(n_views: int, resolution, camera: str = "pinhole",
                  seed: int = 0, split_offset: int = 1) -> List[View]:
    """The empty views (poses and intrinsics, zero GT) of
    ``teacher_dataset``: the orbit of gen_synthetic_scene.py's
    ``write_split`` (same numpy draws) with the ``camera`` of
    CAMERA_KINDS at ``resolution`` (W, H)."""
    _, focal_frac, radial4, rolling = CAMERA_KINDS[camera]
    w, h = resolution
    focal = focal_frac * h
    views = []
    for c2w in orbit_poses(n_views, seed, split_offset):
        cv = c2w.copy()
        cv[:3, 1] *= -1          # OpenGL -> OpenCV (right-down-front)
        cv[:3, 2] *= -1
        view = View(cv.astype(np.float32), [focal, focal, w / 2, h / 2],
                    torch.zeros((h, w, 3)))
        if radial4 is not None:
            view.intrinsics_OpenCVFisheyeCameraModelParameters = dict(
                fx=focal, fy=focal, cx=w / 2, cy=h / 2,
                radial=np.asarray(radial4), max_angle=math.pi / 2)
        if rolling:
            view.T_to_world_end = _rolling_end_pose(cv)
            view.shutter_type = "rolling_top_to_bottom"
        views.append(view)
    return views


def teacher_dataset(teacher: GaussianModel, n_views: int = 8,
                    side: int = 800, seed: int = 0, split_offset: int = 1,
                    background: float = 1.0, ut_cfg=None,
                    raster_cfg=None, camera: str = "pinhole",
                    resolution=None) -> ViewDataset:
    """Views of ``teacher`` on the orbit of gen_synthetic_scene.py's
    ``write_split`` (same numpy draws), rendered with the port's
    ``render_gut`` through the ``camera`` of CAMERA_KINDS, at
    ``resolution`` (W, H; default: the kind's own, side x side for a
    pinhole). RGB and opacity are cut to uint8 as the PNG path writes
    them, then composited on ``background`` as the NeRF loader reads
    them."""
    from .ops.ut import UTConfig
    from .render.common import RasterConfig
    from .render.gut import render_gut
    from .train.trainer import camera_from_batch

    ut_cfg = ut_cfg or UTConfig()
    raster_cfg = raster_cfg or RasterConfig()
    resolution = resolution or CAMERA_KINDS[camera][0] or (side, side)
    views = teacher_views(n_views, resolution, camera, seed, split_offset)
    for view in views:
        cam = camera_from_batch(view, teacher.device)
        with torch.no_grad():
            out = render_gut(cam, ut_cfg, raster_cfg, teacher, 3)
            rgb = torch.floor(torch.clamp(out["pred_features"], 0, 1)
                              * 255.0) / 255.0
            op = torch.floor(torch.clamp(out["pred_opacity"], 0, 1)
                             * 255.0) / 255.0
            view.rgb_gt = rgb * op + background * (1.0 - op)
    return ViewDataset(views)


def write_colmap_scene(path: str, dataset: ViewDataset,
                       teacher: GaussianModel, n_points: int = 5000,
                       seed: int = 0):
    """Write ``dataset``'s views as a ScanNet++-style COLMAP capture:
    ``images/frame_XXXX.png``, and under ``colmap/sparse/0`` the binary
    ``cameras.bin`` (one OPENCV_FISHEYE or PINHOLE camera from the first
    view), ``images.bin`` (world->camera poses) and ``points3D.bin``
    (``n_points`` of the teacher's live positions with their albedo
    colours: the COLMAP initialisation). Global-shutter views only."""
    from PIL import Image

    from .data.colmap import (write_cameras_bin, write_images_bin,
                              write_points3d_bin)
    from .ops.cameras import rotmat_to_quat

    sparse = os.path.join(path, "colmap", "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(path, "images"), exist_ok=True)
    v0 = dataset[0]
    w, h = v0.resolution
    fish = v0.intrinsics_OpenCVFisheyeCameraModelParameters
    if fish is not None:
        cam = dict(model="OPENCV_FISHEYE", width=w, height=h,
                   params=[fish["fx"], fish["fy"], fish["cx"], fish["cy"],
                           *map(float, fish["radial"])])
    else:
        fx, fy, cx, cy = v0.intrinsics
        cam = dict(model="PINHOLE", width=w, height=h,
                   params=[fx, fy, cx, cy])
    write_cameras_bin(os.path.join(sparse, "cameras.bin"), {1: cam})
    images = {}
    for i, view in enumerate(dataset.views):
        if view.T_to_world_end is not None:
            raise ValueError("COLMAP has no rolling shutter")
        name = f"frame_{i:04d}.png"
        rgb = np.clip(np.round(view.rgb_gt.cpu().numpy() * 255.0), 0, 255)
        Image.fromarray(rgb.astype(np.uint8)).save(
            os.path.join(path, "images", name))
        c2w = np.asarray(view.T_to_world, np.float64)
        r_wc = c2w[:3, :3].T
        images[i + 1] = dict(qvec=rotmat_to_quat(r_wc),
                             tvec=-r_wc @ c2w[:3, 3], camera_id=1, name=name)
    write_images_bin(os.path.join(sparse, "images.bin"), images)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        pos = teacher.positions[:teacher.n_active].cpu().numpy()
        rgb = (teacher.features_albedo[:teacher.n_active].cpu().numpy()
               * SH_C0 + 0.5)
    pick = rng.choice(len(pos), size=min(n_points, len(pos)), replace=False)
    write_points3d_bin(os.path.join(sparse, "points3D.bin"), pos[pick],
                       np.clip(np.round(rgb[pick] * 255.0), 0, 255))
