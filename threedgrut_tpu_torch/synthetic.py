"""The repository's synthetic scenes, built without JAX.

``bench_cloud`` makes the cloud of bench.py:130-152 from
``np.random.default_rng(seed)``: ``n`` Gaussians in the box x, y in
[-2.5, 2.5], z in [2, 9] in front of a camera at the origin, random
rotations, scales 0.01-0.05, logit densities N(0, 0.5), RGB albedo and
small degree-3 SH terms; capacity rounded up to a multiple of 256 with
the dead rows parked far away.

``build_teacher`` and ``camera_pose`` are those of
scripts/gen_synthetic_scene.py:29-126 (the "lego-class" teacher: towers,
an arch and a ground slab), drawing the same numpy arrays.
``teacher_dataset`` renders its views through the port's renderer and
quantises them as that script's PNG files are, into an in-memory
dataset the trainer reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

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
    """One training view, with the fields of the trainer's batches."""
    T_to_world: np.ndarray     # [4, 4] camera-to-world, OpenCV convention
    intrinsics: list           # [fx, fy, cx, cy]
    rgb_gt: torch.Tensor       # [H, W, 3] f32 on the device

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


def teacher_dataset(teacher: GaussianModel, n_views: int = 8,
                    side: int = 800, seed: int = 0, split_offset: int = 1,
                    background: float = 1.0, ut_cfg=None,
                    raster_cfg=None) -> ViewDataset:
    """Views of ``teacher`` on the orbit of gen_synthetic_scene.py's
    ``write_split`` (same numpy draws), rendered with the port's
    ``render_gut``. RGB and opacity are cut to uint8 as the PNG path
    writes them, then composited on ``background`` as the NeRF loader
    reads them."""
    from .ops.ut import UTConfig
    from .render.common import RasterConfig
    from .render.gut import render_gut
    from .train.trainer import camera_from_batch

    ut_cfg = ut_cfg or UTConfig()
    raster_cfg = raster_cfg or RasterConfig()
    r2 = np.random.default_rng(seed + split_offset)
    focal = 1.111 * side
    views = []
    for i in range(n_views):
        az = i / n_views * 2 * math.pi + r2.uniform(0, 0.05)
        el = np.deg2rad(r2.uniform(15, 45))
        radius = r2.uniform(3.6, 4.4)
        cv = camera_pose(az, el, radius)
        cv[:3, 1] *= -1          # OpenGL -> OpenCV (right-down-front)
        cv[:3, 2] *= -1
        view = View(cv.astype(np.float32), [focal, focal, side / 2, side / 2],
                    torch.zeros((side, side, 3), device=teacher.device))
        cam = camera_from_batch(view, teacher.device)
        with torch.no_grad():
            out = render_gut(cam, ut_cfg, raster_cfg, teacher, 3)
            rgb = torch.floor(torch.clamp(out["pred_features"], 0, 1)
                              * 255.0) / 255.0
            op = torch.floor(torch.clamp(out["pred_opacity"], 0, 1)
                             * 255.0) / 255.0
            view.rgb_gt = rgb * op + background * (1.0 - op)
        views.append(view)
    return ViewDataset(views)
