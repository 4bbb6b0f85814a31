"""Pinhole camera with a global shutter
(port of threedgrut_tpu/ops/cameras.py:44-110, 191-221, 271-315, 339-360).

The OpenCV pinhole projection keeps its radial(6) / tangential(2) /
thin-prism(4) distortion terms (reference cameraProjections.cuh:72-118).
Fisheye, FTheta and rolling shutter come in a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .quaternion import quat_to_rotmat


@dataclasses.dataclass
class CameraModel:
    """Intrinsics + world->camera pose of one pinhole view:
    ``x_cam = R(q) x_world + t``. All tensors are float32 on one device."""
    resolution: Tuple[int, int]      # (W, H)
    focal: torch.Tensor              # [2] fx, fy
    principal: torch.Tensor          # [2] cx, cy
    radial: torch.Tensor             # [6]
    tangential: torch.Tensor         # [2]
    thin_prism: torch.Tensor         # [4]
    t_start: torch.Tensor            # [3]
    q_start: torch.Tensor            # [4] wxyz

    @property
    def width(self) -> int:
        return self.resolution[0]

    @property
    def height(self) -> int:
        return self.resolution[1]

    @property
    def device(self) -> torch.device:
        return self.focal.device


def make_pinhole(resolution, focal, principal, radial=None, tangential=None,
                 thin_prism=None, t=None, q=None,
                 device="cpu") -> CameraModel:
    """An (optionally distorted) pinhole camera; identity pose by default."""
    def vec(v, n, default=0.0):
        if v is None:
            return torch.full((n,), default, dtype=torch.float32,
                              device=device)
        return torch.tensor(np.asarray(v, np.float32), device=device)

    qv = vec(q, 4) if q is not None else torch.tensor(
        [1.0, 0.0, 0.0, 0.0], dtype=torch.float32, device=device)
    return CameraModel(
        resolution=tuple(int(v) for v in resolution),
        focal=vec(focal, 2), principal=vec(principal, 2),
        radial=vec(radial, 6), tangential=vec(tangential, 2),
        thin_prism=vec(thin_prism, 4), t_start=vec(t, 3), q_start=qv)


def _within_resolution(res_wh, tolerance, p):
    tol = torch.tensor(res_wh, dtype=torch.float32, device=p.device) \
        * tolerance
    return ((p[..., 0] > -tol[0]) & (p[..., 1] > -tol[1])
            & (p[..., 0] < res_wh[0] + tol[0])
            & (p[..., 1] < res_wh[1] + tol[1]))


def project_point(cam: CameraModel, p: torch.Tensor, tolerance=0.0):
    """Camera-space points [..., 3] -> (pixel uv [..., 2], valid [...])."""
    z = p[..., 2]
    valid_z = z > 0.0
    zs = torch.where(valid_z, z, torch.ones_like(z))
    uv = p[..., :2] / zs[..., None]
    uv2 = uv * uv
    r2 = uv2[..., 0] + uv2[..., 1]
    a1 = 2.0 * uv[..., 0] * uv[..., 1]
    a2 = r2 + 2.0 * uv2[..., 0]
    a3 = r2 + 2.0 * uv2[..., 1]
    k = cam.radial
    icd_num = 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
    icd_den = 1.0 + r2 * (k[3] + r2 * (k[4] + r2 * k[5]))
    icd = icd_num / icd_den
    t0, t1 = cam.tangential[0], cam.tangential[1]
    s = cam.thin_prism
    delta = torch.stack([
        t0 * a1 + t1 * a2 + r2 * (s[0] + r2 * s[1]),
        t0 * a3 + t1 * a1 + r2 * (s[2] + r2 * s[3]),
    ], dim=-1)
    uv_nd = icd[..., None] * uv + delta
    valid_radial = (icd > 0.8) & (icd < 1.2)
    proj_ok = uv_nd * cam.focal + cam.principal
    # out-of-limits: clip the direction to an out-of-image radius
    # (cameraProjections.cuh:108-115)
    roi_radius = torch.hypot(
        torch.tensor(float(cam.width), device=p.device),
        torch.tensor(float(cam.height), device=p.device))
    proj_bad = (roi_radius / torch.sqrt(torch.clamp(r2, min=1e-20)))[
        ..., None] * uv + cam.principal
    proj = torch.where(valid_radial[..., None], proj_ok, proj_bad)
    valid = (valid_z & valid_radial
             & _within_resolution(cam.resolution, tolerance, proj))
    proj = torch.where(valid_z[..., None], proj, torch.zeros_like(proj))
    return proj, valid


def world_to_camera(cam: CameraModel, p_world: torch.Tensor) -> torch.Tensor:
    rot = quat_to_rotmat(cam.q_start)
    return torch.einsum("ij,...j->...i", rot, p_world) + cam.t_start


def project_world_point(cam: CameraModel, p_world: torch.Tensor,
                        tolerance=0.0):
    """World point -> pixel through the (global-shutter) start pose."""
    return project_point(cam, world_to_camera(cam, p_world), tolerance)


def pinhole_camera_rays(width: int, height: int, fx, fy, cx=None, cy=None,
                        device="cpu"):
    """Camera-space ray directions at pixel centers.

    Returns (origins [H,W,3] zeros, unit dirs [H,W,3]). The directions
    must stay unit length: the raster kernel's hit distance
    ``-(a.b)/|b|^2`` is exact only for a unit world direction.
    """
    if cx is None:
        cx = 0.5 * width
    if cy is None:
        cy = 0.5 * height
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    xs = (x + 0.5 - cx) / fx
    ys = (y + 0.5 - cy) / fy
    dirs = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True))
    return torch.zeros_like(dirs), dirs


def rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w,x,y,z) unit quaternion (Shepperd's method)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s,
             (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(r)))
        if i == 0:
            s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
            q = [(r[2, 1] - r[1, 2]) / s, 0.25 * s,
                 (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s]
        elif i == 1:
            s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
            q = [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s,
                 0.25 * s, (r[1, 2] + r[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
            q = [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
                 (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def orbit_camera(azimuth: float, elevation: float, distance: float,
                 center=(0.0, 0.0, 4.0), resolution=(512, 512),
                 device="cpu") -> CameraModel:
    """Pinhole camera orbiting ``center`` (right-down-front convention;
    port of threedgrut_tpu/playground/web_gui.py:orbit_camera)."""
    c = np.asarray(center, np.float64)
    eye = c + distance * np.asarray([
        math.cos(elevation) * math.sin(azimuth),
        -math.sin(elevation),
        -math.cos(elevation) * math.cos(azimuth)])
    fwd = c - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray([0.0, -1.0, 0.0]))
    if np.linalg.norm(right) < 1e-6:
        right = np.asarray([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r_wc = np.stack([right, down, fwd], axis=1).T
    t_wc = -r_wc @ eye
    w, h = resolution
    return make_pinhole(resolution, (0.9 * w, 0.9 * w), (w / 2, h / 2),
                        t=t_wc.astype(np.float32),
                        q=rotmat_to_quat(r_wc).astype(np.float32),
                        device=device)
