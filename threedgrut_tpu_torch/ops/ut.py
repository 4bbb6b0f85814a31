"""Unscented-Transform particle projection (port of threedgrut_tpu/ops/ut.py).

Projects each Gaussian through the camera (any model, global or rolling
shutter) with 7 sigma points, giving a
2D mean and covariance, the conic, the (mip-scaled) opacity, the screen
extent and the sort depth (reference gutProjector.cuh:32-322). Plain
elementwise PyTorch over particles; no kernel is needed here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .cameras import CameraModel, project_point_with_shutter
from .quaternion import quat_normalize, quat_to_rotmat

TILE_X = 16
TILE_Y = 16
TILE_PIXELS = TILE_X * TILE_Y


@dataclasses.dataclass(frozen=True)
class UTConfig:
    """Projector configuration (values of configs/render/3dgut.yaml)."""
    alpha: float = 1.0
    beta: float = 2.0
    kappa: float = 0.0
    n_rolling_shutter_iterations: int = 5
    image_margin_factor: float = 0.1
    require_all_sigma_points: bool = False
    rect_bounding: bool = True
    tight_opacity_bounding: bool = True
    min_sensor_z: float = 0.2
    covariance_dilation: float = 0.3
    alpha_threshold: float = 1.0 / 255.0
    mip_splatting_scaling: bool = True
    global_z_order: bool = True

    @property
    def delta(self) -> float:
        # UT_DELTA = sqrt(alpha^2 * (D + kappa)), D = 3
        return math.sqrt(self.alpha * self.alpha * (3.0 + self.kappa))


class Projection(NamedTuple):
    """Per-particle projection outputs, all [N, ...]."""
    valid: torch.Tensor      # [N] bool: passed projection + conic checks
    center: torch.Tensor     # [N, 2] projected mean (pixels)
    conic: torch.Tensor      # [N, 3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor    # [N] (mip-scaled) opacity
    extent: torch.Tensor     # [N, 2] screen half extent (pixels), 0 if invalid
    depth: torch.Tensor      # [N] sort depth, inf if invalid
    view_dir: torch.Tensor   # [N, 3] unit direction sensor -> particle


def unscented_projection(cam: CameraModel, cfg: UTConfig,
                         positions: torch.Tensor, quats: torch.Tensor,
                         scales: torch.Tensor, opacities: torch.Tensor,
                         active: torch.Tensor) -> Projection:
    """Project N particles; invalid ones are masked, not removed.

    positions [N,3] world means, quats [N,4] wxyz (unnormalized ok),
    scales [N,3] and opacities [N] post-activation, active [N] bool.
    """
    n_sigma_d = 3
    lam = cfg.alpha * cfg.alpha * (n_sigma_d + cfg.kappa) - n_sigma_d
    w0 = lam / (n_sigma_d + lam)
    wi = 1.0 / (2.0 * (n_sigma_d + lam))
    w0_cov = w0 + (1.0 - cfg.alpha * cfg.alpha + cfg.beta)

    rot = quat_to_rotmat(quat_normalize(quats))   # [N,3,3] local->world
    axes = rot * scales[:, None, :]               # [N, world, axis]
    deltas = cfg.delta * axes.transpose(1, 2)     # [N, axis, world]
    p = positions[:, None, :]
    sigma_pts = torch.cat([p, p + deltas, p - deltas], dim=1)   # [N,7,3]

    # rolling shutter: each sigma point at its own shutter time; the
    # sensor position, sort depth and view direction below stay on the
    # start pose, as in JAX (ut.py:96-124, 168-171)
    proj, valid_pt = project_point_with_shutter(
        cam, sigma_pts, tolerance=cfg.image_margin_factor,
        n_iterations=cfg.n_rolling_shutter_iterations)
    num_valid = torch.sum(valid_pt.to(torch.int32), dim=1)

    center = w0 * proj[:, 0, :] + wi * torch.sum(proj[:, 1:, :], dim=1)
    centered = proj - center[:, None, :]
    weights = torch.tensor([w0_cov] + [wi] * (2 * n_sigma_d),
                           dtype=torch.float32, device=positions.device)
    cov_xx = torch.sum(weights * centered[..., 0] * centered[..., 0], dim=1)
    cov_xy = torch.sum(weights * centered[..., 0] * centered[..., 1], dim=1)
    cov_yy = torch.sum(weights * centered[..., 1] * centered[..., 1], dim=1)

    if cfg.require_all_sigma_points:
        valid = num_valid == (2 * n_sigma_d + 1)
    else:
        valid = num_valid > 0

    # opacity threshold + min sensor z (gutProjector.cuh:131-139)
    sensor_ray = positions - sensor_position(cam)
    rot_wc = quat_to_rotmat(cam.q_start)
    z_sensor = positions @ rot_wc[2] + cam.t_start[2]
    valid = (valid & (opacities >= cfg.alpha_threshold)
             & (z_sensor >= cfg.min_sensor_z) & active)

    # conic / extent (gutProjector.cuh:81-116)
    dil_xx = cov_xx + cfg.covariance_dilation
    dil_yy = cov_yy + cfg.covariance_dilation
    det_dil = dil_xx * dil_yy - cov_xy * cov_xy
    det_safe = torch.where(det_dil == 0.0, torch.ones_like(det_dil), det_dil)
    conic = torch.stack([dil_yy, -cov_xy, dil_xx], dim=-1) / det_safe[:, None]
    if cfg.mip_splatting_scaling:
        det_raw = cov_xx * cov_yy - cov_xy * cov_xy
        conv = torch.sqrt(torch.clamp(det_raw / det_safe, min=2.5e-5))
        opacity = opacities * conv
    else:
        opacity = opacities
    valid = valid & (det_dil != 0.0) & (opacity >= cfg.alpha_threshold)

    max_power = torch.log(torch.clamp(opacity, min=1e-30)
                          / cfg.alpha_threshold)
    if cfg.tight_opacity_bounding:
        extent_factor = torch.clamp(
            torch.sqrt(2.0 * torch.clamp(max_power, min=0.0)), max=3.33)
    else:
        extent_factor = torch.full_like(max_power, 3.33)
    mid = 0.5 * (dil_xx + dil_yy)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det_dil, min=0.01))
    radius = extent_factor * torch.sqrt(lam_max)
    if cfg.rect_bounding:
        ext = torch.minimum(
            extent_factor[:, None]
            * torch.sqrt(torch.stack([dil_xx, dil_yy], dim=-1)),
            radius[:, None])
    else:
        ext = torch.stack([radius, radius], dim=-1)
    valid = valid & (radius > 0.0)

    dist = torch.sqrt(torch.sum(sensor_ray * sensor_ray, dim=-1))
    view_dir = sensor_ray / torch.clamp(dist, min=1e-12)[:, None]
    depth = z_sensor if cfg.global_z_order else dist

    return Projection(
        valid=valid, center=center, conic=conic, opacity=opacity,
        extent=torch.where(valid[:, None], ext, torch.zeros_like(ext)),
        depth=torch.where(valid, depth, torch.full_like(depth, math.inf)),
        view_dir=view_dir)


def sensor_position(cam: CameraModel) -> torch.Tensor:
    """World-space camera center from the world->camera start pose."""
    return -(quat_to_rotmat(cam.q_start).T @ cam.t_start)


def tile_bbox(center: torch.Tensor, extent: torch.Tensor, tile_grid):
    """Tile-space bounding boxes (gutProjector.cuh:32-43): (lo, hi) int32
    [N,2], hi exclusive."""
    gx, gy = tile_grid
    lo = torch.stack([
        torch.clamp(torch.floor((center[:, 0] - 0.5 - extent[:, 0]) / TILE_X),
                    0, gx),
        torch.clamp(torch.floor((center[:, 1] - 0.5 - extent[:, 1]) / TILE_Y),
                    0, gy),
    ], dim=-1).to(torch.int32)
    hi = torch.stack([
        torch.clamp(torch.ceil((center[:, 0] - 0.5 + extent[:, 0]) / TILE_X),
                    0, gx),
        torch.clamp(torch.ceil((center[:, 1] - 0.5 + extent[:, 1]) / TILE_Y),
                    0, gy),
    ], dim=-1).to(torch.int32)
    return lo, hi


def tile_min_power_response(tile_xy: torch.Tensor, conic: torch.Tensor,
                            center: torch.Tensor) -> torch.Tensor:
    """Minimum conic power 0.5 x^T Conic x over a tile's footprint; 0 when
    the mean lies inside the tile (gutProjector.cuh:49-78).

    tile_xy [..., 2] tile coordinates (float). The operation order is the
    one ``csrc/bin_decode.cu`` follows, so that the cull decisions of the
    kernel and of this function agree bit for bit.
    """
    tsx, tsy = float(TILE_X), float(TILE_Y)
    tmin_x = tsx * tile_xy[..., 0]
    tmin_y = tsy * tile_xy[..., 1]
    tmax_x = tmin_x + tsx
    tmax_y = tmin_y + tsy
    cx, cy = center[..., 0], center[..., 1]
    moff_x = tmin_x - cx
    moff_y = tmin_y - cy
    la_x = (moff_x > 0.0).to(torch.float32)
    la_y = (moff_y > 0.0).to(torch.float32)
    beyond_x = la_x + (cx > tmax_x).to(torch.float32)
    beyond_y = la_y + (cy > tmax_y).to(torch.float32)
    outside = (beyond_x + beyond_y) > 0.0
    px = tmax_x * (1.0 - la_x) + tmin_x * la_x
    py = tmax_y * (1.0 - la_y) + tmin_y * la_y
    dx = torch.where(moff_x == 0.0, torch.full_like(moff_x, tsx),
                     torch.sign(moff_x) * tsx)
    dy = torch.where(moff_y == 0.0, torch.full_like(moff_y, tsy),
                     torch.sign(moff_y) * tsy)
    diff_x = cx - px
    diff_y = cy - py
    a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
    rcp_x = 1.0 / (tsx * tsx * a)
    rcp_y = 1.0 / (tsy * tsy * c)
    ox = beyond_y * torch.clamp((dx * a * diff_x + dx * b * diff_y) * rcp_x,
                                0.0, 1.0)
    oy = beyond_x * torch.clamp((dy * b * diff_x + dy * c * diff_y) * rcp_y,
                                0.0, 1.0)
    ddx = cx - (px + ox * dx)
    ddy = cy - (py + oy * dy)
    power = 0.5 * (a * ddx * ddx + c * ddy * ddy) + b * ddx * ddy
    return torch.where(outside, power, torch.zeros_like(power))
