"""Rasterizer configuration and camera rays
(port of threedgrut_tpu/render/common.py).

``RasterConfig`` keeps the reference's fields only. The JAX package's
TPU tuning knobs have no counterpart here: the CUDA kernels take the
reference's shape instead (ROADMAP.md, "Leave out code the port does not
need"), and the kill is always the reference's exact kill.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.cameras import (CameraModel, CameraModelType, ShutterType,
                           fisheye_camera_rays, pinhole_camera_rays)
from ..ops.quaternion import quat_slerp, quat_to_rotmat


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rendering configuration (configs/render/3dgut.yaml)."""
    kernel_degree: int = 2
    min_response: float = 0.0113
    min_alpha: float = 1.0 / 255.0
    max_alpha: float = 0.99
    min_transmittance: float = 1e-4
    tile_culling: bool = True
    # optional cap on (tile, particle) pairs per view; None sizes the
    # pair buffer from the view's own count. Over the cap the farthest
    # pairs are dropped and reported as overflow.
    max_pairs: Optional[int] = None
    # per-ray depth re-sort of each window of ``sort_window`` candidates
    # (3DGRT, and 3DGUT with k_buffer_size > 0): windows are aligned on
    # the global pair index, pair // sort_window, and cut to each tile's
    # pairs (JAX raster.py:_chunk_composite)
    sorted_compositing: bool = False
    sort_window: int = 16
    # alpha-blend each hit's world normal into a pred_normals output
    # (reference render.enable_normals; JAX render/common.py:42-44).
    # Forward only, like the reference: normals carry no cotangent. No
    # YAML key maps to it, as in JAX.
    enable_normals: bool = False

    def __post_init__(self):
        w = self.sort_window
        if not (0 < w <= 128 and w & (w - 1) == 0):
            raise ValueError(f"sort_window {w}: a power of two <= 128")

    def replace(self, **kw) -> "RasterConfig":
        return dataclasses.replace(self, **kw)


def camera_rays_world(cam: CameraModel):
    """Per-pixel world-space rays through the ray-generation pose:
    (origins [H,W,3], unit dirs [H,W,3]) (JAX render/common.py:99-127).

    Pinhole rays for a pinhole camera, the fisheye model's own rays for
    a fisheye one. A rolling-shutter camera casts its rays from the
    MID-shutter pose (the reference's gutRenderer.cu:265-267,
    interpolatedSensorPose(start, end, 0.5)) while the projection uses
    the per-time poses; with a global shutter start == mid == end.

    FTheta raises: the JAX function casts pinhole rays through its
    ``focal = (1, 1)`` (ops/cameras.py:158), pixel offsets divided by
    one, which is not the FTheta camera's geometry (ROADMAP.md section
    3); the port does not copy it.
    """
    w, h = cam.resolution
    if cam.model_type == int(CameraModelType.FTHETA):
        raise NotImplementedError(
            "FTheta camera rays: the JAX package casts pinhole rays with "
            "focal (1, 1) for FTheta (render/common.py:110-115, "
            "ops/cameras.py:158), which is wrong; not ported")
    if cam.model_type == int(CameraModelType.OPENCV_FISHEYE):
        o, d = fisheye_camera_rays(w, h, cam.focal, cam.principal,
                                   cam.radial[:4], cam.max_angle)
    else:
        o, d = pinhole_camera_rays(w, h, cam.focal[0], cam.focal[1],
                                   cam.principal[0], cam.principal[1],
                                   device=cam.device)
    if cam.shutter_type == int(ShutterType.GLOBAL):
        q_ray, t_ray = cam.q_start, cam.t_start
    else:
        q_ray = quat_slerp(cam.q_start, cam.q_end, 0.5)
        t_ray = 0.5 * (cam.t_start + cam.t_end)
    # world <- camera: x_w = R^T (x_c - t)
    rot = quat_to_rotmat(q_ray)
    cam_center = -(rot.T @ t_ray)
    d_w = torch.einsum("ij,hwi->hwj", rot, d)
    o_w = cam_center + torch.einsum("ij,hwi->hwj", rot, o)
    return o_w, d_w
