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

from ..ops.cameras import CameraModel, pinhole_camera_rays
from ..ops.quaternion import quat_to_rotmat


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

    def __post_init__(self):
        w = self.sort_window
        if not (0 < w <= 128 and w & (w - 1) == 0):
            raise ValueError(f"sort_window {w}: a power of two <= 128")

    def replace(self, **kw) -> "RasterConfig":
        return dataclasses.replace(self, **kw)


def camera_rays_world(cam: CameraModel):
    """Per-pixel world-space rays of a global-shutter pinhole camera:
    (origins [H,W,3], unit dirs [H,W,3])."""
    o, d = pinhole_camera_rays(cam.width, cam.height, cam.focal[0],
                               cam.focal[1], cam.principal[0],
                               cam.principal[1], device=cam.device)
    # world <- camera: x_w = R^T (x_c - t)
    rot = quat_to_rotmat(cam.q_start)
    cam_center = -(rot.T @ cam.t_start)
    d_w = torch.einsum("ij,hwi->hwj", rot, d)
    o_w = cam_center + torch.einsum("ij,hwi->hwj", rot, o)
    return o_w, d_w
