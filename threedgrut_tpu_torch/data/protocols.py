"""The Batch contract of the datasets (copied from
threedgrut_tpu/data/protocols.py:17-65, the ``Batch`` dataclass and
``compute_scene_extent``).

Rays are stored in camera space together with the start (and, for a
rolling shutter, end) camera-to-world poses; the trainer builds a
``CameraModel`` from them (``train/trainer.py:camera_from_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Batch:
    """One view (B=1 in practice, matching the reference trainer)."""
    rays_ori: np.ndarray            # [H, W, 3] camera- (or world-) space
    rays_dir: np.ndarray            # [H, W, 3]
    T_to_world: np.ndarray          # [4, 4] camera-to-world (shutter start)
    T_to_world_end: Optional[np.ndarray] = None  # [4, 4] shutter end
    rays_in_world_space: bool = False
    rgb_gt: Optional[np.ndarray] = None          # [H, W, 3] float in [0,1]
    mask: Optional[np.ndarray] = None            # [H, W, 1]
    intrinsics: Optional[list] = None            # [fx, fy, cx, cy]
    # native camera-model parameter dicts (tracer.py:354-488 equivalents)
    intrinsics_OpenCVPinholeCameraModelParameters: Optional[dict] = None
    intrinsics_OpenCVFisheyeCameraModelParameters: Optional[dict] = None
    intrinsics_FThetaCameraModelParameters: Optional[dict] = None
    shutter_type: str = "global"
    camera_idx: int = -1
    frame_idx: int = -1
    exposure: Optional[float] = None

    @property
    def resolution(self):
        h, w = self.rays_dir.shape[:2]
        return (w, h)


def compute_scene_extent(camera_centers: np.ndarray) -> float:
    """Median-center camera-spread diagonal * 1.1
    (threedgrut/datasets/utils.py:157 get_center_and_diag convention)."""
    center = np.median(camera_centers, axis=0, keepdims=True)
    dist = np.linalg.norm(camera_centers - center, axis=1, keepdims=True)
    return float(np.median(dist) * 1.1)
