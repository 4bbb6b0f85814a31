"""NeRF-synthetic dataset, transforms_{split}.json (copied from
threedgrut_tpu/data/nerf.py, decoding with PIL only).

Behavioral contract from threedgrut/datasets/dataset_nerf.py:39-445:
- reads transforms_{train,val,test}.json with camera_angle_x,
- poses are OpenGL-convention camera-to-world; converted to the
  right-down-front convention by flipping the y/z axes,
- RGBA images alpha-composited onto the configured background color,
- pinhole rays at pixel centers in camera space,
- scene bbox is a fixed [-1.5, 1.5] cube by default.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .protocols import Batch, compute_scene_extent

_OPENGL_TO_RDF = np.diag(np.array([1.0, -1.0, -1.0, 1.0], np.float32))


def load_rgb(path: str, size=None, downsample: int = 1) -> np.ndarray:
    """An image file as float32 [H, W, C] in [0, 1] (PIL; C = 3 or 4),
    resized with Lanczos to ``size`` (W, H) or by ``downsample``."""
    from PIL import Image

    img = Image.open(path)
    if size is None and downsample > 1:
        size = (img.width // downsample, img.height // downsample)
    if size is not None and (img.width, img.height) != tuple(size):
        img = img.resize(tuple(size), Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    return arr


class NeRFDataset:
    def __init__(self, path: str, split: str = "train", downsample: int = 1,
                 bg_color: str = "black"):
        self.path = path
        self.split = split
        self.downsample = max(int(downsample), 1)
        self.bg_color = bg_color
        with open(os.path.join(path, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        self.camera_angle_x = float(meta["camera_angle_x"])
        self.frames = meta["frames"]
        self._poses = np.stack([
            np.asarray(fr["transform_matrix"], np.float32) @ _OPENGL_TO_RDF
            for fr in self.frames])
        self._image_cache = {}
        # resolution from the first image
        img0 = self._load_image(0)
        self.height, self.width = img0.shape[:2]
        self.focal = 0.5 * self.width / np.tan(0.5 * self.camera_angle_x)
        self._rays_cache = None

    def __len__(self):
        return len(self.frames)

    def get_poses(self) -> np.ndarray:
        return self._poses

    def get_scene_bbox(self):
        lo = np.array([-1.5, -1.5, -1.5], np.float32)
        return lo, -lo

    def get_scene_extent(self) -> float:
        return compute_scene_extent(self._poses[:, :3, 3])

    def get_observer_points(self) -> np.ndarray:
        return self._poses[:, :3, 3]

    def _load_image(self, index: int) -> np.ndarray:
        if index in self._image_cache:
            return self._image_cache[index]
        fp = self.frames[index]["file_path"]
        if not os.path.splitext(fp)[1]:
            fp = fp + ".png"
        arr = load_rgb(os.path.join(self.path, fp),
                       downsample=self.downsample)
        if arr.shape[2] == 4:
            # composite on background (dataset_nerf.py get_gpu_batch)
            bg = {"black": 0.0, "white": 1.0}.get(self.bg_color, 0.0)
            rgb = arr[..., :3] * arr[..., 3:4] + bg * (1.0 - arr[..., 3:4])
        else:
            rgb = arr[..., :3]
        self._image_cache[index] = rgb
        return rgb

    def camera_rays(self):
        """Camera-space pinhole rays at pixel centers (+0.5); memoized
        (all frames share intrinsics)."""
        if self._rays_cache is None:
            h, w = self.height, self.width
            y, x = np.meshgrid(np.arange(h, dtype=np.float32),
                               np.arange(w, dtype=np.float32),
                               indexing="ij")
            xs = (x + 0.5 - 0.5 * w) / self.focal
            ys = (y + 0.5 - 0.5 * h) / self.focal
            dirs = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
            dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
            self._rays_cache = (np.zeros_like(dirs), dirs.astype(np.float32))
        return self._rays_cache

    def __getitem__(self, index: int) -> Batch:
        rgb = self._load_image(index)
        ray_o, ray_d = self.camera_rays()
        return Batch(
            rays_ori=ray_o, rays_dir=ray_d,
            T_to_world=self._poses[index],
            rgb_gt=rgb,
            intrinsics=[self.focal, self.focal,
                        self.width / 2.0, self.height / 2.0],
            frame_idx=index, camera_idx=0)
