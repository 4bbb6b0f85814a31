"""COLMAP and ScanNet++ datasets (copied from
threedgrut_tpu/data/colmap.py, decoding with PIL and casting fisheye
rays with the port's ``ops/cameras.py:fisheye_camera_rays``), and
writers of the binary COLMAP model that
``synthetic.py:write_colmap_scene`` uses.

Behavioral contract from threedgrut/datasets/dataset_colmap.py:114-822:
- parses sparse/0/{cameras,images,points3D}.bin (or colmap/sparse/0),
- PINHOLE / SIMPLE_PINHOLE / OPENCV / OPENCV_FISHEYE / SIMPLE_RADIAL,
- images sorted by name; test split = every 8th frame (llffhold-style),
- optional downsampling via images_N directories or on-the-fly resize,
- poses camera-to-world in the right-down-front convention (COLMAP
  native), scene extent from the camera spread,
- gsplat's protocol (``data/colmap_gsplat.py``): ``gsplat_normalize``
  moves the poses, the sparse points and the extent into the normalised
  world of the split's own cameras; ``gsplat_image_downscale`` with a
  downsample reads a bicubic ``images_{f}_png`` cache, built once inside
  the capture, and corrects the intrinsics by the rounded size over the
  floor-divided one.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np

from .nerf import load_rgb
from .protocols import Batch, compute_scene_extent

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: i for i, (name, _) in CAMERA_MODELS.items()}


def _read(fmt, f):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path: str) -> Dict[int, dict]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            cam_id, model_id, width, height = _read("<iiQQ", f)
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{np_}d", f), np.float64)
            cams[cam_id] = dict(model=name, width=int(width),
                                height=int(height), params=params)
    return cams


def read_images_bin(path: str) -> Dict[int, dict]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            image_id = _read("<i", f)[0]
            qvec = np.array(_read("<4d", f))
            tvec = np.array(_read("<3d", f))
            camera_id = _read("<i", f)[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read("<Q", f)
            f.seek(24 * n_pts, 1)  # skip 2D points (x, y, point3D_id)
            images[image_id] = dict(qvec=qvec, tvec=tvec,
                                    camera_id=camera_id,
                                    name=name.decode("utf-8"))
    return images


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n,), np.float64)
        for i in range(n):
            data = _read("<Q3d3Bd", f)
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read("<Q", f)
            f.seek(8 * track_len, 1)
    return xyz.astype(np.float32), rgb, err.astype(np.float32)


def read_points3d_txt(path: str):
    xyz, rgb = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            xyz.append([float(v) for v in el[1:4]])
            rgb.append([int(v) for v in el[4:7]])
    return (np.asarray(xyz, np.float32), np.asarray(rgb, np.uint8),
            np.zeros(len(xyz), np.float32))


def write_cameras_bin(path: str, cams: Dict[int, dict]):
    """Inverse of ``read_cameras_bin``: {id: dict(model, width, height,
    params)}."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, c in cams.items():
            f.write(struct.pack("<iiQQ", cid, MODEL_IDS[c["model"]],
                                c["width"], c["height"]))
            f.write(struct.pack(f"<{len(c['params'])}d", *c["params"]))


def write_images_bin(path: str, images: Dict[int, dict]):
    """Inverse of ``read_images_bin`` (no 2D points): {id: dict(qvec,
    tvec, camera_id, name)}, qvec/tvec world -> camera."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, im in images.items():
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<4d", *im["qvec"]))
            f.write(struct.pack("<3d", *im["tvec"]))
            f.write(struct.pack("<i", im["camera_id"]))
            f.write(im["name"].encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_bin(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """Inverse of ``read_points3d_bin`` (zero error, empty tracks)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c) in enumerate(zip(xyz, rgb)):
            f.write(struct.pack("<Q3d3Bd", i + 1, *map(float, p),
                                *map(int, c), 0.0))
            f.write(struct.pack("<Q", 0))


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w,x,y,z) -> rotation matrix (world->camera)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class ColmapDataset:
    """Loads a COLMAP capture directory (images/ + sparse/0/)."""

    def __init__(self, path: str, split: str = "train", downsample: int = 1,
                 test_split_interval: int = 8, gsplat_normalize: bool = False,
                 gsplat_image_downscale: bool = False):
        self.path = path
        self.split = split
        self.downsample = max(int(downsample), 1)
        self.gsplat_normalize = gsplat_normalize
        self.gsplat_image_downscale = gsplat_image_downscale
        self.world_transform = np.eye(4, dtype=np.float32)
        self._gsplat_extent = None
        sparse = os.path.join(path, "sparse", "0")
        if not os.path.isdir(sparse):
            sparse = os.path.join(path, "colmap", "sparse", "0")
        if not os.path.exists(os.path.join(sparse, "cameras.bin")):
            raise FileNotFoundError(f"no COLMAP sparse model under {path}")
        self.cameras = read_cameras_bin(os.path.join(sparse, "cameras.bin"))
        self.images_meta = read_images_bin(os.path.join(sparse,
                                                        "images.bin"))
        self._points_path = os.path.join(sparse, "points3D.bin")

        items = sorted(self.images_meta.values(), key=lambda d: d["name"])
        idx = np.arange(len(items))
        if test_split_interval > 0:
            test_mask = (idx % test_split_interval) == 0
        else:
            test_mask = np.zeros(len(items), bool)
        sel = ~test_mask if split == "train" else test_mask
        self.items = [it for it, s in zip(items, sel) if s]

        # camera-to-world poses (COLMAP stores world->camera)
        poses = []
        for it in self.items:
            r = qvec_to_rotmat(it["qvec"])
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = r.T
            c2w[:3, 3] = -r.T @ it["tvec"]
            poses.append(c2w)
        self._poses = np.stack(poses) if poses else np.zeros((0, 4, 4))
        if gsplat_normalize and len(self._poses) \
                and os.path.exists(self._points_path):
            # JAX data/colmap.py:166-177: the split's own cameras set the
            # normalisation
            from .colmap_gsplat import normalize_world_space, scene_scale

            pts = read_points3d_bin(self._points_path)[0]
            if len(pts):
                cams, _, transform = normalize_world_space(
                    self._poses.astype(np.float64), pts.astype(np.float64))
                self._poses = cams.astype(np.float32)
                self.world_transform = transform.astype(np.float32)
                self._gsplat_extent = scene_scale(self._poses) * 1.1
        self._image_dir = self._find_image_dir()
        self._name_map = None
        if gsplat_image_downscale:
            # JAX data/colmap.py:181-193
            from .colmap_gsplat import (build_downscale_cache,
                                        sorted_name_mapping)

            colmap_dir = os.path.join(self.path, "images")
            if self.downsample > 1 and self._image_dir == colmap_dir:
                self._image_dir = build_downscale_cache(
                    colmap_dir, os.path.join(
                        self.path, f"images_{self.downsample}_png"),
                    self.downsample)
            self._name_map = sorted_name_mapping(colmap_dir, self._image_dir)
        self._image_cache = {}
        self._rays_cache = {}

    def _find_image_dir(self):
        if self.downsample > 1:
            cand = os.path.join(self.path, f"images_{self.downsample}")
            if os.path.isdir(cand):
                return cand
        return os.path.join(self.path, "images")

    def __len__(self):
        return len(self.items)

    def get_poses(self) -> np.ndarray:
        return self._poses

    def get_observer_points(self) -> np.ndarray:
        return self._poses[:, :3, 3]

    def get_scene_extent(self) -> float:
        if self._gsplat_extent is not None:
            return self._gsplat_extent
        return compute_scene_extent(self._poses[:, :3, 3])

    def get_camera_idx(self, frame_idx: int) -> int:
        ids = sorted(self.cameras.keys())
        return ids.index(self.items[frame_idx]["camera_id"])

    def load_points3d(self):
        pts, rgb, err = read_points3d_bin(self._points_path)
        if self.gsplat_normalize and len(pts):
            from .colmap_gsplat import transform_points

            pts = transform_points(self.world_transform.astype(np.float64),
                                   pts.astype(np.float64)).astype(np.float32)
        return pts, rgb, err

    def intrinsics_for(self, camera_id: int) -> dict:
        """Intrinsics dict scaled by the downsample factor
        (dataset_colmap.py:337-430)."""
        cam = self.cameras[camera_id]
        p = cam["params"]
        s = 1.0 / self.downsample
        w = int(round(cam["width"] * s))
        h = int(round(cam["height"] * s))
        model = cam["model"]
        out = dict(model=model, width=w, height=h)
        pinhole = dict(radial=np.zeros(6), tangential=np.zeros(2),
                       thin_prism=np.zeros(4), kind="pinhole")
        if model == "SIMPLE_PINHOLE":
            out.update(fx=p[0] * s, fy=p[0] * s, cx=p[1] * s, cy=p[2] * s,
                       **pinhole)
        elif model == "PINHOLE":
            out.update(fx=p[0] * s, fy=p[1] * s, cx=p[2] * s, cy=p[3] * s,
                       **pinhole)
        elif model == "SIMPLE_RADIAL":
            out.update(fx=p[0] * s, fy=p[0] * s, cx=p[1] * s, cy=p[2] * s,
                       **pinhole)
            out["radial"][0] = p[3]
        elif model == "OPENCV":
            out.update(fx=p[0] * s, fy=p[1] * s, cx=p[2] * s, cy=p[3] * s,
                       **pinhole)
            out["radial"][:2] = p[4:6]
            out["tangential"] = np.array([p[6], p[7]])
        elif model == "OPENCV_FISHEYE":
            out.update(fx=p[0] * s, fy=p[1] * s, cx=p[2] * s, cy=p[3] * s,
                       radial=np.array([p[4], p[5], p[6], p[7]]),
                       max_angle=np.pi / 2, kind="fisheye")
        else:
            raise NotImplementedError(f"COLMAP camera model {model}")
        if self.gsplat_image_downscale and self.downsample > 1:
            # JAX data/colmap.py:256-262: the cache's rounded size over
            # the floor-divided one
            sx = w / (cam["width"] // self.downsample)
            sy = h / (cam["height"] // self.downsample)
            if sx != 1.0 or sy != 1.0:
                out["fx"] *= sx
                out["cx"] *= sx
                out["fy"] *= sy
                out["cy"] *= sy
        return out

    def _load_image(self, index: int) -> np.ndarray:
        if index not in self._image_cache:
            it = self.items[index]
            cam = self.cameras[it["camera_id"]]
            size = (int(round(cam["width"] / self.downsample)),
                    int(round(cam["height"] / self.downsample)))
            name = it["name"]
            if self._name_map is not None:
                name = self._name_map.get(name, name)
            self._image_cache[index] = load_rgb(
                os.path.join(self._image_dir, name), size)[..., :3]
        return self._image_cache[index]

    def camera_rays(self, intr: dict):
        """Camera-space rays of one camera, memoized (the fisheye solve
        costs tens of ms per view otherwise)."""
        key = (intr["width"], intr["height"], intr["fx"], intr["fy"],
               intr["cx"], intr["cy"], intr["kind"])
        if key not in self._rays_cache:
            self._rays_cache[key] = self._camera_rays_uncached(intr)
        return self._rays_cache[key]

    def _camera_rays_uncached(self, intr: dict):
        h, w = intr["height"], intr["width"]
        if intr["kind"] == "fisheye":
            import torch

            from ..ops.cameras import fisheye_camera_rays
            o, d = fisheye_camera_rays(
                w, h, torch.tensor([intr["fx"], intr["fy"]]),
                torch.tensor([intr["cx"], intr["cy"]]),
                torch.tensor(intr["radial"]), intr["max_angle"])
            return o.numpy(), d.numpy()
        y, x = np.meshgrid(np.arange(h, dtype=np.float32),
                           np.arange(w, dtype=np.float32), indexing="ij")
        xs = (x + 0.5 - intr["cx"]) / intr["fx"]
        ys = (y + 0.5 - intr["cy"]) / intr["fy"]
        dirs = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        return np.zeros_like(dirs), dirs.astype(np.float32)

    def __getitem__(self, index: int) -> Batch:
        it = self.items[index]
        intr = self.intrinsics_for(it["camera_id"])
        ray_o, ray_d = self.camera_rays(intr)
        batch = Batch(
            rays_ori=ray_o, rays_dir=ray_d,
            T_to_world=self._poses[index],
            rgb_gt=self._load_image(index),
            intrinsics=[intr["fx"], intr["fy"], intr["cx"], intr["cy"]],
            frame_idx=index, camera_idx=self.get_camera_idx(index))
        if intr["kind"] == "fisheye":
            batch.intrinsics_OpenCVFisheyeCameraModelParameters = intr
        else:
            batch.intrinsics_OpenCVPinholeCameraModelParameters = intr
        return batch


class ScannetppDataset(ColmapDataset):
    """ScanNet++ fisheye variant (dataset_scannetpp.py:23): the COLMAP
    layout with fisheye cameras, points3D.txt under colmap/ when
    present."""

    def load_points3d(self):
        txt = os.path.join(self.path, "colmap", "points3D.txt")
        if os.path.exists(txt):
            return read_points3d_txt(txt)
        return super().load_points3d()
