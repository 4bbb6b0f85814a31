"""NCore v4 sequence dataset (copied from threedgrut_tpu/data/ncore.py,
decoding with PIL only and casting rays with the port's
``ops/cameras.py:pinhole_camera_rays`` and ``fisheye_camera_rays``).

The reference implementation (threedgrut/datasets/datasetNcore.py:52-1346)
builds on NVIDIA's proprietary ``ncore`` package, which is not in the
repository; the loader is gated on it. ``synthetic.py:write_ncore_sequence``
writes a sequence that ``synthetic.py:ncore_stub_modules`` serves through
the SDK's adapter surface, for the tests and the card.

Feature parity with the reference loader:

- V4 single-sequence meta handling with time windowing
  (``seek_offset_sec`` / ``duration_sec`` against per-sensor frame
  timestamps; datasetNcore.py:155-170,423)
- multi-sensor camera selection by id with max-FOV filtering
  (``camera_ids``, ``camera_max_fov_deg``; :518-540)
- JPEG decode of the SDK's encoded frame bytes with PIL, downscaling on
  decode by 2, 4 or 8 (``Image.draft``: libjpeg's DCT scaling; the
  reference's simplejpeg fast path, :703-761); ``jpeg_backend_cpu="PIL"``
  takes the SDK's decoded ``camera_image`` with a box mean instead
- per-camera ray caches: camera-space rays computed once per sensor and
  reused across frames (:1019-1067)
- valid-pixel masks with binary dilation
  (``n_camera_mask_dilation_iterations``; :762-900 mask path)
- train sampling modes: full-image or windowed random ray sampling
  (``sample_full_image``, ``window_size``, ``n_train_sample_camera_rays``,
  ``n_samples_per_epoch``; :762-830)
- validation split by ``val_frame_interval`` with
  ``n_val_image_subsample`` pixel subsampling (:830-900)
- multi-source point clouds (lidar/radar/native ids) with dynamic-point
  filtering, per-point colors, and per-cloud sensor origins for
  observer-distance scale initialization (:930-1018)

The SDK adapter surface expected from ``ncore.data.v4.open_sequence``:
required: camera_ids, lidar_ids, num_frames(id), camera_pose(id, i),
camera_intrinsics(id), camera_image(id, i);
optional (hasattr-discovered, mirroring reference capabilities):
camera_pose_shutter_end, shutter_type(id), frame_timestamps_us(id),
camera_fov_deg(id), camera_frame_encoded(id, i), camera_mask(id),
lidar_points_world(id, i), lidar_origin_world(id, i),
lidar_point_flags(id, i), lidar_point_colors(id, i, name),
point_cloud_source_ids.

The JAX loader's quirks are kept: a windowed crop keeps the full frame's
intrinsics, an FTheta sensor's cached rays are pinhole rays of unit
focal, and no trainer reads the masks or the cached rays.
"""

from __future__ import annotations

import dataclasses
import io
from typing import List, Optional

import numpy as np

from .protocols import Batch, compute_scene_extent

try:
    import ncore.data.v4  # type: ignore  # noqa: F401
    _HAVE_NCORE = True
except ImportError:
    _HAVE_NCORE = False


@dataclasses.dataclass
class PointCloud:
    """One source point cloud (reference datasets/utils.py:111).

    xyz_start are the per-point sensor origins (ray starts) used for
    observer-distance scale initialization; xyz_end the world points.
    """
    xyz_start: np.ndarray            # [N, 3]
    xyz_end: np.ndarray              # [N, 3]
    color: Optional[np.ndarray] = None  # [N, 3] float in [0,1] or None


def _binary_dilate(mask: np.ndarray, iterations: int) -> np.ndarray:
    """4-neighborhood binary dilation (reference dilates camera masks
    n_camera_mask_dilation_iterations times before use)."""
    m = mask.astype(bool)
    for _ in range(max(iterations, 0)):
        grown = m.copy()
        grown[1:, :] |= m[:-1, :]
        grown[:-1, :] |= m[1:, :]
        grown[:, 1:] |= m[:, :-1]
        grown[:, :-1] |= m[:, 1:]
        m = grown
    return m


def decode_jpeg(data: bytes, downsample: int = 1) -> np.ndarray:
    """uint8 [H, W, 3] of JPEG (or PNG) bytes, downscaled by the integer
    ``downsample`` to (W // downsample, H // downsample): by libjpeg's
    DCT scaling on decode (``Image.draft``) where ``downsample`` is 2, 4
    or 8, else by the truncating box mean of JAX's native decoder
    (native/dataio.cpp:box_downsample)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    size = (img.width // downsample, img.height // downsample)
    if downsample in (2, 4, 8):
        img.draft("RGB", size)
    arr = np.asarray(img.convert("RGB"))
    if arr.shape[1::-1] != size:
        ds = downsample
        h2, w2 = size[1], size[0]
        arr = arr[:h2 * ds, :w2 * ds].reshape(h2, ds, w2, ds, 3).mean(
            axis=(1, 3)).astype(np.uint8)
    return arr


class NCoreDataset:
    def __init__(self, path: str, split: str = "train",
                 camera_ids: Optional[List[str]] = None,
                 lidar_ids: Optional[List[str]] = None,
                 downsample: float = 1.0,
                 seek_offset_sec: Optional[float] = None,
                 duration_sec: Optional[float] = None,
                 sample_full_image: bool = True,
                 window_size: int = 256,
                 n_samples_per_epoch: int = 1000,
                 n_train_sample_camera_rays: int = 4096,
                 n_val_image_subsample: int = 1,
                 val_frame_interval: int = 8,
                 camera_max_fov_deg: float = 190.0,
                 n_camera_mask_dilation_iterations: int = 30,
                 jpeg_backend_cpu: str = "native",
                 lidar_color_generic_data_name: str = "rgb",
                 seed: int = 0):
        if not _HAVE_NCORE:
            raise ImportError(
                "NCoreDataset requires the external 'ncore' package "
                "(NVIDIA NCore SDK). Install it or use the nerf/colmap/"
                "scannetpp loaders.")
        import ncore.data.v4 as ncore_v4

        self.path = path
        self.split = split
        self.downsample = downsample
        self.sample_full_image = sample_full_image
        self.window_size = window_size
        self.n_samples_per_epoch = n_samples_per_epoch
        self.n_train_sample_camera_rays = (window_size * window_size
                                           if sample_full_image is False
                                           and n_train_sample_camera_rays <= 0
                                           else n_train_sample_camera_rays)
        self.n_val_image_subsample = max(int(n_val_image_subsample), 1)
        self.val_frame_interval = val_frame_interval
        self.jpeg_backend_cpu = jpeg_backend_cpu
        self.lidar_color_generic_data_name = lidar_color_generic_data_name
        self.n_mask_dilation = n_camera_mask_dilation_iterations
        self._rng = np.random.default_rng(seed)
        self.seq = ncore_v4.open_sequence(path)

        # ---- sensor selection: explicit ids validated, else auto-detect
        available = list(self.seq.camera_ids)
        if camera_ids is not None:
            unknown = [c for c in camera_ids if c not in available]
            if unknown:
                raise ValueError(f"unknown camera sensors {unknown}; "
                                 f"available: {available}")
            selected = list(camera_ids)
        else:
            selected = available
        # FOV filter (reference camera_max_fov_deg guards omnidirectional
        # sensors whose polynomials are unconstrained past the FOV)
        if hasattr(self.seq, "camera_fov_deg"):
            selected = [c for c in selected
                        if float(self.seq.camera_fov_deg(c))
                        <= camera_max_fov_deg]
        if not selected:
            raise ValueError("no camera sensors left after selection")
        self.camera_ids = selected
        self.lidar_ids = (list(lidar_ids) if lidar_ids is not None
                          else list(self.seq.lidar_ids))

        # ---- time windowing over per-sensor frame timestamps
        self._time_range_us = None
        if (seek_offset_sec or (duration_sec is not None
                                and duration_sec > 0)) \
                and hasattr(self.seq, "frame_timestamps_us"):
            all_ts = np.concatenate([
                np.asarray(self.seq.frame_timestamps_us(c), np.int64)
                for c in self.camera_ids])
            t0 = int(all_ts.min()) + int((seek_offset_sec or 0.0) * 1e6)
            t1 = int(all_ts.max()) + 1
            if duration_sec is not None and duration_sec > 0:
                t1 = min(t0 + int(duration_sec * 1e6), t1)
            self._time_range_us = (t0, t1)

        # ---- frame table with frame-level train/val split
        frames = []
        for cam_id in self.camera_ids:
            n_frames = self.seq.num_frames(cam_id)
            if self._time_range_us is not None:
                ts = np.asarray(self.seq.frame_timestamps_us(cam_id),
                                np.int64)
                fidxs = np.nonzero((ts >= self._time_range_us[0])
                                   & (ts < self._time_range_us[1]))[0]
            else:
                fidxs = range(n_frames)
            for fidx in fidxs:
                is_val = (int(fidx) % val_frame_interval) == 0
                if (split == "train") != is_val:
                    frames.append((cam_id, int(fidx)))
        self.frames = frames
        self._poses = np.stack([
            np.asarray(self.seq.camera_pose(cid, fi), np.float32)
            for cid, fi in frames]) if frames else np.zeros((0, 4, 4))

        # per-camera caches (rays / masks / intrinsics), lazily filled
        self._ray_cache: dict = {}
        self._mask_cache: dict = {}
        self._intr_cache: dict = {}

    # ------------------------------------------------------------------
    # sampling protocol
    # ------------------------------------------------------------------

    def __len__(self):
        if self.split == "train" and not self.sample_full_image:
            return self.n_samples_per_epoch
        return len(self.frames)

    def get_poses(self) -> np.ndarray:
        return self._poses

    def get_observer_points(self) -> np.ndarray:
        return self._poses[:, :3, 3]

    def get_scene_extent(self) -> float:
        return compute_scene_extent(self._poses[:, :3, 3])

    def get_scene_bbox(self):
        pts = self.get_point_clouds_xyz()
        if len(pts) == 0:
            pts = self.get_observer_points()
        lo = np.percentile(pts, 1, axis=0).astype(np.float32)
        hi = np.percentile(pts, 99, axis=0).astype(np.float32)
        return lo, hi

    # ------------------------------------------------------------------
    # point clouds (initialization)
    # ------------------------------------------------------------------

    def _point_cloud_source_ids(self,
                                source_ids: Optional[List[str]] = None):
        if source_ids is not None:
            return list(source_ids)
        if hasattr(self.seq, "point_cloud_source_ids"):
            return list(self.seq.point_cloud_source_ids)
        return list(self.lidar_ids)

    def get_point_clouds(self, source_ids: Optional[List[str]] = None,
                         non_dynamic_points_only: bool = True,
                         step_frame: int = 1):
        """Yield PointClouds per (source, frame), world frame
        (datasetNcore.py:930-1018): xyz_start = sensor origin per cloud,
        colors from the SDK attribute when available, dynamic-flagged
        points dropped by default."""
        for lid in self._point_cloud_source_ids(source_ids):
            n = self.seq.num_frames(lid)
            fidxs = range(0, n, max(step_frame, 1))
            if self._time_range_us is not None \
                    and hasattr(self.seq, "frame_timestamps_us"):
                ts = np.asarray(self.seq.frame_timestamps_us(lid), np.int64)
                fidxs = [i for i in fidxs
                         if self._time_range_us[0] <= ts[i]
                         < self._time_range_us[1]]
            for fidx in fidxs:
                xyz = np.asarray(
                    self.seq.lidar_points_world(lid, fidx), np.float32)
                color = None
                if hasattr(self.seq, "lidar_point_colors"):
                    c = self.seq.lidar_point_colors(
                        lid, fidx, self.lidar_color_generic_data_name)
                    if c is not None:
                        color = np.asarray(c, np.float32)
                        if color.max() > 1.5:
                            color = color / 255.0
                if non_dynamic_points_only \
                        and hasattr(self.seq, "lidar_point_flags"):
                    flags = self.seq.lidar_point_flags(lid, fidx)
                    if flags is not None:
                        keep = np.asarray(flags) != 1  # 1 ~ DYNAMIC
                        xyz = xyz[keep]
                        if color is not None:
                            color = color[keep]
                if hasattr(self.seq, "lidar_origin_world"):
                    origin = np.asarray(
                        self.seq.lidar_origin_world(lid, fidx), np.float32)
                else:
                    origin = np.zeros(3, np.float32)
                start = np.broadcast_to(origin, xyz.shape).copy()
                yield PointCloud(xyz_start=start, xyz_end=xyz, color=color)

    def get_point_clouds_xyz(self, **kw) -> np.ndarray:
        clouds = [pc.xyz_end for pc in self.get_point_clouds(**kw)]
        return (np.concatenate(clouds) if clouds
                else np.zeros((0, 3), np.float32))

    def load_lidar_init(self, num_points: Optional[int] = None):
        """(points, colors, observer_dist) for lidar initialization
        (model.init_from_lidar, reference model.py:693-730): optionally
        subsampled to num_points, with per-point distance to the
        emitting sensor for observation-scale initialization."""
        pts, cols, dists = [], [], []
        for pc in self.get_point_clouds():
            pts.append(pc.xyz_end)
            d = np.linalg.norm(pc.xyz_end - pc.xyz_start, axis=1)
            dists.append(d)
            cols.append(pc.color if pc.color is not None
                        else np.full((len(pc.xyz_end), 3), 0.5, np.float32))
        if not pts:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.float32),
                    np.zeros((0,), np.float32))
        pts = np.concatenate(pts)
        cols = np.concatenate(cols)
        dists = np.concatenate(dists)
        if num_points is not None and len(pts) > num_points:
            sel = self._rng.choice(len(pts), num_points, replace=False)
            pts, cols, dists = pts[sel], cols[sel], dists[sel]
        return pts, cols, dists

    # ------------------------------------------------------------------
    # image decode + per-camera caches
    # ------------------------------------------------------------------

    def _decode_image(self, cam_id: str, fidx: int) -> np.ndarray:
        """uint8 HWC at the target (downsampled) resolution: the SDK's
        encoded bytes through PIL, downscaled on decode, where the
        backend is "native" (JAX's native libjpeg path; the card has no
        libjpeg.so.62 for it); else the SDK's decoded image with a box
        mean (reference _decode_image, datasetNcore.py:722-761)."""
        ds = max(int(round(1.0 / self.downsample)), 1) \
            if self.downsample < 1.0 else 1
        if self.jpeg_backend_cpu == "native" \
                and hasattr(self.seq, "camera_frame_encoded"):
            encoded = self.seq.camera_frame_encoded(cam_id, fidx)
            if encoded is not None:
                return decode_jpeg(bytes(encoded), downsample=ds)
        img = np.asarray(self.seq.camera_image(cam_id, fidx))
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        if ds > 1:
            h2, w2 = img.shape[0] // ds, img.shape[1] // ds
            img = img[:h2 * ds, :w2 * ds].reshape(
                h2, ds, w2, ds, -1).mean(axis=(1, 3)).astype(np.uint8)
        return img

    def _intrinsics(self, cam_id: str) -> dict:
        if cam_id not in self._intr_cache:
            intr = dict(self.seq.camera_intrinsics(cam_id))
            if self.downsample < 1.0:
                ds = max(int(round(1.0 / self.downsample)), 1)
                for k in ("fx", "fy", "cx", "cy"):
                    if k in intr:
                        intr[k] = float(intr[k]) / ds
                if "angle_to_pixeldist" in intr:
                    intr["angle_to_pixeldist"] = [
                        v / ds for v in intr["angle_to_pixeldist"]]
                    intr["pixeldist_to_angle"] = list(np.polynomial
                                                      .polynomial.polyfit(
                        np.polynomial.polynomial.polyval(
                            np.linspace(0, float(intr.get(
                                "max_angle", np.pi / 2)), 256),
                            intr["angle_to_pixeldist"]),
                        np.linspace(0, float(intr.get(
                            "max_angle", np.pi / 2)), 256),
                        len(intr["pixeldist_to_angle"]) - 1))
            self._intr_cache[cam_id] = intr
        return self._intr_cache[cam_id]

    def camera_rays(self, cam_id: str, resolution):
        """Cached camera-space rays for a sensor (reference caches these
        per worker on GPU, datasetNcore.py:1019-1067; constant across
        frames, so computed once per camera here). An FTheta sensor gets
        pinhole rays of unit focal, as in JAX."""
        key = (cam_id, tuple(resolution))
        if key not in self._ray_cache:
            from ..ops.cameras import (fisheye_camera_rays,
                                       pinhole_camera_rays)
            intr = self._intrinsics(cam_id)
            w, h = resolution
            model = str(intr.get("model", "pinhole")).lower()
            if "fisheye" in model:
                o, d = fisheye_camera_rays(
                    w, h, (float(intr["fx"]), float(intr["fy"])),
                    (float(intr["cx"]), float(intr["cy"])),
                    [float(k) for k in intr.get("radial", [0.0] * 4)[:4]],
                    float(intr.get("max_angle", np.pi / 2)), device="cpu")
            else:
                o, d = pinhole_camera_rays(
                    w, h, intr.get("fx", 1.0), intr.get("fy", 1.0),
                    intr.get("cx", w / 2), intr.get("cy", h / 2))
            self._ray_cache[key] = (o.numpy().astype(np.float32),
                                    d.numpy().astype(np.float32))
        return self._ray_cache[key]

    def _camera_mask(self, cam_id: str, resolution):
        """Dilated valid-pixel mask at the render resolution, or None."""
        if not hasattr(self.seq, "camera_mask"):
            return None
        key = (cam_id, tuple(resolution))
        if key not in self._mask_cache:
            m = self.seq.camera_mask(cam_id)
            if m is None:
                self._mask_cache[key] = None
            else:
                m = np.asarray(m).astype(bool)
                m = _binary_dilate(m, self.n_mask_dilation)
                w, h = resolution
                if m.shape[:2] != (h, w):
                    ys = (np.arange(h) * m.shape[0] // h)
                    xs = (np.arange(w) * m.shape[1] // w)
                    m = m[ys][:, xs]
                self._mask_cache[key] = m[..., None].astype(np.float32)
        return self._mask_cache[key]

    # ------------------------------------------------------------------
    # batch assembly
    # ------------------------------------------------------------------

    def _intrinsics_kw(self, cam_id: str, resolution) -> dict:
        intr = self._intrinsics(cam_id)
        model = str(intr.get("model", "pinhole")).lower()
        kw = {}
        if "fisheye" in model:
            kw["intrinsics_OpenCVFisheyeCameraModelParameters"] = dict(
                fx=intr["fx"], fy=intr["fy"], cx=intr["cx"], cy=intr["cy"],
                radial=intr.get("radial", [0.0, 0.0, 0.0, 0.0]),
                max_angle=intr.get("max_angle", np.pi / 2))
        elif "ftheta" in model:
            kw["intrinsics_FThetaCameraModelParameters"] = dict(
                cx=intr["cx"], cy=intr["cy"],
                angle_to_pixeldist=intr["angle_to_pixeldist"],
                pixeldist_to_angle=intr["pixeldist_to_angle"],
                reference_poly=intr.get("reference_poly", 0),
                linear_cde=intr.get("linear_cde", (1.0, 0.0, 0.0)),
                max_angle=intr.get("max_angle", np.pi / 2))
        elif any(np.any(np.asarray(intr.get(k, 0.0)) != 0.0)
                 for k in ("radial", "tangential", "thin_prism")):
            kw["intrinsics_OpenCVPinholeCameraModelParameters"] = dict(
                fx=intr["fx"], fy=intr["fy"], cx=intr["cx"], cy=intr["cy"],
                radial=intr.get("radial", np.zeros(6)),
                tangential=intr.get("tangential", np.zeros(2)),
                thin_prism=intr.get("thin_prism", np.zeros(4)))
        return kw

    def _frame_batch(self, cam_id: str, fidx: int, index: int,
                     subsample: int = 1) -> Batch:
        img = self._decode_image(cam_id, fidx).astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        if subsample > 1:
            img = img[::subsample, ::subsample]
        h, w = img.shape[:2]
        t_start = np.asarray(self.seq.camera_pose(cam_id, fidx), np.float32)
        t_end = np.asarray(
            self.seq.camera_pose_shutter_end(cam_id, fidx), np.float32) \
            if hasattr(self.seq, "camera_pose_shutter_end") else None
        rays_o, rays_d = self.camera_rays(cam_id, (w * subsample,
                                                   h * subsample))
        if subsample > 1:
            rays_o = rays_o[::subsample, ::subsample]
            rays_d = rays_d[::subsample, ::subsample]
        mask = self._camera_mask(cam_id, (w * subsample, h * subsample))
        if mask is not None and subsample > 1:
            mask = mask[::subsample, ::subsample]
        intr = self._intrinsics(cam_id)
        shutter = getattr(self.seq, "shutter_type",
                          lambda _c: "global")(cam_id)
        return Batch(
            rays_ori=rays_o, rays_dir=rays_d,
            T_to_world=t_start, T_to_world_end=t_end,
            rgb_gt=img[..., :3], mask=mask,
            intrinsics=[intr.get("fx", 1.0), intr.get("fy", 1.0),
                        intr.get("cx", w / 2), intr.get("cy", h / 2)],
            shutter_type=shutter,
            frame_idx=index,
            camera_idx=self.camera_ids.index(cam_id),
            **self._intrinsics_kw(cam_id, (w, h)))

    def get_gpu_batch_with_intrinsics(self, index: int) -> Batch:
        """Batch contract of the reference NCore loader
        (datasetNcore.py:1068): shutter start/end poses, cached rays,
        masks, and native camera-model parameter dicts."""
        if self.split == "train" and not self.sample_full_image:
            # windowed ray sampling: random frame, random window_size^2
            # crop (reference train path, datasetNcore.py:775-830); the
            # batch keeps the full frame's intrinsics, as in JAX
            cam_id, fidx = self.frames[
                int(self._rng.integers(len(self.frames)))]
            b = self._frame_batch(cam_id, fidx, index)
            h, w = b.rgb_gt.shape[:2]
            ws = min(self.window_size, h, w)
            y0 = int(self._rng.integers(0, h - ws + 1))
            x0 = int(self._rng.integers(0, w - ws + 1))
            sl = (slice(y0, y0 + ws), slice(x0, x0 + ws))
            return dataclasses.replace(
                b, rgb_gt=b.rgb_gt[sl], rays_ori=b.rays_ori[sl],
                rays_dir=b.rays_dir[sl],
                mask=None if b.mask is None else b.mask[sl])
        cam_id, fidx = self.frames[index]
        subsample = (self.n_val_image_subsample
                     if self.split != "train" else 1)
        return self._frame_batch(cam_id, fidx, index, subsample=subsample)

    def __getitem__(self, index: int) -> Batch:
        return self.get_gpu_batch_with_intrinsics(index)
