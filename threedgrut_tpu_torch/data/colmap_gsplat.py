"""gsplat-parity COLMAP preprocessing (world normalization + image cache;
copied from threedgrut_tpu/data/colmap_gsplat.py, numpy and PIL).

Reproduces the preprocessing protocol the reference borrows from gsplat
(threedgrut/datasets/colmap_gsplat.py and the gsplat_image_downscale
branches of dataset_colmap.py) so metrics line up with gsplat-trained
baselines:

1. world normalization: rotate the average camera "up" onto the world
   -Y axis, translate so the median per-camera nearest-focus point sits
   at the origin, scale by the median camera distance; then PCA-align
   the sparse points (median-centered, descending eigenvalues,
   determinant fixed positive) and flip z when the point-cloud median
   exceeds its mean along z.
2. image pipeline: downscaled images are materialized once as PNGs at
   int(round(dim / factor)) via bicubic resampling, matched to COLMAP
   image names by sorted order, and intrinsics are corrected by the
   actual-size/expected-size ratio (width / (full_width // factor)).
"""

from __future__ import annotations

import os

import numpy as np


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:3, :3].T + m[:3, 3]


def transform_cameras(m: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """Similarity transform on camera-to-world matrices, rescaling the
    rotation blocks back to orthonormal."""
    out = np.einsum("ij,njk->nik", m, c2w)
    scale = np.linalg.norm(out[:, :3, 0], axis=1)
    if np.any(scale <= 0) or not np.all(np.isfinite(scale)):
        raise ValueError("degenerate camera scaling in gsplat normalization")
    out[:, :3, :3] = out[:, :3, :3] / scale[:, None, None]
    return out


def similarity_from_cameras(c2w: np.ndarray) -> np.ndarray:
    """Focus-centered similarity transform (gsplat protocol)."""
    t = c2w[:, :3, 3].astype(np.float64)
    rot = c2w[:, :3, :3].astype(np.float64)

    # mean camera-up (cameras look +z, up is -y in camera space)
    up_cam = np.array([0.0, -1.0, 0.0])
    ups = rot @ up_cam          # [N, 3] world-space up vectors
    world_up = ups.mean(axis=0)
    nrm = np.linalg.norm(world_up)
    if nrm <= 0 or not np.isfinite(nrm):
        raise ValueError("degenerate camera up vectors")
    world_up = world_up / nrm

    # rotation aligning world_up onto up_cam (Rodrigues via skew form)
    c = float(world_up @ up_cam)
    v = np.cross(world_up, up_cam)
    skew = np.array([[0.0, -v[2], v[1]],
                     [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])
    if c > -1.0:
        r_align = np.eye(3) + skew + skew @ skew / (1.0 + c)
    else:
        r_align = np.diag([-1.0, 1.0, 1.0])

    rot_a = np.einsum("ij,njk->nik", r_align, rot)
    t_a = t @ r_align.T
    fwd = rot_a[:, :, 2]        # camera forward in aligned world

    # per-camera point nearest the origin along its view ray
    nearest = t_a + np.sum(fwd * (-t_a), axis=-1)[:, None] * fwd
    translate = -np.median(nearest, axis=0)
    med = np.median(np.linalg.norm(t_a + translate, axis=-1))
    if med <= 0 or not np.isfinite(med):
        raise ValueError("degenerate camera distances")

    m = np.eye(4)
    m[:3, :3] = r_align
    m[:3, 3] = translate
    m[:3, :] /= med
    return m


def align_principal_axes(points: np.ndarray) -> np.ndarray:
    """Median-centered PCA alignment (descending eigenvalues, right-
    handed)."""
    center = np.median(points, axis=0)
    cov = np.cov(points - center, rowvar=False)
    evals, evecs = np.linalg.eigh(cov)
    evecs = evecs[:, np.argsort(evals)[::-1]]
    if np.linalg.det(evecs) < 0:
        evecs[:, 0] = -evecs[:, 0]
    m = np.eye(4)
    m[:3, :3] = evecs.T
    m[:3, 3] = -evecs.T @ center
    return m


def normalize_world_space(c2w: np.ndarray, points: np.ndarray):
    """Full gsplat normalization; returns (cameras, points, transform)."""
    t1 = similarity_from_cameras(c2w)
    cams = transform_cameras(t1, c2w)
    pts = transform_points(t1, points)
    t2 = align_principal_axes(pts)
    cams = transform_cameras(t2, cams)
    pts = transform_points(t2, pts)
    transform = t2 @ t1
    if np.median(pts[:, 2]) > np.mean(pts[:, 2]):
        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        cams = transform_cameras(flip, cams)
        pts = transform_points(flip, pts)
        transform = flip @ transform
    return cams, pts, transform


def scene_scale(c2w: np.ndarray) -> float:
    centers = c2w[:, :3, 3]
    mean = centers.mean(axis=0)
    return float(np.max(np.linalg.norm(centers - mean, axis=1)))


def build_downscale_cache(src_dir: str, dst_dir: str, factor: int) -> str:
    """Materialize the bicubic int(round(dim/factor)) PNG cache once."""
    from PIL import Image

    os.makedirs(dst_dir, exist_ok=True)
    names = sorted(os.listdir(src_dir))
    for name in names:
        src = os.path.join(src_dir, name)
        if not os.path.isfile(src):
            continue
        dst = os.path.join(dst_dir, os.path.splitext(name)[0] + ".png")
        if os.path.isfile(dst):
            continue
        with Image.open(src) as im:
            im = im.convert("RGB")
            size = (int(round(im.width / factor)),
                    int(round(im.height / factor)))
            im.resize(size, Image.Resampling.BICUBIC).save(dst)
    return dst_dir


def sorted_name_mapping(colmap_dir: str, image_dir: str) -> dict:
    """COLMAP image name -> working-dir file name, matched by sorted
    order (the directories may differ in extension after caching)."""
    a = sorted(f for f in os.listdir(colmap_dir)
               if os.path.isfile(os.path.join(colmap_dir, f)))
    b = sorted(f for f in os.listdir(image_dir)
               if os.path.isfile(os.path.join(image_dir, f)))
    if len(a) != len(b):
        raise ValueError(
            f"image count mismatch: {colmap_dir} has {len(a)}, "
            f"{image_dir} has {len(b)}")
    return dict(zip(a, b))
