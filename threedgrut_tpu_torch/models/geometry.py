"""Geometry helpers (threedgrut/model/geometry.py equivalents; copied
from threedgrut_tpu/models/geometry.py, numpy and scipy)."""

from __future__ import annotations

import numpy as np


def k_nearest_neighbors(points: np.ndarray, k: int) -> np.ndarray:
    """Distances to the k nearest neighbors (incl. self at col 0)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    d, _ = tree.query(points, k=k)
    return d


def nearest_neighbor_dist_cpuKD(points: np.ndarray,
                                observers: np.ndarray) -> np.ndarray:
    """Distance of each point to the nearest observer position
    (geometry.py nearest_neighbor_dist_cpuKD)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(observers)
    d, _ = tree.query(points, k=1)
    return d


def apply_points_transform(points: np.ndarray,
                           transform: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to [N,3] points (geometry.py)."""
    if transform.shape != (4, 4):
        raise ValueError(f"expected (4,4) transform, got {transform.shape}")
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"expected [N,3] points, got {points.shape}")
    return points @ transform[:3, :3].T + transform[:3, 3]
