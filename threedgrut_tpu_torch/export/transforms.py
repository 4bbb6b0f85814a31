"""Normalizing similarity transform estimation for export
(copied from threedgrut_tpu/export/transforms.py, numpy only).

Reference: threedgrut/export/transforms.py:195
(estimate_normalizing_transform): fit a similarity transform from the
camera poses so exported assets sit in a canonical, roughly unit-scale,
up-aligned frame.
"""

from __future__ import annotations

import numpy as np


def estimate_normalizing_transform(poses_c2w: np.ndarray) -> np.ndarray:
    """[N,4,4] camera-to-world poses -> 4x4 world-normalizing transform.

    Heuristic matching the reference's intent: recenter on the median
    camera position, scale so the median camera spread is 1, and rotate
    the average camera "down" (+y in the right-down-front convention) to
    the canonical -z up axis.
    """
    centers = poses_c2w[:, :3, 3]
    center = np.median(centers, axis=0)
    spread = np.median(np.linalg.norm(centers - center, axis=1))
    scale = 1.0 / max(spread, 1e-6)

    # average down vector of the cameras (+y column)
    down = poses_c2w[:, :3, 1].mean(axis=0)
    down /= max(np.linalg.norm(down), 1e-9)
    target = np.array([0.0, 0.0, 1.0])  # canonical down = +z after normalize
    v = np.cross(down, target)
    c = float(np.dot(down, target))
    if np.linalg.norm(v) < 1e-8:
        rot = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                       [-v[1], v[0], 0]])
        rot = np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))

    t = np.eye(4)
    t[:3, :3] = rot * scale
    t[:3, 3] = -rot @ center * scale
    return t


def apply_transform_to_gaussians(attrs: dict, transform: np.ndarray) -> dict:
    """Apply a similarity transform to raw gaussian attributes.

    attrs: dict with positions [N,3], rotation [N,4] (wxyz), scale [N,3]
    raw log-scales (exp activation assumed), other keys passed through.
    """
    out = dict(attrs)
    rot_scale = transform[:3, :3]
    s = float(np.cbrt(abs(np.linalg.det(rot_scale))))
    rot = rot_scale / s
    out["positions"] = attrs["positions"] @ rot_scale.T + transform[:3, 3]
    out["scale"] = attrs["scale"] + np.log(s)

    # rotate quaternions: q' = q_rot * q
    q_rot = _rotmat_to_quat(rot)
    q = attrs["rotation"]
    out["rotation"] = _quat_multiply(q_rot[None], q)
    return out


def _rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(r)))
        if i == 0:
            s = np.sqrt(1 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
            q = [(r[2, 1] - r[1, 2]) / s, 0.25 * s,
                 (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s]
        elif i == 1:
            s = np.sqrt(1 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
            q = [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s,
                 0.25 * s, (r[1, 2] + r[2, 1]) / s]
        else:
            s = np.sqrt(1 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
            q = [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
                 (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def _quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)
