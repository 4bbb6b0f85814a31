"""Trajectory view sampling for the SH bake (copied from
threedgrut_tpu/export/view_interpolation.py, numpy only).

The bake fits SH coefficients against ISP'd target renders; fitting only
the training views overfits their exact poses, so the reference offers a
``trajectory`` sampling mode (threedgrut/export/usd/post_processing/
view_interpolation.py): order the training views along an approximate
smooth path (nearest-neighbour chain + 2-opt improvement on a combined
position/viewing-direction metric), arc-length-parameterise it on
[0, 1], and draw poses at arbitrary ``t`` by slerping inside the
bracketing segment. Per-frame ISP parameters (exposure, color latents)
are linearly interpolated with the same segment weight.

All double-precision numpy — this runs once on the host per bake.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    """3x3 rotation -> unit quaternion [w, x, y, z]."""
    r = np.asarray(r, np.float64)
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                         (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 0.0)) * 2.0
    q = np.empty(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q / np.linalg.norm(q)


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0: np.ndarray, q1: np.ndarray, s: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 1.0 - 1e-9:
        q = (1.0 - s) * q0 + s * q1
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    return (np.sin((1.0 - s) * th) * q0 + np.sin(s * th) * q1) / np.sin(th)


def slerp_pose(pose_a: np.ndarray, pose_b: np.ndarray, s: float) -> np.ndarray:
    """Interpolate 4x4 c2w poses: quaternion slerp + translation lerp."""
    a = np.asarray(pose_a, np.float64)
    b = np.asarray(pose_b, np.float64)
    out = np.eye(4)
    out[:3, :3] = _quat_to_rot(
        _slerp(_rot_to_quat(a[:3, :3]), _rot_to_quat(b[:3, :3]), s))
    out[:3, 3] = (1.0 - s) * a[:3, 3] + s * b[:3, 3]
    return out


def _pose_metric(poses: np.ndarray, w_pos: float, w_rot: float) -> np.ndarray:
    """Pairwise path cost: normalized position L2 + forward-axis angle."""
    pos = poses[:, :3, 3]
    fwd = poses[:, :3, 2]
    fwd = fwd / np.maximum(np.linalg.norm(fwd, axis=1, keepdims=True), 1e-12)
    dp = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    scale = float(dp[dp > 0].mean()) if (dp > 0).any() else 1.0
    dr = 1.0 - np.clip(fwd @ fwd.T, -1.0, 1.0)
    return w_pos * dp / max(scale, 1e-9) + w_rot * dr


def order_views_along_trajectory(
        poses: np.ndarray, w_pos: float = 1.0, w_rot: float = 0.5,
        two_opt_passes: int = 50) -> Tuple[List[int], np.ndarray]:
    """Approximate Hamiltonian path over the views.

    Returns (ordered_indices, cum_t) with cum_t the arc-length parameter
    in [0, 1] of each ordered pose.
    """
    poses = np.asarray(poses, np.float64)
    n = poses.shape[0]
    if n < 2:
        return list(range(n)), np.zeros(max(n, 1))
    d = _pose_metric(poses, w_pos, w_rot)

    # greedy nearest-neighbour chain
    order, seen = [0], {0}
    while len(order) < n:
        row = d[order[-1]].copy()
        row[list(seen)] = np.inf
        nxt = int(np.argmin(row))
        order.append(nxt)
        seen.add(nxt)

    # 2-opt: untangle crossings until a pass makes no improvement
    for _ in range(two_opt_passes):
        improved = False
        for i in range(1, n - 2):
            for j in range(i + 1, n - 1):
                a, b = order[i - 1], order[i]
                c, e = order[j], order[j + 1]
                if d[a, c] + d[b, e] + 1e-12 < d[a, b] + d[c, e]:
                    order[i:j + 1] = order[i:j + 1][::-1]
                    improved = True
        if not improved:
            break

    cum = np.zeros(n)
    for k in range(1, n):
        cum[k] = cum[k - 1] + d[order[k - 1], order[k]]
    if cum[-1] > 0:
        cum /= cum[-1]
    return order, cum


class TrajectoryViewSampler:
    """Draw synthetic views on the smoothed training trajectory.

    ``sample(t)`` returns (c2w pose, (frame_lo, frame_hi, weight)) where
    the frame pair brackets ``t`` in path order — the weight interpolates
    any per-frame quantity (ISP exposure/latents) consistently with the
    pose.
    """

    def __init__(self, poses: np.ndarray, w_pos: float = 1.0,
                 w_rot: float = 0.5, seed: int = 0):
        self.poses = np.asarray(poses, np.float64)
        self.order, self.cum_t = order_views_along_trajectory(
            self.poses, w_pos, w_rot)
        self._rng = np.random.default_rng(seed)

    def sample(self, t: float):
        t = float(np.clip(t, 0.0, 1.0))
        k = int(np.searchsorted(self.cum_t, t, side="right")) - 1
        k = min(max(k, 0), len(self.order) - 2)
        lo, hi = self.order[k], self.order[k + 1]
        seg = self.cum_t[k + 1] - self.cum_t[k]
        s = (t - self.cum_t[k]) / seg if seg > 0 else 0.0
        return slerp_pose(self.poses[lo], self.poses[hi], s), (lo, hi, s)

    def sample_random(self):
        return self.sample(float(self._rng.uniform()))

    def interpolate_frame_values(self, values: np.ndarray, lo: int,
                                 hi: int, s: float) -> np.ndarray:
        """Lerp per-frame quantities (exposure, color latents) with the
        pose's segment weight."""
        v = np.asarray(values)
        return (1.0 - s) * v[lo] + s * v[hi]
