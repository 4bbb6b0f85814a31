"""Quaternion primitives (port of threedgrut_tpu/ops/quaternion.py).

Quaternions are (w, x, y, z), stored unnormalized and normalized on use.
``quat_to_rotmat`` returns the active rotation R (local -> world); the
canonical-frame transform of the hit model is ``R^T (x - pos)``.
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions along the last axis."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(norm, min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z), assumed normalized -> [..., 3, 3] rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz),
                        2.0 * (xz + wy)], dim=-1)
    row1 = torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz),
                        2.0 * (yz - wx)], dim=-1)
    row2 = torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx),
                        1.0 - 2.0 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t,
               eps: float = 1e-7) -> torch.Tensor:
    """Spherical interpolation between unit quaternions (w,x,y,z) along
    the short path, a lerp where they are nearly parallel (JAX
    ops/quaternion.py:47; reference sensors.h:54, tcnn::slerp). ``t``
    broadcasts against q[..., :1]; a scalar or a tensor of lower rank
    gains a trailing axis."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < eps
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() < dot.dim():
        t = t[..., None]
    safe = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)
