"""Camera trajectories and video output for the playground
(port of threedgrut_tpu/playground/video.py).

Reference equivalents: threedgrut_playground/utils (video out,
interpolated camera trajectories). Encodes with imageio where it
imports, else writes a directory of PNG frames.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch


def interpolate_poses(poses_c2w: np.ndarray, n_frames: int) -> np.ndarray:
    """Smooth closed-loop fly-through through the given c2w poses
    (linear on positions, slerp on orientations)."""
    from ..export.transforms import _rotmat_to_quat

    n = len(poses_c2w)
    out = []
    for f in range(n_frames):
        t = f / n_frames * n
        i0 = int(np.floor(t)) % n
        i1 = (i0 + 1) % n
        a = t - np.floor(t)
        p = (1 - a) * poses_c2w[i0, :3, 3] + a * poses_c2w[i1, :3, 3]
        q0 = _rotmat_to_quat(poses_c2w[i0, :3, :3])
        q1 = _rotmat_to_quat(poses_c2w[i1, :3, :3])
        if np.dot(q0, q1) < 0:
            q1 = -q1
        dot = np.clip(np.dot(q0, q1), -1, 1)
        theta = np.arccos(dot)
        if theta < 1e-5:
            q = q0
        else:
            q = (np.sin((1 - a) * theta) * q0 + np.sin(a * theta) * q1) \
                / np.sin(theta)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = r
        m[:3, 3] = p
        out.append(m)
    return np.stack(out)


def write_video(frames: List[np.ndarray], path: str, fps: int = 30) -> str:
    """Encode uint8 RGB frames to ``path`` with imageio; where that fails
    (no imageio, no ffmpeg), write them as PNG files into
    ``<path without extension>_frames/``. Returns what was written."""
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames, fps=fps)
        return path
    except Exception:
        from PIL import Image

        d = os.path.splitext(path)[0] + "_frames"
        os.makedirs(d, exist_ok=True)
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(d, f"{i:05d}.png"))
        return d


def bilateral_denoise(img, sigma_spatial: float = 2.0,
                      sigma_color: float = 0.1, radius: int = 3
                      ) -> np.ndarray:
    """A bilateral filter over wrapped shifts of an [H, W, C] frame (a
    stand-in for the reference's OptiX AI denoiser toggle,
    hybridTracer.cpp:503), on the frame's device when it is a tensor;
    returns numpy."""
    x = torch.as_tensor(img, dtype=torch.float32)
    h, w = x.shape[:2]
    acc = torch.zeros_like(x)
    norm = torch.zeros((h, w, 1), dtype=torch.float32, device=x.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = torch.roll(x, (dy, dx), dims=(0, 1))
            wsp = float(np.exp(-(dx * dx + dy * dy)
                               / (2 * sigma_spatial ** 2)))
            wcol = torch.exp(-torch.sum((shifted - x) ** 2, -1, keepdim=True)
                             / (2 * sigma_color ** 2))
            wgt = wsp * wcol
            acc = acc + shifted * wgt
            norm = norm + wgt
    return (acc / norm).cpu().numpy()
