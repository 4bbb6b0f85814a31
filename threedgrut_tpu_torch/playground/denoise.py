"""Edge-avoiding à-trous wavelet denoiser for path-traced frames
(port of threedgrut_tpu/playground/denoise.py).

A stand-in for the reference playground's OptiX AI denoiser
(threedgrut_playground/src/hybridTracer.cpp:503 denoiser pass): the
edge-avoiding à-trous wavelet transform (Dammertz et al. 2010) with
edge-stop functions on colour, world normal and depth. Each iteration
applies the 5x5 B3-spline stencil at a dilated step through 25
edge-clamped shifts, on the frame's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# 5-tap B3-spline coefficients -> separable 5x5 stencil
_B3 = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[y, x] = img[clamp(y - dy), clamp(x - dx)]``: a shift with
    edge-clamp padding (channels last)."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) - dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) - dx, 0, w - 1)
    return img[ys][:, xs]


def atrous_denoise(rgb: torch.Tensor,
                   normals: Optional[torch.Tensor] = None,
                   depth: Optional[torch.Tensor] = None,
                   iterations: int = 4,
                   sigma_color: float = 0.25,
                   sigma_normal: float = 0.35,
                   sigma_depth: float = 0.5) -> torch.Tensor:
    """Denoise an [H, W, 3] frame.

    normals: optional [H, W, 3] guide (stops blur across creases).
    depth: optional [H, W] or [H, W, 1] guide (stops blur across
        silhouettes). Guides come free from the engine's AOVs.
    """
    img = rgb
    if depth is not None and depth.ndim == 2:
        depth = depth[..., None]
    inv_2sc2 = 1.0 / (2.0 * sigma_color * sigma_color)
    inv_2sn2 = 1.0 / (2.0 * sigma_normal * sigma_normal)
    inv_2sd2 = 1.0 / (2.0 * sigma_depth * sigma_depth)

    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(img)
        wsum = torch.zeros(img.shape[:2] + (1,), dtype=img.dtype,
                           device=img.device)
        for iy in range(-2, 3):
            for ix in range(-2, 3):
                k = float(_B3[iy + 2] * _B3[ix + 2])
                q = _shift2d(img, iy * step, ix * step)
                d2 = torch.sum((img - q) ** 2, dim=-1, keepdim=True)
                w = k * torch.exp(-d2 * inv_2sc2)
                if normals is not None:
                    qn = _shift2d(normals, iy * step, ix * step)
                    nd = torch.sum((normals - qn) ** 2, dim=-1,
                                   keepdim=True)
                    w = w * torch.exp(-nd * inv_2sn2)
                if depth is not None:
                    qd = _shift2d(depth, iy * step, ix * step)
                    dd = (depth - qd) ** 2
                    w = w * torch.exp(-dd * inv_2sd2)
                acc = acc + w * q
                wsum = wsum + w
        img = acc / torch.clamp(wsum, min=1e-8)
    return img
