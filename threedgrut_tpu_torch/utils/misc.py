"""The jet map and the sRGB transfer of threedgrut_tpu/utils/misc.py:11-32,
on tensors."""

from __future__ import annotations

import torch


def jet_map(values: torch.Tensor, max_val: float) -> torch.Tensor:
    """1-channel map [..., 1] -> jet-colormapped RGB [..., 3]
    (threedgrut/utils/misc.py:138)."""
    vs = torch.clamp(values / max_val, 0.0, 1.0)
    r = (torch.clamp(4.0 * (vs - 0.375), 0, 1)
         * torch.clamp(-4.0 * (vs - 1.125), 0, 1))
    g = (torch.clamp(4.0 * (vs - 0.125), 0, 1)
         * torch.clamp(-4.0 * (vs - 0.875), 0, 1))
    b = (torch.clamp(4.0 * vs + 0.5, 0, 1)
         * torch.clamp(-4.0 * (vs - 0.625), 0, 1))
    return torch.cat([r, g, b], dim=-1)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 transfer (utils/post_processing_linear_to_srgb.py)."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=1e-8), 1 / 2.4)
                       - 0.055)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x + 0.055) / 1.055, 2.4))
