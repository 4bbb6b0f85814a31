"""Windowed SSIM and PSNR (port of threedgrut_tpu/ops/ssim.py).

fused-ssim semantics with ``padding="valid"`` (threedgrut/model/
losses.py:31-33): 11x11 Gaussian window, sigma 1.5, C1 = 0.01^2,
C2 = 0.03^2, mean over the valid region. The blur is two separable
depthwise convolutions (H, then W) over the five moment maps at once; the
package switches cuDNN's TF32 off at import, so they run in fp32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timer import upload

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, size: int) -> torch.Tensor:
    """Separable valid-padding Gaussian blur of [B, C, H, W]."""
    c = img.shape[1]
    g = upload(_gaussian_window(size), img.device, img.dtype)
    out = F.conv2d(img, g.view(1, 1, size, 1).expand(c, 1, size, 1),
                   groups=c)
    return F.conv2d(out, g.view(1, 1, 1, size).expand(c, 1, 1, size),
                    groups=c)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """Per-window SSIM over the valid region. Inputs: [B, C, H, W] in
    [0,1]; returns [B, C, H-ws+1, W-ws+1]."""
    c = img1.shape[1]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                        dim=1)
    blurred = _blur(stacked, window_size)
    mu1, mu2, m11, m22, m12 = (blurred[:, i * c:(i + 1) * c]
                               for i in range(5))
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = m11 - mu1_sq
    sigma2_sq = m22 - mu2_sq
    sigma12 = m12 - mu12
    num = (2.0 * mu12 + C1) * (2.0 * sigma12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    return num / den


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over the valid region. Inputs: [B, C, H, W] in [0,1]."""
    return ssim_map(img1, img2, window_size).mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * np.log10(max_val) - 10.0 * torch.log10(
        torch.clamp(mse, min=1e-12))
