"""Per-image affine color correction for cc-metrics (port of
threedgrut_tpu/utils/color_correct.py).

Reference: threedgrut/utils/color_correct.py:96 (color_correct_affine) -
fit an affine transform (3x3 matrix + offset per image) from prediction to
ground truth by least squares and apply it, for the color-corrected
PSNR/SSIM variants reported by render_torch.py. The solve stays in the
inputs' float32, as JAX's does.
"""

from __future__ import annotations

import torch


def color_correct_affine(pred: torch.Tensor, gt: torch.Tensor,
                         clip: bool = True) -> torch.Tensor:
    """pred/gt: [..., 3] in [0,1]. Returns affine-corrected prediction."""
    p = pred.reshape(-1, 3)
    g = gt.reshape(-1, 3)
    ones = torch.ones((p.shape[0], 1), dtype=p.dtype, device=p.device)
    a = torch.cat([p, ones], dim=1)                      # [N, 4]
    # least squares: a @ w = g  ->  w = (a^T a)^-1 a^T g
    ata = a.T @ a + 1e-6 * torch.eye(4, dtype=p.dtype, device=p.device)
    atg = a.T @ g
    w = torch.linalg.solve(ata, atg)                     # [4, 3]
    out = (a @ w).reshape(pred.shape)
    return torch.clamp(out, 0.0, 1.0) if clip else out
