"""Real spherical-harmonics radiance, degrees 0..3
(port of threedgrut_tpu/ops/sh.py; constants and basis order of the
reference gaussianParticles.cuh:61-100)."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """[..., 3] unit directions -> [..., (degree+1)**2] basis values."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        comps += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        comps += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(comps, dim=-1)


def eval_sh_radiance(coeffs: torch.Tensor, dirs: torch.Tensor, degree: int,
                     clamped: bool = True) -> torch.Tensor:
    """[..., K, 3] coefficients at [..., 3] unit directions -> [..., 3]
    radiance (basis . coeffs + 0.5, clamped at 0 by default)."""
    basis = sh_basis(dirs, degree)
    nb = basis.shape[-1]
    rad = torch.einsum("...k,...kc->...c", basis, coeffs[..., :nb, :]) + 0.5
    if clamped:
        rad = torch.clamp(rad, min=0.0)
    return rad


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] -> 0th SH coefficient."""
    return (rgb - 0.5) / SH_C0
