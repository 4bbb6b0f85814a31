"""Ray <-> Gaussian-particle hit model (port of threedgrut_tpu/ops/hit.py).

Max response along the ray in the particle's canonical frame
(reference gaussianParticles.slang:206-243): the render oracle uses
``density_hit``; the raster kernel uses the same response through
``particle_response``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .quaternion import quat_normalize, quat_to_rotmat

# Generalized-Gaussian scale factors s = -4.5 / 3**n
# (gaussianParticles.cuh:267-308); degree 0 is the linear kernel.
_GG_SCALE = {
    1: -1.5,
    2: -0.5,
    3: -0.166666666667,
    4: -0.0555555555556,
    5: -0.0185185185185,
    8: -0.000685871056241,
}
_LINEAR_SCALE = -0.329630334487


def particle_response(sq_dist: torch.Tensor, kernel_degree: int) -> torch.Tensor:
    """Generalized-Gaussian response of the squared canonical distance."""
    d = sq_dist
    if kernel_degree == 0:
        return torch.clamp(1.0 + _LINEAR_SCALE * torch.sqrt(d), min=0.0)
    s = _GG_SCALE[kernel_degree]
    if kernel_degree == 1:
        return torch.exp(s * torch.sqrt(d))
    if kernel_degree == 2:
        return torch.exp(s * d)
    if kernel_degree == 3:
        return torch.exp(s * d * torch.sqrt(d))
    if kernel_degree == 4:
        return torch.exp(s * d * d)
    if kernel_degree == 5:
        return torch.exp(s * d * d * torch.sqrt(d))
    if kernel_degree == 8:
        dd = d * d
        return torch.exp(s * dd * dd)
    raise ValueError(f"unsupported kernel degree {kernel_degree}")


def particle_response_dsq(sq_dist: torch.Tensor, response: torch.Tensor,
                          kernel_degree: int) -> torch.Tensor:
    """d(particle_response)/d(sq_dist) given the forward response (the
    raster backward's pullback; csrc/raster_bwd.cu has degree 2)."""
    d = sq_dist
    if kernel_degree == 0:
        inv_sqrt = torch.rsqrt(torch.clamp(d, min=1e-18))
        return torch.where(response > 0.0, 0.5 * _LINEAR_SCALE * inv_sqrt,
                           torch.zeros_like(d))
    s = _GG_SCALE[kernel_degree]
    if kernel_degree == 1:
        return response * s * 0.5 * torch.rsqrt(torch.clamp(d, min=1e-18))
    if kernel_degree == 2:
        return response * s
    if kernel_degree == 3:
        return response * s * 1.5 * torch.sqrt(d)
    if kernel_degree == 4:
        return response * s * 2.0 * d
    if kernel_degree == 5:
        return response * s * 2.5 * d * torch.sqrt(d)
    if kernel_degree == 8:
        return response * s * 4.0 * d * d * d
    raise ValueError(f"unsupported kernel degree {kernel_degree}")


class HitResult(NamedTuple):
    alpha: torch.Tensor      # compositing alpha (0 where rejected)
    hit_t: torch.Tensor      # world-space distance of max response
    accept: torch.Tensor     # bool acceptance mask


def density_hit(ray_o, ray_d, pos, quat, scale, density, *,
                kernel_degree: int = 2, min_response: float = 0.0113,
                min_alpha: float = 1.0 / 255.0,
                max_alpha: float = 0.99) -> HitResult:
    """Alpha + hit distance of rays against particles (leading dims
    broadcast; ``density`` is the post-activation opacity)."""
    rot = quat_to_rotmat(quat_normalize(quat))

    def to_local(v):   # world -> local: R^T v, broadcasting leading dims
        return torch.stack([v[..., 0] * rot[..., 0, j] + v[..., 1] * rot[..., 1, j]
                            + v[..., 2] * rot[..., 2, j] for j in range(3)],
                           dim=-1)

    gposcr = to_local(ray_o - pos)
    ray_d_r = to_local(ray_d)
    inv_scale = 1.0 / scale
    gro = inv_scale * gposcr
    grdu = inv_scale * ray_d_r
    grd = grdu * torch.rsqrt(torch.clamp(
        torch.sum(grdu * grdu, dim=-1, keepdim=True), min=1e-32))
    gcrod = torch.cross(grd, gro, dim=-1)
    sq_dist = torch.sum(gcrod * gcrod, dim=-1)
    response = particle_response(sq_dist, kernel_degree)
    alpha = torch.clamp(response * density, max=max_alpha)
    accept = (response > min_response) & (alpha > min_alpha)

    proj = torch.sum(grd * (-gro), dim=-1)
    grds = scale * grd * proj[..., None]
    hit_t = torch.sqrt(torch.clamp(torch.sum(grds * grds, dim=-1),
                                   min=1e-18))
    hit_t = torch.where(proj < 0.0, -hit_t, hit_t)
    alpha = torch.where(accept, alpha, torch.zeros_like(alpha))
    return HitResult(alpha=alpha, hit_t=hit_t, accept=accept)
