"""Ray <-> Gaussian-particle hit model (port of threedgrut_tpu/ops/hit.py),
and the NHT features at the hit (JAX ops/pallas/raster.py:566-650).

Max response along the ray in the particle's canonical frame
(reference gaussianParticles.slang:206-243): the render oracle uses
``density_hit``; the raster kernel uses the same response through
``particle_response``. An NHT particle carries a feature vector at each
vertex of a canonical tetrahedron; a ray reads their barycentric blend at
its canonical hit point, through sin and cos
(neuralHarmonicFeaturesParticle.slang).
"""

from __future__ import annotations

import math
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
    canonical: torch.Tensor  # [..., 3] canonical-frame hit point (NHT)


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
    canonical = gro + grd * proj[..., None]
    alpha = torch.where(accept, alpha, torch.zeros_like(alpha))
    return HitResult(alpha=alpha, hit_t=hit_t, accept=accept,
                     canonical=canonical)


def hit_normal(ray_o, ray_d, pos, quat, scale):
    """Per-hit world normal (JAX ops/hit.py:hit_normal; the reference's
    gaussianParticles.cuh:397-401): the ray's entry point into the
    particle's 3-sigma canonical ellipsoid, scaled elementwise by R s and
    normalised (leading dims broadcast)."""
    rot = quat_to_rotmat(quat_normalize(quat))

    def to_local(v):   # world -> local: R^T v
        return torch.stack([v[..., 0] * rot[..., 0, j] + v[..., 1] * rot[..., 1, j]
                            + v[..., 2] * rot[..., 2, j] for j in range(3)],
                           dim=-1)

    gro = to_local(ray_o - pos) / scale
    grdu = to_local(ray_d) / scale
    grd = grdu * torch.rsqrt(torch.clamp(
        torch.sum(grdu * grdu, dim=-1, keepdim=True), min=1e-32))
    gcrod = torch.cross(grd, gro, dim=-1)
    sq_dist = torch.sum(gcrod * gcrod, dim=-1, keepdim=True)
    proj = torch.sum(grd * (-gro), dim=-1, keepdim=True)
    entry = gro + grd * (proj - torch.sqrt(torch.clamp(9.0 - sq_dist,
                                                        min=0.0)))
    rs = torch.einsum("...ji,...i->...j", rot, scale)
    n = entry * rs
    return n * torch.rsqrt(torch.clamp(torch.sum(n * n, dim=-1,
                                                 keepdim=True), min=1e-24))


# The canonical regular tetrahedron (neuralHarmonicFeaturesParticle.slang:
# 47-66): its vertices, and the rows of the inverse edge matrix that map a
# point's offset from vertex 0 to barycentric weights 1-3
# (raster.py:_tetra_constants). The kernels (csrc/common.cuh) hold the
# same values rounded to fp32.
_EDGE = math.sqrt(24.0)
_FACE_IN_R = math.sqrt(2.0)
TETRA_VERTS = ((0.5 * _EDGE, -_FACE_IN_R, -1.0),
               (-0.5 * _EDGE, -_FACE_IN_R, -1.0),
               (0.0, _EDGE * math.sqrt(3.0) / 2.0 - _FACE_IN_R, -1.0),
               (0.0, 0.0, 3.0))


def _tetra_constants():
    v = torch.tensor(TETRA_VERTS, dtype=torch.float64)
    e1, e2, e3 = v[1] - v[0], v[2] - v[0], v[3] - v[0]
    det = float(torch.dot(e1, torch.linalg.cross(e2, e3)))
    return (v[0].tolist(), (torch.linalg.cross(e2, e3) / det).tolist(),
            (torch.linalg.cross(e3, e1) / det).tolist(),
            (torch.linalg.cross(e1, e2) / det).tolist())


TETRA_V0, TETRA_G1, TETRA_G2, TETRA_G3 = _tetra_constants()


def tetra_barycentric(cpx, cpy, cpz):
    """Barycentric weights (w0, w1, w2, w3) of canonical points in the
    canonical tetrahedron (raster.py:tetra_barycentric; the reference's
    barycentricTetrahedronCanonical)."""
    dx = cpx - TETRA_V0[0]
    dy = cpy - TETRA_V0[1]
    dz = cpz - TETRA_V0[2]
    w1 = TETRA_G1[0] * dx + TETRA_G1[1] * dy + TETRA_G1[2] * dz
    w2 = TETRA_G2[0] * dx + TETRA_G2[1] * dy + TETRA_G2[2] * dz
    w3 = TETRA_G3[0] * dx + TETRA_G3[1] * dy + TETRA_G3[2] * dz
    w0 = 1.0 - w1 - w2 - w3
    return w0, w1, w2, w3


def nht_hit_features(features: torch.Tensor, canonical: torch.Tensor
                     ) -> torch.Tensor:
    """The ray features of NHT particles at canonical hit points
    (raster.py:nht_hit_features, one sincos frequency).

    ``features`` [..., 4 d] holds each particle's d control features per
    tetrahedron vertex, vertex-major; ``canonical`` [..., 3] the hit
    points (the leading dims broadcast). Returns [..., 2 d]: for each
    control dim k the blend b_k = sum_v w_v f[v d + k], then sin(b_k),
    cos(b_k), interleaved as (sin, cos) pairs."""
    d = features.shape[-1] // 4
    w = tetra_barycentric(canonical[..., 0], canonical[..., 1],
                          canonical[..., 2])
    blend = sum(w[v][..., None] * features[..., v * d:(v + 1) * d]
                for v in range(4))
    return torch.stack([torch.sin(blend), torch.cos(blend)],
                       dim=-1).flatten(-2)
