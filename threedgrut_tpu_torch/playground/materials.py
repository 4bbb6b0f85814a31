"""Batched Cook-Torrance microfacet BRDF sampling for the playground
(port of threedgrut_tpu/playground/materials.py).

The reference's stochastic path-tracer material (threedgrut_playground
materials.cuh:248 sampled_microfacet_brdf): a per-ray uniform draw picks
the transmissive, diffuse or specular lobe, each importance-sampled from
the GGX distribution, with Schlick Fresnel and Smith geometry terms; the
returned factor multiplies the path throughput. As in JAX, all three
lobes are evaluated for every ray and the draw selects among them.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-4


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _pdot(a, b):
    return torch.clamp(_dot(a, b), min=0.0)


def _normalize(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def normal_space(normal, local_dir):
    """Rotate a tangent-space direction (z up) into the frame of
    ``normal`` (materials.cuh:124 compute_normal_space)."""
    nx, ny, nz = normal[..., 0:1], normal[..., 1:2], normal[..., 2:3]
    zero = torch.zeros_like(nx)
    t = torch.where(torch.abs(nx) > torch.abs(ny),
                    torch.cat([-ny, nx, zero], dim=-1),
                    torch.cat([zero, -nz, ny], dim=-1))
    t = _normalize(t)
    b = torch.linalg.cross(normal, t)
    return (local_dir[..., 0:1] * t + local_dir[..., 1:2] * b
            + local_dir[..., 2:3] * normal)


def _hemisphere(normal, cos_t, sin_t, u_phi):
    phi = 2.0 * math.pi * u_phi
    local = torch.cat([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                       cos_t], dim=-1)
    return normal_space(normal, local)


def sample_diffuse_ggx(normal, u_theta, u_phi):
    """Cosine-weighted hemisphere sample about ``normal``."""
    return _hemisphere(normal, torch.sqrt(torch.clamp(1.0 - u_theta, 0, 1)),
                       torch.sqrt(torch.clamp(u_theta, 0, 1)), u_phi)


def sample_specular_ggx(normal, u_theta, u_phi, roughness):
    """GGX-distributed half-vector sample about ``normal``."""
    a = roughness * roughness
    cos2 = (1.0 - u_theta) / torch.clamp(1.0 + (a * a - 1.0) * u_theta,
                                         min=_EPS)
    return _hemisphere(normal, torch.sqrt(torch.clamp(cos2, 0, 1)),
                       torch.sqrt(torch.clamp(1.0 - cos2, 0, 1)), u_phi)


def ggx_distribution(h, normal, roughness):
    """Trowbridge-Reitz normal distribution (materials.cuh:196)."""
    a2 = (roughness * roughness) ** 2
    ndh = _pdot(normal, h)
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * denom * denom, min=_EPS)


def _geometry_schlick(ndv, roughness):
    k = 0.5 * roughness * roughness
    return ndv / torch.clamp(ndv * (1.0 - k) + k, min=_EPS)


def geometry_smith(ndo, ndi, roughness):
    return (_geometry_schlick(ndo, roughness)
            * _geometry_schlick(ndi, roughness))


def fresnel_schlick(cosine, f0):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cosine, 0, 1), 5.0)


def refract(wi, normal, eta):
    """Snell refraction of ``wi`` (materials.cuh:227 pbr_refract on -wo);
    0 on total internal reflection."""
    ndw = _dot(normal, wi)
    k = 1.0 - eta * eta * (1.0 - ndw * ndw)
    refr = eta * wi - (eta * ndw + torch.sqrt(torch.clamp(k, min=0.0))) \
        * normal
    return torch.where(k < 0.0, torch.zeros_like(refr), refr)


def sample_microfacet_brdf(wo, normal, base_color, metallic, roughness,
                           transmission, ior, rand3):
    """One stochastic microfacet-BRDF bounce for a batch of rays.

    Args:
        wo: [R, 3] unit direction from the hit point toward the viewer.
        normal: [R, 3] unit shading normals.
        base_color / metallic / roughness / transmission / ior: [R, k]
            per-ray material parameters (k = 3 or 1).
        rand3: [R, 3] uniforms in [0, 1): (phi, theta, lobe choice).
    Returns:
        (next_dir [R, 3], factor [R, 3]): the scattered direction and the
        throughput multiplier, with the x2 lobe-split compensation
        (materials.cuh:343).
    """
    u_phi, u_theta, p = rand3[:, 0:1], rand3[:, 1:2], rand3[:, 2:3]
    fresnel_reflect = 0.5
    f0 = torch.full_like(base_color,
                         0.16 * fresnel_reflect * fresnel_reflect)
    f0 = f0 * (1.0 - metallic) + base_color * metallic

    # transmissive lobe: GGX half-vector about the forward normal
    front = _dot(wo, normal) >= 0.0
    fnormal = torch.where(front, normal, -normal)
    eta = torch.where(front, 1.0 / ior, ior)
    h_t = sample_specular_ggx(fnormal, u_theta, u_phi, roughness)
    l_trans = refract(-wo, h_t, eta)
    f_t = fresnel_schlick(_pdot(wo, h_t), f0)
    g_t = geometry_smith(_pdot(fnormal, wo), _pdot(-fnormal, l_trans),
                         roughness)
    factor_trans = (base_color * (1.0 - f_t) * g_t * _pdot(wo, h_t)
                    / torch.clamp(_pdot(fnormal, h_t) * _pdot(fnormal, wo),
                                  min=1e-3))

    # diffuse lobe: cosine hemisphere, energy (1 - F)(1 - metal) base
    l_diff = sample_diffuse_ggx(normal, u_theta, u_phi)
    f_d = fresnel_schlick(_pdot(wo, _normalize(wo + l_diff)), f0)
    factor_diff = (1.0 - f_d) * (1.0 - metallic) * base_color

    # specular lobe: GGX half-vector reflection
    h_s = sample_specular_ggx(normal, u_theta, u_phi, roughness)
    l_spec = -wo - 2.0 * _dot(h_s, -wo) * h_s
    f_s = fresnel_schlick(_pdot(wo, h_s), f0)
    g_s = geometry_smith(_pdot(normal, wo), _pdot(normal, l_spec),
                         roughness)
    factor_spec = (f_s * g_s * _pdot(wo, h_s)
                   / torch.clamp(_pdot(normal, h_s) * _pdot(normal, wo),
                                 min=1e-3))

    # the reference's split probabilities
    choose_trans = (p < 0.5) & (2.0 * p < transmission)
    choose_diff = (p < 0.5) & ~choose_trans
    next_dir = torch.where(choose_trans, l_trans,
                           torch.where(choose_diff, l_diff, l_spec))
    factor = torch.where(choose_trans, factor_trans,
                         torch.where(choose_diff, factor_diff, factor_spec))
    return _normalize(next_dir), torch.clamp(factor * 2.0, min=0.0)
