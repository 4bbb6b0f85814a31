"""Hybrid 3DGRUT playground engine, headless
(port of threedgrut_tpu/playground/engine.py).

The JAX engine's path tracer over every pixel at once: primary and
secondary rays alternate analytic closest hits against mesh primitives
(glass, mirror, diffuse, PBR) with the volumetric Gaussian segment up to
the hit, traced by ``render/grt.py:trace`` (the raster kernels' trace
modes on the card); environment maps shade misses; SPP jitter and a
thin-lens aperture accumulate progressively. A fixed loop of
``max_bounces`` with masked state updates, as in JAX.
``EngineConfig(denoise=True)`` denoises the finished frame on the
model's device with the learned CNN (``denoise_cnn.py``) or the
à-trous filter (``denoise.py``), as ``denoiser`` names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ..models.gaussians import GaussianModel
from ..render.grt import trace
from .materials import sample_microfacet_brdf
from .mesh import Mesh, load_glb_scene, make_intersector
from .sampling import SPP, DepthOfField, pcg3d_float

_KINDS = {"diffuse": 0, "mirror": 1, "glass": 2, "pbr": 3}


@dataclasses.dataclass
class PBRMaterial:
    """threedgrut_playground/engine.py:98 (PBRMaterial)."""
    kind: str = "diffuse"          # diffuse | mirror | glass | pbr
    base_color: tuple = (0.8, 0.8, 0.8)
    roughness: float = 0.4
    metallic: float = 0.0
    ior: float = 1.45
    emissive: tuple = (0.0, 0.0, 0.0)
    transmission: float = 0.0      # PBR refraction lobe weight
    # texture maps [H, W, 3+] in [0, 1] sampled at the hit's TEXCOORD_0
    # uv; the factors multiply the texel (glTF 2.0). None: factor only
    diffuse_map: Optional[object] = None
    emissive_map: Optional[object] = None


@dataclasses.dataclass
class EngineConfig:
    max_bounces: int = 4
    spp: int = 1
    spp_mode: str = "msaa"   # none|independent_random|msaa|low_discrepancy_seq
    aperture: float = 0.0          # depth of field (0 = pinhole)
    focus_distance: float = 3.0
    gaussian_sh_degree: int = 3
    denoise: bool = False          # denoiser pass on the finished frame
    # "cnn" = the learned residual CNN (denoise_cnn.py, the analogue of
    # the reference's OptiX AI denoiser pass, hybridTracer.cpp:503),
    # falling through to the à-trous filter without its weights file;
    # "atrous" = the edge-avoiding à-trous filter (denoise.py)
    denoiser: str = "cnn"


class EnvironmentMap:
    """Lat-long environment lookup (engine.py envmap path)."""

    def __init__(self, image: Optional[np.ndarray] = None,
                 constant=(0.5, 0.6, 0.8), device="cpu"):
        self.image = None
        self.constant = None
        if image is None:
            self.constant = torch.tensor(constant, dtype=torch.float32,
                                         device=device)
        else:
            self.image = torch.as_tensor(np.asarray(image, np.float32),
                                         device=device)

    def sample(self, dirs: torch.Tensor) -> torch.Tensor:
        if self.image is None:
            return self.constant.to(dirs.device).expand(*dirs.shape[:-1], 3)
        h, w = self.image.shape[:2]
        u = torch.atan2(dirs[..., 0], dirs[..., 2]) / (2 * math.pi) + 0.5
        v = torch.acos(torch.clamp(dirs[..., 1], -1, 1)) / math.pi
        x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
        y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
        return self.image[y, x]


def _reflect(d, n):
    return d - 2.0 * torch.sum(d * n, dim=-1, keepdim=True) * n


def _refract(d, n, eta):
    """Refract d through normal n with relative IOR eta; reflects on
    total internal reflection."""
    cos_i = -torch.sum(d * n, dim=-1, keepdim=True)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refr = eta * d + (eta * cos_i - cos_t) * n
    return torch.where(tir, _reflect(d, n), refr), tir


class Engine3DGRUT:
    """Headless hybrid renderer over a GaussianModel and mesh primitives,
    on the model's device."""

    def __init__(self, model: GaussianModel,
                 config: Optional[EngineConfig] = None,
                 envmap: Optional[EnvironmentMap] = None):
        self.model = model
        self.device = model.device
        self.config = config or EngineConfig()
        self.envmap = envmap or EnvironmentMap(device=self.device)
        self.meshes: List[Mesh] = []
        self.materials: List[PBRMaterial] = [PBRMaterial()]
        self._soup = None
        self._mats = None

    # the primitives registry (engine.py:264 Primitives)
    def add_primitive(self, mesh: Mesh, material: PBRMaterial):
        mesh.material_id = len(self.materials)
        self.materials.append(material)
        self.meshes.append(mesh)
        self._soup = self._mats = None

    def add_glb(self, path: str, kind: str = "pbr"):
        """Load a .glb asset with its glTF materials and textures
        (reference mesh_io.py:44-112); returns the primitives added."""
        meshes, mats = load_glb_scene(path)
        base = len(self.materials)
        for md in mats:
            self.materials.append(PBRMaterial(
                kind=kind, base_color=md["base_color"],
                roughness=md["roughness"], metallic=md["metallic"],
                ior=md["ior"], emissive=md["emissive"],
                transmission=md["transmission"],
                diffuse_map=md["diffuse_map"],
                emissive_map=md["emissive_map"]))
        for m in meshes:
            m.material_id += base
            self.meshes.append(m)
        self._soup = self._mats = None
        return len(meshes)

    def _get_soup(self):
        if self._soup is None:
            self._soup = make_intersector(self.meshes, device=self.device)
        return self._soup

    def _material_arrays(self):
        if self._mats is not None:
            return self._mats
        mats = self.materials

        def col(fn, dtype=torch.float32):
            return torch.tensor([fn(m) for m in mats], dtype=dtype,
                                device=self.device)

        out = dict(kind=col(lambda m: _KINDS[m.kind], torch.int64),
                   base_color=col(lambda m: m.base_color),
                   roughness=col(lambda m: m.roughness),
                   metallic=col(lambda m: m.metallic),
                   ior=col(lambda m: m.ior),
                   emissive=col(lambda m: m.emissive),
                   transmission=col(lambda m: m.transmission))
        for attr in ("diffuse_map", "emissive_map"):
            if any(getattr(m, attr) is not None for m in mats):
                out[attr] = self._texture_atlas(attr)
        self._mats = out
        return out

    def _texture_atlas(self, attr):
        """Per-material maps packed as one padded [M, Hmax, Wmax, 3] atlas
        with (h [M], w [M], has [M]); a material without a map samples
        1.0 (its constant factor passes through)."""
        maps = [getattr(m, attr) for m in self.materials]
        hs = [np.asarray(im).shape[0] if im is not None else 1 for im in maps]
        ws = [np.asarray(im).shape[1] if im is not None else 1 for im in maps]
        atlas = np.ones((len(maps), max(hs), max(ws), 3), np.float32)
        for i, im in enumerate(maps):
            if im is None:
                continue
            a = np.asarray(im, np.float32)
            if a.ndim == 2:
                a = a[..., None]
            if a.shape[-1] == 1:
                a = np.repeat(a, 3, axis=-1)
            atlas[i, :hs[i], :ws[i]] = a[..., :3]
        dev = self.device
        return (torch.as_tensor(atlas, device=dev),
                torch.tensor(hs, device=dev), torch.tensor(ws, device=dev),
                torch.tensor([im is not None for im in maps], device=dev))

    @staticmethod
    def _sample_texture(tex, m, uv):
        """Nearest-texel sample of atlas ``tex`` for per-ray material m at
        uv (glTF REPEAT wrap, v down); 1.0 where m has no map."""
        atlas, hs, ws, has = tex
        u = uv[:, 0] - torch.floor(uv[:, 0])
        v = uv[:, 1] - torch.floor(uv[:, 1])
        x = torch.minimum(torch.clamp((u * ws[m]).to(torch.int64), min=0),
                          ws[m] - 1)
        y = torch.minimum(torch.clamp((v * hs[m]).to(torch.int64), min=0),
                          hs[m] - 1)
        texel = atlas[m, y, x]
        return torch.where(has[m][:, None], texel, torch.ones_like(texel))

    # rendering
    @torch.no_grad()
    def render_rays(self, ray_o: torch.Tensor, ray_d: torch.Tensor,
                    frame_number: int = 0) -> torch.Tensor:
        """Path-trace a flat batch of rays [R, 3] -> RGB [R, 3]."""
        cfg = self.config
        soup = self._get_soup()
        mats = self._material_arrays()
        ray_o, ray_d = ray_o.to(torch.float32), ray_d.to(torch.float32)
        r = ray_o.shape[0]
        dev = ray_o.device
        radiance = torch.zeros((r, 3), device=dev)
        throughput = torch.ones((r, 3), device=dev)
        alive = torch.ones(r, dtype=torch.bool, device=dev)
        o, d = ray_o, ray_d
        ray_idx = torch.arange(r, dtype=torch.int64, device=dev)

        def masked(mask, x):
            return torch.where(mask[:, None], x, torch.zeros_like(x))

        for bounce in range(cfg.max_bounces):
            t_hit, _, normal, mat_id, uv = soup.closest_hit(o, d)
            # the volumetric Gaussians along [1e-4, t_hit]
            gs = trace(self.model, o, d, sh_degree=cfg.gaussian_sh_degree,
                       t_min=1e-4, t_max=t_hit)
            vol_alpha = gs["pred_opacity"][:, 0]
            radiance = radiance + masked(alive, throughput
                                         * gs["pred_features"])
            throughput = throughput * torch.where(
                alive[:, None], (1.0 - vol_alpha)[:, None],
                torch.ones_like(throughput))

            miss = mat_id < 0
            radiance = radiance + masked(alive & miss, throughput
                                         * self.envmap.sample(d))
            alive = alive & ~miss

            # mesh interaction; texture maps modulate the constant factors
            # at the hit uv (reference engine.py:101-131)
            m = torch.clamp(mat_id, min=0)
            kind = mats["kind"][m]
            base = mats["base_color"][m]
            emissive = mats["emissive"][m]
            if "diffuse_map" in mats:
                base = base * self._sample_texture(mats["diffuse_map"], m,
                                                   uv)
            if "emissive_map" in mats:
                emissive = emissive * self._sample_texture(
                    mats["emissive_map"], m, uv)
            radiance = radiance + masked(alive, throughput * emissive)

            hit_p = o + d * t_hit[:, None]
            # glass: refract through the surface (relative IOR by side)
            refr_d, _ = _refract(d, normal, (1.0 / mats["ior"][m])[:, None])
            refl_d = _reflect(d, normal)
            # diffuse solids end with the env-lit base colour (the
            # reference's flat get_diffuse_color, materials.cuh:39)
            n_dot = torch.abs(torch.sum(normal * d, dim=-1, keepdim=True))
            diffuse_rgb = base * self.envmap.sample(normal) * n_dot
            is_glass, is_mirror, is_pbr = kind == 2, kind == 1, kind == 3
            continues = is_glass | is_mirror | is_pbr
            radiance = radiance + masked(alive & ~continues,
                                         throughput * diffuse_rgb)
            alive = alive & continues

            # PBR: a stochastic microfacet bounce (materials.cuh:248) with
            # the reference's PCG3D per-(pixel, frame, bounce) seeding
            rand3 = pcg3d_float(torch.stack(
                [ray_idx, torch.full_like(ray_idx, frame_number),
                 torch.full_like(ray_idx, bounce + 1)], dim=-1))
            pbr_d, pbr_factor = sample_microfacet_brdf(
                -d, normal, base, mats["metallic"][m][:, None],
                mats["roughness"][m][:, None],
                mats["transmission"][m][:, None],
                mats["ior"][m][:, None], rand3)

            new_d = torch.where(is_pbr[:, None], pbr_d,
                                torch.where(is_glass[:, None], refr_d,
                                            refl_d))
            new_d = new_d / torch.clamp(torch.linalg.norm(
                new_d, dim=-1, keepdim=True), min=1e-12)
            o = hit_p + new_d * 1e-3
            d = new_d
            factor = torch.where(is_pbr[:, None], pbr_factor, base)
            throughput = throughput * torch.where(
                alive[:, None], factor, torch.ones_like(factor))

        # paths still alive: shade with the environment
        return radiance + masked(alive, throughput * self.envmap.sample(d))

    def render_progressive(self, cam):
        """Generator of progressively accumulated frames (the reference's
        has_more_to_accumulate loop, engine.py:1005): the running [H, W,
        3] average, clipped to [0, 1], after every SPP batch; jitter from
        the SPP mode, the aperture from the depth-of-field sampler."""
        from ..render.common import camera_rays_world

        cfg = self.config
        ro, rd = camera_rays_world(cam)
        ro, rd = ro.to(self.device), rd.to(self.device)
        h, w = ro.shape[:2]
        spp = SPP(mode=cfg.spp_mode, spp=cfg.spp, device=self.device)
        dof = (DepthOfField(spp=cfg.spp, aperture_size=cfg.aperture,
                            focus_z=cfg.focus_distance, device=self.device)
               if cfg.aperture > 0.0 else None)
        # pixel-space basis of the jitter: d(ray) / d(pixel)
        dx = rd[:, 1:, :] - rd[:, :-1, :]
        dx = torch.cat([dx, dx[:, -1:, :]], dim=1)
        dy = rd[1:, :, :] - rd[:-1, :, :]
        dy = torch.cat([dy, dy[-1:, :, :]], dim=0)
        # camera frame of the aperture disc
        right = dx.reshape(-1, 3)[0]
        right = right / torch.clamp(torch.linalg.norm(right), min=1e-12)
        up = dy.reshape(-1, 3)[0]
        up = up / torch.clamp(torch.linalg.norm(up), min=1e-12)

        acc = torch.zeros((h * w, 3), device=self.device)
        n = 0
        spp.reset_accumulation()
        while spp.has_more_to_accumulate():
            jitter = spp(h, w)
            d = rd + jitter[..., 0:1] * dx + jitter[..., 1:2] * dy
            d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).reshape(-1,
                                                                         3)
            o = ro.reshape(-1, 3)
            if dof is not None:
                o, d = dof(right, up, o, d)
            acc = acc + self.render_rays(o, d, frame_number=n)
            n += 1
            yield torch.clamp((acc / n).reshape(h, w, 3), 0.0,
                              1.0).cpu().numpy()

    def render(self, cam) -> np.ndarray:
        """A full camera frame [H, W, 3] in [0, 1] with SPP accumulation,
        depth of field and the optional denoiser pass."""
        img = None
        for img in self.render_progressive(cam):
            pass
        if self.config.denoise:
            img = torch.as_tensor(img, device=self.device)
            if self.config.denoiser == "cnn":
                from .denoise_cnn import denoise_frame
                img = denoise_frame(img)
            else:
                from .denoise import atrous_denoise
                img = atrous_denoise(img)
            img = torch.clamp(img, 0.0, 1.0).cpu().numpy()
        return img

    def render_fisheye(self, c2w: np.ndarray, fov: float, width: int,
                       height: int) -> np.ndarray:
        """An ideal equidistant fisheye frame; pixels outside the field
        of view render black (reference playground _raygen_fisheye and
        its mask, engine.py:1362, 1096)."""
        ro, rd, mask = fisheye_rays(c2w, fov, width, height, self.device)
        rgb = self.render_rays(ro.reshape(-1, 3), rd.reshape(-1, 3)).reshape(
            height, width, 3)
        rgb = torch.where(mask, rgb, torch.zeros_like(rgb))
        return torch.clamp(rgb, 0.0, 1.0).cpu().numpy()


def fisheye_rays(c2w: np.ndarray, fov: float, width: int, height: int,
                 device="cpu", eps: float = 1e-9):
    """Equidistant fisheye rays: the angle from the optical axis is the
    radial NDC distance times fov / 2; pixels with r > 1 lie outside the
    field of view. ``c2w`` [4, 4] or [3, 4], camera looking down +z with
    +x right and +y down. Returns (ray_o, ray_d [H, W, 3], mask [H, W,
    1])."""
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width * 2.0 - 1.0
    ys = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        / height * 2.0 - 1.0
    u = xs[None, :].expand(height, width)
    v = ys[:, None].expand(height, width)
    r = torch.sqrt(u * u + v * v)
    mask = (r <= 1.0)[..., None]
    phi = torch.atan2(v, torch.where(r > eps, u, torch.ones_like(u)))
    theta = r * fov * 0.5
    d_cam = torch.stack([torch.cos(phi) * torch.sin(theta),
                         torch.sin(phi) * torch.sin(theta),
                         torch.cos(theta)], dim=-1)
    rd = torch.einsum("ij,hwj->hwi", c2w[:3, :3], d_cam)
    ro = c2w[:3, 3].expand(height, width, 3)
    return ro, rd, mask
