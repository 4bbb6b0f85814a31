"""All-pixels x all-particles reference renderer
(port of threedgrut_tpu/render/oracle.py).

Every pixel against every particle in global depth order, with the
semantics of the production path (tile bbox membership, per-tile conic
cull, the direct 3D density hit of ``ops/hit.py``, front-to-back
compositing with the exact kill) and none of its binning. On the card it
is the parity probe of the two kernels; on the CPU it is held against
the JAX oracle. O(pixels x particles): small scenes only.

Particles go through in depth-ordered chunks; inside a chunk the
transmittance is an exclusive product in float64, with the kill applied
as a mask, and the chunk's final transmittance carries to the next.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.gaussians import GaussianModel, GaussianModelConfig
from ..ops import ut as ut_ops
from ..ops.cameras import CameraModel, make_pinhole
from ..ops.hit import density_hit, hit_normal
from ..ops.sh import eval_sh_radiance
from ..ops.ut import TILE_X, TILE_Y, UTConfig
from .common import RasterConfig, camera_rays_world
from .gut import _ray_aabb, _scene_aabb


def render_oracle(cam: CameraModel, ut_cfg: UTConfig,
                  raster_cfg: RasterConfig, model: GaussianModel,
                  sh_degree: int, chunk: int = 128):
    """Render a full image; same output keys as ``render_gut`` (without
    the pair counters), ``pred_normals`` with ``raster_cfg.enable_normals``
    (JAX render/oracle.py:97-99, 119; each hit's normal in float64 here).
    ``hits_count`` is int32."""
    w, h = cam.resolution
    dev = model.device
    proj = ut_ops.unscented_projection(
        cam, ut_cfg, model.positions, model.rotation, model.get_scale(),
        model.get_density()[:, 0], model.active_mask())
    feats = torch.clamp(eval_sh_radiance(model.sh_coeffs(), proj.view_dir,
                                         sh_degree), min=0.0)
    order = torch.argsort(torch.where(
        proj.valid, proj.depth, torch.full_like(proj.depth, math.inf)),
        stable=True)
    n_valid = int(proj.valid.sum())
    order = order[:n_valid]     # invalid particles contribute nothing

    gx = (w + TILE_X - 1) // TILE_X
    gy = (h + TILE_Y - 1) // TILE_Y
    lo, hi = ut_ops.tile_bbox(proj.center, proj.extent, (gx, gy))
    ray_o, ray_d = camera_rays_world(cam)
    bb_lo, bb_hi = _scene_aabb(model)
    tmin, tmax = _ray_aabb(ray_o, ray_d, bb_lo, bb_hi)

    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    tile_x = (xs // TILE_X).reshape(-1, 1)
    tile_y = (ys // TILE_Y).reshape(-1, 1)
    tile_xy = torch.stack([tile_x, tile_y], dim=-1).to(torch.float32)
    o = ray_o.reshape(-1, 1, 3)
    d = ray_d.reshape(-1, 1, 3)
    t_lo = tmin.reshape(-1, 1)
    t_hi = tmax.reshape(-1, 1)

    scales = model.get_scale()
    dens = model.get_density()[:, 0]
    max_power = torch.log(torch.clamp(proj.opacity, min=1e-30)
                          / ut_cfg.alpha_threshold)
    npix = h * w
    trans = torch.ones(npix, dtype=torch.float64, device=dev)
    feat = torch.zeros((npix, 3), dtype=torch.float64, device=dev)
    depth = torch.zeros(npix, dtype=torch.float64, device=dev)
    hits = torch.zeros(npix, dtype=torch.int32, device=dev)
    normal = torch.zeros((npix, 3), dtype=torch.float64, device=dev)
    for c0 in range(0, n_valid, chunk):
        idx = order[c0:c0 + chunk]
        in_bbox = ((tile_x >= lo[idx, 0]) & (tile_x < hi[idx, 0])
                   & (tile_y >= lo[idx, 1]) & (tile_y < hi[idx, 1]))
        if raster_cfg.tile_culling:
            power = ut_ops.tile_min_power_response(
                tile_xy, proj.conic[idx][None], proj.center[idx][None])
            in_bbox = in_bbox & (power < max_power[idx])
        hit = density_hit(
            o, d, model.positions[idx], model.rotation[idx], scales[idx],
            dens[idx], kernel_degree=raster_cfg.kernel_degree,
            min_response=raster_cfg.min_response,
            min_alpha=raster_cfg.min_alpha, max_alpha=raster_cfg.max_alpha)
        a = torch.where(in_bbox & (hit.hit_t > t_lo) & (hit.hit_t < t_hi),
                        hit.alpha, torch.zeros_like(hit.alpha)).double()
        # exclusive transmittance inside the chunk, carried in
        log1m = torch.log1p(-a)
        t_prev = trans[:, None] * torch.exp(torch.cumsum(log1m, 1) - log1m)
        alive = t_prev >= raster_cfg.min_transmittance
        wgt = torch.where(alive, a * t_prev, torch.zeros_like(a))
        feat += wgt @ feats[idx].double()
        depth += torch.sum(wgt * hit.hit_t.double(), dim=1)
        hits += torch.sum(wgt > 0.0, dim=1, dtype=torch.int32)
        if raster_cfg.enable_normals:   # in float64: fp32 loses digits
            # where the origin lies hundreds of particle radii away
            n = hit_normal(o.double(), d.double(),
                           model.positions[idx].double(),
                           model.rotation[idx].double(),
                           scales[idx].double())
            normal += torch.sum(wgt[..., None] * n, dim=1)
        dead_t = torch.where(alive, torch.full_like(a, -1.0), t_prev)
        frozen = torch.amax(dead_t, dim=1)
        t_end = t_prev[:, -1] * (1.0 - a[:, -1])
        trans = torch.where(frozen >= 0.0, frozen, t_end)

    out = {
        "pred_features": feat.reshape(h, w, 3).to(torch.float32),
        "pred_opacity": (1.0 - trans).reshape(h, w, 1).to(torch.float32),
        "pred_dist": depth.reshape(h, w, 1).to(torch.float32),
        "hits_count": hits.reshape(h, w, 1),
        "mog_visibility": proj.valid,
    }
    if raster_cfg.enable_normals:
        out["pred_normals"] = normal.reshape(h, w, 3).to(torch.float32)
    return out


def parity_db(got: np.ndarray, ref: np.ndarray):
    """(bulk_db, raw_db, flip_frac) of two [H, W, 3] renders.

    Counterpart of bench.py:oracle_parity_db: a pixel whose worst
    channel differs by half a minimum-alpha contribution (0.5/255) took
    a different discrete accept decision somewhere in its hit list
    (``flip``); ``bulk_db`` is the PSNR over the other pixels, the
    continuous accumulation error.
    """
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))

    def db(mse):
        return 999.0 if mse <= 0.0 else float(-10.0 * np.log10(mse))

    flip = err.max(axis=-1) > (0.5 / 255.0)
    bulk = db(float(np.mean(err[~flip] ** 2))) if (~flip).any() else 0.0
    return bulk, db(float(np.mean(err ** 2))), float(flip.mean())


def oracle_probe(model: GaussianModel, ut_cfg: UTConfig,
                 raster_cfg: RasterConfig, side: int = 200,
                 n: int = 60_000):
    """(``render_gut``, ``render_oracle``) outputs on the model's device
    for bench.py:oracle_parity_db's view: one ``side`` x ``side`` pinhole
    frame looking down +z from the origin (bench.py's view of the bench
    cloud) over the model's first ``n`` particles, as a capacity of ``n``
    rounded up to 256 rows."""
    from .gut import render_gut

    n = min(n, model.n_active)
    keep = -(-n // 256) * 256
    with torch.no_grad():
        arrays = {k: getattr(model, k)[:keep].detach().cpu().numpy()
                  for k in ("positions", "rotation", "scale", "density",
                            "features_albedo", "features_specular")}
        probe = GaussianModel.from_numpy(
            arrays, n, model.n_active_features,
            GaussianModelConfig(max_sh_degree=model.config.max_sh_degree),
            model.device)
        cam = make_pinhole((side, side), (1.1 * side, 1.1 * side),
                           (side / 2, side / 2), device=model.device)
        degree = model.n_active_features
        return (render_gut(cam, ut_cfg, raster_cfg, probe, degree),
                render_oracle(cam, ut_cfg, raster_cfg, probe, degree,
                              chunk=512))


def oracle_parity_db(model: GaussianModel, ut_cfg: UTConfig,
                     raster_cfg: RasterConfig, side: int = 200,
                     n: int = 60_000):
    """(bulk_db, raw_db, flip_frac) of ``render_gut`` against
    ``render_oracle`` on ``oracle_probe``'s view (bench.py:
    oracle_parity_db): the kernels' lost precision shows in ``bulk_db``,
    flipped accept decisions in ``flip_frac`` (``parity_db``)."""
    got, ref = oracle_probe(model, ut_cfg, raster_cfg, side, n)
    return parity_db(got["pred_features"].cpu().numpy(),
                     ref["pred_features"].cpu().numpy())
