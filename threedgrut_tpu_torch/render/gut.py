"""3DGUT renderer: UT projection -> binning -> raster
(port of threedgrut_tpu/render/gut.py:34-82, 110-131, 137-320).

The training and serving mode of the JAX renderer: pinhole or fisheye
cameras with a global or a rolling shutter, SH features evaluated per
particle, compositing with the reference's exact kill in global-Z order
or, with ``raster_cfg.sorted_compositing``, in per-ray sorted windows
(3DGRT, ``render/grt.py``, and sorted 3DGUT). As in JAX
(render/gut.py:191-196), a global-shutter camera's rays share one
origin, and the raster kernels run their shared-origin mode; a rolling
shutter, or rays passed in (``rays=``), take the general-geometry mode
with a per-pixel origin.
An NHT model (``feature_type: nht``; JAX render/gut.py:167-219) puts
its raw tetrahedron control features in the table in place of rgb, and
the raster evaluates them per (pixel, pair) at the canonical hit point:
it always takes the general mode (a pinhole's rays then carry their
per-pixel origins, as in JAX), never the sorted one, and
``pred_features`` are its 2 d ray features (24 at the published width
48), which the trainer decodes to RGB. JAX hard-codes one sincos
frequency (gut.py:174); train_torch.py refuses other feature
activations. Weight telemetry (kernel E) has no NHT mode and raises.
The raster kernel gathers each pair's record from the per-particle table
itself, so no [P, 16] records array is built, and writes straight into
[H, W, .] images, so no tile-packed rays or outputs exist either.

Differentiable in the model parameters: the table and the SH features
are built with autograd, and the raster's backward (kernels C and D)
returns the table's gradient. The projection enters the binning only
structurally (detached), as in JAX; rays and t-ranges get no gradient.
Under ``torch.no_grad()`` (the serving path) the same kernels run
without saving anything for a backward.

Returned dict mirrors the JAX package: ``pred_features`` [H,W,3] (NHT:
[H,W,2d]),
``pred_opacity`` [H,W,1], ``pred_dist`` [H,W,1], ``hits_count`` [H,W,1],
``mog_visibility`` [C], ``num_pairs`` and ``pairs_overflow``; with
``raster_cfg.enable_normals`` also ``pred_normals`` [H,W,3], the blended
hit normals (forward only; never for NHT, JAX render/gut.py:210, 318-319).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.gaussians import GaussianModel
from ..ops import binning as binning_ops
from ..ops import ut as ut_ops
from ..ops.cameras import CameraModel, ShutterType
from ..ops.cuda.raster import FoldMeta, rasterize_tiles
from ..ops.cuda.wmax import pair_weight_max, particle_weight_max
from ..ops.quaternion import quat_normalize, quat_to_rotmat
from ..ops.sh import eval_sh_radiance
from ..ops.ut import TILE_X, TILE_Y, UTConfig
from .common import RasterConfig, camera_rays_world


def _scene_aabb(model: GaussianModel):
    """Conservative AABB of the active particles (+-3 sigma); stands in
    for the reference's objectAABB ray clip (rayPayload.cuh:96-99)."""
    mask = model.active_mask()[:, None]
    pos = model.positions
    rad = 3.0 * torch.amax(model.get_scale(), dim=-1, keepdim=True)
    big = torch.full_like(pos, 3e37)
    lo = torch.amin(torch.where(mask, pos - rad, big), dim=0)
    hi = torch.amax(torch.where(mask, pos + rad, -big), dim=0)
    return lo, hi


def _ray_aabb(ray_o, ray_d, lo, hi):
    """Slab test -> (tmin, tmax) per ray; tmin clamped at 0."""
    tiny = torch.where(ray_d >= 0, torch.full_like(ray_d, 1e-12),
                       torch.full_like(ray_d, -1e-12))
    inv = 1.0 / torch.where(torch.abs(ray_d) < 1e-12, tiny, ray_d)
    t0 = (lo - ray_o) * inv
    t1 = (hi - ray_o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return torch.clamp(tmin, min=0.0), tmax


def particle_table(model: GaussianModel, origin: Optional[torch.Tensor],
                   feats: torch.Tensor) -> torch.Tensor:
    """[C, 13 + F] per-particle records of the shared-origin hit model:
    a = M (o - p), M = diag(1/s) R^T (row-major), density, then ``feats``
    [C, F] (rgb; gut.py:233-247). With ``origin`` None, the general
    mode's records: the position p in place of a (the kernels form
    a = M (o_pix - p) per pixel, never M o - M p, which cancels at large
    world coordinates)."""
    rot = quat_to_rotmat(quat_normalize(model.rotation))   # [C,3,3]
    m_mat = (1.0 / model.get_scale())[:, :, None] * rot.transpose(1, 2)
    if origin is None:
        return torch.cat([model.positions, m_mat.reshape(-1, 9),
                          model.get_density(), feats], dim=1).contiguous()
    delta = origin - model.positions
    gro = (m_mat[:, :, 0] * delta[:, 0:1] + m_mat[:, :, 1] * delta[:, 1:2]
           + m_mat[:, :, 2] * delta[:, 2:3])
    return torch.cat([gro, m_mat.reshape(-1, 9), model.get_density(),
                      feats], dim=1).contiguous()


class ViewInputs(NamedTuple):
    """What the raster kernel takes for one view (see ``prepare_view``)."""
    proj: ut_ops.Projection
    binning: binning_ops.Binning
    table: torch.Tensor     # [C, 16], NHT [C, 16 + 4 d]
    ray_d: torch.Tensor     # [H, W, 3]
    tmin: torch.Tensor      # [H, W]
    tmax: torch.Tensor      # [H, W]
    ray_o: Optional[torch.Tensor] = None   # [H, W, 3], the general mode


def shared_origin(cam: CameraModel, rays=None) -> bool:
    """Whether every ray of the view starts at the camera's start-pose
    center (JAX render/gut.py:195-196): camera rays, global shutter."""
    return rays is None and cam.shutter_type == int(ShutterType.GLOBAL)


def is_nht(model: GaussianModel) -> bool:
    return model.config.feature_type == "nht"


def prepare_view(cam: CameraModel, ut_cfg: UTConfig, raster_cfg: RasterConfig,
                 model: GaussianModel, sh_degree: int,
                 rays=None) -> ViewInputs:
    """UT projection, SH features (NHT: the raw control features and 3
    slots of padding), binning, the particle table and the rays
    (``rays`` = (ray_o, ray_d) [H, W, 3] world-space, or the camera's)
    with their scene-AABB t-ranges. In the general mode (always for NHT)
    the table holds positions and ``ray_o`` the per-pixel origins."""
    w, h = cam.resolution
    grid = ((w + TILE_X - 1) // TILE_X, (h + TILE_Y - 1) // TILE_Y)
    proj = ut_ops.unscented_projection(
        cam, ut_cfg, model.positions, model.rotation, model.get_scale(),
        model.get_density()[:, 0], model.active_mask())
    nht = is_nht(model)
    if nht:
        feats = torch.cat([model.features, model.features.new_zeros(
            (model.capacity, 3))], dim=1)
    else:
        # per-particle radiance from the sensor->particle direction,
        # clamped at 0 like the renderer's max(features, 0) fetch
        feats = torch.clamp(eval_sh_radiance(
            model.sh_coeffs(), proj.view_dir, sh_degree), min=0.0)
    b = binning_ops.bin_particles(
        proj, grid, raster_cfg.max_pairs,
        tile_culling=raster_cfg.tile_culling,
        alpha_threshold=ut_cfg.alpha_threshold)
    # NHT needs the canonical hit point: the general mode
    shared = shared_origin(cam, rays) and not nht
    table = particle_table(
        model, ut_ops.sensor_position(cam) if shared else None, feats)
    ray_o, ray_d = camera_rays_world(cam) if rays is None else rays
    with torch.no_grad():   # rays and t-ranges carry no gradient
        ray_o = ray_o.detach().to(torch.float32)
        ray_d = ray_d.detach().to(torch.float32)
        tmin, tmax = _ray_aabb(ray_o, ray_d, *_scene_aabb(model))
    return ViewInputs(proj, b, table, ray_d.contiguous(), tmin.contiguous(),
                      tmax.contiguous(),
                      None if shared else ray_o.contiguous())


def render_gut(cam: CameraModel, ut_cfg: UTConfig, raster_cfg: RasterConfig,
               model: GaussianModel, sh_degree: int,
               weight_telemetry: bool = False, rays=None):
    """Render one view (differentiable in the model's parameters).

    ``rays``: optional (ray_o [H,W,3], ray_d [H,W,3]) world-space
    override of the camera's rays (JAX render/gut.py:137-146); it selects
    the general-geometry mode, as a rolling shutter does.

    ``weight_telemetry``: run the blend-weight kernel (kernel E) instead
    of the compositing and return {"particle_wmax": [C]}, the
    per-particle max over pixels of alpha * T that the GS strategy's
    weight pruning reads (JAX render/gut.py:291-297)."""
    if is_nht(model):
        if weight_telemetry:
            raise NotImplementedError(
                "weight telemetry with NHT: kernel E composites constant "
                "features only (JAX's telemetry kernel is GS only)")
        # JAX composites NHT in global-Z order (gut.py:208) and blends no
        # normals (gut.py:210)
        raster_cfg = raster_cfg.replace(sorted_compositing=False,
                                        enable_normals=False)
    if weight_telemetry:
        with torch.no_grad():
            v = prepare_view(cam, ut_cfg, raster_cfg, model, sh_degree,
                             rays)
            b = v.binning
            wpair = pair_weight_max(v.table, b.pair_particle, b.tile_start,
                                    v.ray_d, v.tmin, v.tmax, raster_cfg,
                                    v.ray_o)
            return {"particle_wmax": particle_weight_max(
                wpair, b.pair_particle, model.capacity)}
    v = prepare_view(cam, ut_cfg, raster_cfg, model, sh_degree, rays)
    b = v.binning
    feat, opacity, depth, hits, *normals = rasterize_tiles(
        v.table, b.pair_particle, b.tile_start, v.ray_d, v.tmin, v.tmax,
        raster_cfg, FoldMeta(b.perm, b.order, b.excl, b.counts, b.limit,
                             n_valid=b.num_pairs),
        v.ray_o)
    out = {
        "pred_features": feat,
        "pred_opacity": opacity,
        "pred_dist": depth,
        "hits_count": hits,
        "ray_d": v.ray_d,
        "mog_visibility": v.proj.valid,
        "num_pairs": v.binning.num_pairs,
        "pairs_overflow": v.binning.overflow,
    }
    if normals:
        out["pred_normals"] = normals[0]
    return out
