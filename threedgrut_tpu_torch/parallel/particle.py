"""Depth-sliced particle parallelism over torch.distributed (port of
threedgrut_tpu/parallel/particle.py).

Band sharding (``dp.py``) replicates every pair's work on each rank; this
module shards the particles instead:

1. every rank ranks the active particles by view depth, the key the
   binning sorts by (``ops/ut.py:sort_depth``), so the slabs nest inside
   the global compositing order;
2. rank d keeps the contiguous slab of ranks [d ceil(n/D), (d+1)
   ceil(n/D)) by giving every other particle the raw density -1e9: its
   opacity is then below the projection's alpha threshold, so it emits
   no pairs and a rank's pair, binning and raster work scales as 1/D;
3. each rank composites its slab over the full image with the
   single-device pipeline (``render_gut``, kernels A-D);
4. compositing is associative across depth-ordered slabs,
       C = sum_d (prod_{d' < d} T_d') C_d,   T = prod_d T_d,
   so one all_gather of the partials and an exclusive product of the
   slab transmittances combine them on every rank.

Exact up to the kill threshold: a ray killed inside one slab frees the
later slabs of work the serial render skips, at weights below
min_transmittance. Every rank computes the same combined loss, so the
all_gather's backward hands each slab its cotangent D times; the
gradients are averaged over the group, which removes that factor (JAX's
pmean, particle.py:165-178), and a particle's gradient comes only from
the slab that owns it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.gaussians import param_names
from ..ops.cameras import CameraModel
from ..ops.ssim import ssim
from ..ops.ut import UTConfig, sort_depth
from ..render.common import RasterConfig
from ..render.gut import render_gut
from . import comm
from .dp import (ParamView, band_camera, band_rows, grad_leaves, leaf_grads,
                 masked_adam, refuse_rolling_shutter)

MASKED_DENSITY = -1e9


def _slab_mask(model, cam: CameraModel, ut_cfg: UTConfig,
               group=None) -> torch.Tensor:
    """[C] bool: the particles of this rank's depth slab
    (particle.py:47-69)."""
    d, n_dev = comm.axis_index(group), comm.axis_size(group)
    with torch.no_grad():
        active = model.active_mask()
        depth = sort_depth(cam, ut_cfg, model.positions.detach())
        key = torch.where(active, depth, torch.full_like(depth, torch.inf))
        order = torch.argsort(key, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.numel(), device=order.device)
        per = (model.n_active + n_dev - 1) // n_dev
        lo = d * per
        return active & (rank >= lo) & (rank < lo + per)


def _mask_model(model, mask: torch.Tensor) -> ParamView:
    """``model`` with the raw density of the particles outside ``mask``
    set to -1e9 (particle.py:72-76); differentiable in the rest."""
    tensors = {k: getattr(model, k)
               for k in param_names(model.config.feature_type)}
    tensors["density"] = torch.where(
        mask[:, None], tensors["density"],
        torch.full_like(tensors["density"], MASKED_DENSITY))
    return ParamView(model, tensors, model.n_active)


def combine_slabs(feat, opac, depth, hits, tfin, group=None):
    """The ordered composite of every rank's [H, W, c] partials (slab d
    on rank d, front slabs on low ranks), the same on every rank
    (particle.py:79-99). The exclusive product of the transmittances is
    formed directly, where JAX divides a cumulative product by T_d."""
    f = feat.shape[-1]
    parts = comm.all_gather(torch.cat([feat, opac, depth, hits, tfin],
                                      dim=-1), group)
    feat_g = parts[..., 0:f]
    depth_g = parts[..., f + 1:f + 2]
    hits_g = parts[..., f + 2:f + 3]
    t_g = parts[..., f + 3:f + 4]
    prefix = torch.cat([torch.ones_like(t_g[:1]),
                        torch.cumprod(t_g[:-1], dim=0)], dim=0)
    feat_c = torch.sum(prefix * feat_g, dim=0)
    depth_c = torch.sum(prefix * depth_g, dim=0)
    hits_c = torch.sum(hits_g, dim=0)
    t_c = torch.prod(t_g, dim=0)
    return feat_c, 1.0 - t_c, depth_c, hits_c, t_c


def render_depth_sliced(cam: CameraModel, ut_cfg: UTConfig,
                        raster_cfg: RasterConfig, model, sh_degree: int,
                        group=None):
    """This rank's slab rendered and combined with the others'
    (particle.py:102-120): the full image on every rank."""
    mask = _slab_mask(model, cam, ut_cfg, group)
    out = render_gut(cam, ut_cfg, raster_cfg, _mask_model(model, mask),
                     sh_degree)
    tfin = 1.0 - out["pred_opacity"]
    feat, opac, depth, hits, _ = combine_slabs(
        out["pred_features"], out["pred_opacity"], out["pred_dist"],
        out["hits_count"], tfin, group)
    vis = comm.psum((out["mog_visibility"] & mask).to(torch.int32),
                    group) > 0
    return {"pred_features": feat, "pred_opacity": opac,
            "pred_dist": depth, "hits_count": hits, "mog_visibility": vis}


def make_sliced_render(group, ut_cfg: UTConfig, raster_cfg: RasterConfig,
                       base_model, sh_degree: int):
    """render(params, n_active, cam) -> (features, opacity, distance) of
    the full image, sharding the particles by depth slab over ``group``
    (particle.py:123-139); no gradient."""

    @torch.no_grad()
    def render(params, n_active, cam):
        model = ParamView(base_model, params, n_active)
        out = render_depth_sliced(cam, ut_cfg, raster_cfg, model, sh_degree,
                                  group)
        return out["pred_features"], out["pred_opacity"], out["pred_dist"]

    return render


def make_sliced_train_step(group, ut_cfg: UTConfig,
                           raster_cfg: RasterConfig, base_model,
                           sh_degree: int, lambda_l1: float = 0.8,
                           lambda_ssim: float = 0.2, eps: float = 1e-15):
    """The particle-sharded training step (particle.py:142-188): the
    combined image's l1 + DSSIM loss on every rank, the gradients
    averaged over ``group``. step(params, opt_state, lrs, rgb_gt,
    n_active, cam) -> (params, opt_state, {"total"}), in place as
    ``dp.make_dp_train_step``'s."""

    def sharded_grads(params, rgb_gt, n_active, cam):
        """(the loss, the gradients averaged over the group)."""
        leaves = grad_leaves(params)
        model = ParamView(base_model, leaves, n_active)
        out = render_depth_sliced(cam, ut_cfg, raster_cfg, model, sh_degree,
                                  group)
        pred = out["pred_features"]
        loss = lambda_l1 * torch.mean(torch.abs(pred - rgb_gt))
        if lambda_ssim:
            loss = loss + lambda_ssim * (1.0 - ssim(
                pred.permute(2, 0, 1)[None], rgb_gt.permute(2, 0, 1)[None]))
        grads, loss = _mean_over(leaf_grads(loss, leaves), loss, [group])
        return loss, grads

    def step(params, opt_state, lrs, rgb_gt, n_active, cam):
        loss, grads = sharded_grads(params, rgb_gt, n_active, cam)
        opt_state = masked_adam(params, grads, opt_state, lrs, base_model,
                                n_active, eps)
        return params, opt_state, {"total": loss}

    step.grads = sharded_grads
    return step


def _mean_over(grads, loss, groups):
    """The gradients and the loss averaged over each group in turn."""
    names = list(grads)
    vals = [grads[k] for k in names] + [loss.detach()[None]]
    for g in groups:
        n = comm.axis_size(g)
        vals = [v / n for v in comm.psum_tensors(vals, g)]
    return dict(zip(names, vals[:-1])), vals[-1][0]


def mesh_groups(shape: Tuple[int, int]):
    """(dp group, mp group) of this rank on a (dp, mp) mesh of the world's
    ranks in row-major order (rank = i_dp * n_mp + i_mp): the dp group
    holds the ranks of this rank's column, the mp group those of its
    row. Every rank creates every row and column group, in the same
    order, as ``dist.new_group`` requires; without a process group (a
    1 x 1 mesh in one process) both are None."""
    n_dp, n_mp = shape
    if not comm.initialized():
        if n_dp * n_mp != 1:
            raise ValueError(f"a {n_dp} x {n_mp} mesh needs a process group")
        return None, None
    if n_dp * n_mp != dist.get_world_size():
        raise ValueError(f"a {n_dp} x {n_mp} mesh on "
                         f"{dist.get_world_size()} ranks")
    me = dist.get_rank()
    dp_group = mp_group = None
    for j in range(n_mp):
        g = dist.new_group([i * n_mp + j for i in range(n_dp)])
        if me % n_mp == j:
            dp_group = g
    for i in range(n_dp):
        g = dist.new_group([i * n_mp + j for j in range(n_mp)])
        if me // n_mp == i:
            mp_group = g
    return dp_group, mp_group


def make_dp_sliced_train_step(groups: Sequence, cam_template: CameraModel,
                              ut_cfg: UTConfig, raster_cfg: RasterConfig,
                              base_model, sh_degree: int,
                              lambda_l1: float = 1.0, eps: float = 1e-15):
    """Data x particle parallelism on a (dp, mp) mesh
    (particle.py:191-261): ``groups`` = (dp group, mp group) of this rank
    (``mesh_groups``). Each rank renders its dp band's camera with its mp
    depth slab, the slabs combine over mp into the band image, and the
    band's l1 / n_dp is the rank's loss (L1 only, as JAX's); the
    gradients are averaged over mp, then summed over dp.
    step(params, opt_state, lrs, rgb_gt_band, n_active, cam) ->
    (params, opt_state, {"total"}); ``rgb_gt_band`` the dp band of the
    GT (``dp.shard_image_rows(img, dp_group)``)."""
    dp_group, mp_group = groups
    refuse_rolling_shutter(cam_template, "make_dp_sliced_train_step")
    n_dp = comm.axis_size(dp_group)
    band_h = band_rows(cam_template.resolution[1], dp_group)

    def sharded_grads(params, rgb_gt_band, n_active, cam):
        """(the loss, the gradients: averaged over mp, summed over dp)."""
        refuse_rolling_shutter(cam, "the dp x mp step")
        leaves = grad_leaves(params)
        model = ParamView(base_model, leaves, n_active)
        cam_b = band_camera(cam, band_h, comm.axis_index(dp_group))
        out = render_depth_sliced(cam_b, ut_cfg, raster_cfg, model,
                                  sh_degree, mp_group)
        l1 = torch.mean(torch.abs(out["pred_features"] - rgb_gt_band))
        grads, loss = _mean_over(leaf_grads(lambda_l1 * l1 / n_dp, leaves),
                                 lambda_l1 * l1 / n_dp, [mp_group])
        names = list(grads)
        summed = comm.psum_tensors([grads[k] for k in names]
                                   + [loss[None]], dp_group)
        return summed[-1][0], dict(zip(names, summed[:-1]))

    def step(params, opt_state, lrs, rgb_gt_band, n_active, cam):
        loss, grads = sharded_grads(params, rgb_gt_band, n_active, cam)
        opt_state = masked_adam(params, grads, opt_state, lrs, base_model,
                                n_active, eps)
        return params, opt_state, {"total": loss}

    step.grads = sharded_grads
    return step
