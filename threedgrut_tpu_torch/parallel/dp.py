"""Band-sharded data-parallel training over torch.distributed (port of
threedgrut_tpu/parallel/dp.py).

The image is split into horizontal bands of 16-pixel tile rows, one band
a rank of the group. Each rank renders its band with the single-device
pipeline (``render/gut.py:render_gut``, kernels A-D) against replicated
parameters, computes its share of the loss, and the gradients are summed
over the group. A band is the same camera cropped: full width,
``band_h`` rows, the principal point moved up by the band's offset.

The loss is JAX's (dp.py:84-120): 0.8 l1 / D + 0.2 (1 / D - s), where s
sums the SSIM map of the rank's band, extended by ``r = 5`` halo rows of
its neighbours (``comm.halo_rows``), over the windows whose centre row
lies in [r, H - 1 - r] of the full image, divided by the full image's
3 (H - 10) (W - 10) windows; so the summed loss and its gradient are the
single-device ones. Windows that cross a band edge are evaluated by the
band that owns their centre, and their gradient reaches the neighbour's
rows through the halo's backward.

Departure by design: a rolling-shutter camera is refused. Its relative
shutter time divides by the camera's own height (ops/cameras.py), so a
cropped band camera would restart the shutter at each band; JAX renders
such a band wrongly (ROADMAP.md, known JAX faults).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..models.gaussians import GaussianModel
from ..ops.cameras import CameraModel, ShutterType
from ..ops.ssim import ssim_map
from ..ops.ut import TILE_Y, UTConfig
from ..optimizers import adam as adam_mod
from ..render.common import RasterConfig
from ..render.gut import render_gut
from . import comm

SSIM_WINDOW = 11
HALO = SSIM_WINDOW // 2


class ParamView:
    """What ``render_gut`` reads of a GaussianModel: ``base``'s config,
    its parameters taken from ``tensors`` (which may carry an autograd
    graph: a masked density, leaves of a step) and ``n_active`` active
    rows."""

    capacity = GaussianModel.capacity
    device = GaussianModel.device
    active_mask = GaussianModel.active_mask
    get_scale = GaussianModel.get_scale
    get_density = GaussianModel.get_density
    sh_coeffs = GaussianModel.sh_coeffs

    def __init__(self, base, tensors: Dict[str, torch.Tensor], n_active):
        self.config = base.config
        self.n_active_features = base.n_active_features
        self.n_active = int(n_active)
        for k, v in tensors.items():
            setattr(self, k, v)


def grad_leaves(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Leaves sharing ``params``' storage that record a graph."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def leaf_grads(loss: torch.Tensor, leaves: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """d loss / d leaf, zeros where a leaf is unused."""
    names = list(leaves)
    got = torch.autograd.grad(loss, [leaves[k] for k in names],
                              allow_unused=True)
    return {k: torch.zeros_like(leaves[k]) if g is None else g
            for k, g in zip(names, got)}


def refuse_rolling_shutter(cam: CameraModel, what: str):
    if cam.shutter_type != int(ShutterType.GLOBAL):
        raise ValueError(
            f"{what}: a rolling-shutter camera cannot be band-sharded: the "
            "shutter time divides by the camera's height, so each band "
            "camera would restart the shutter (JAX renders it so, wrongly)")


def band_camera(cam: CameraModel, band_height: int,
                band: int = 0) -> CameraModel:
    """Band ``band`` of ``cam``: full width, ``band_height`` rows, the
    principal point moved up by ``band * band_height``
    (dp.py:37, 86-96)."""
    shift = torch.tensor([0.0, float(band_height * band)],
                         dtype=cam.principal.dtype,
                         device=cam.principal.device)
    return dataclasses.replace(
        cam, resolution=(cam.resolution[0], band_height),
        principal=cam.principal - shift)


def band_rows(full_h: int, group=None) -> int:
    """The rows of each rank's band; raises unless the height splits into
    16-row tile bands, JAX's assertion (dp.py:64-66)."""
    n = comm.axis_size(group)
    if full_h % (TILE_Y * n):
        raise ValueError(f"image height {full_h} must split into 16-px "
                         f"tile bands across {n} devices")
    return full_h // n


def make_dp_train_step(group, cam_template: CameraModel, ut_cfg: UTConfig,
                       raster_cfg: RasterConfig, base_model,
                       sh_degree: int, loss_lambda_l1: float = 0.8,
                       loss_lambda_ssim: float = 0.2, eps: float = 1e-15):
    """The data-parallel training step over ``group`` (dp.py:42-149).

    Returns step(params, opt_state, lrs, rgb_gt_band, n_active, cam) ->
    (params, opt_state, {"total", "l1"}), and as ``step.grads(params,
    rgb_gt_band, n_active, cam)`` its (total, l1, gradients) before the
    update (JAX's ``sharded_grads``): ``params`` the rank's replica
    (a dict of tensors on its device, updated in place by the group's
    summed gradients, as are ``opt_state``'s moments), ``rgb_gt_band``
    its band of the GT (``shard_image_rows``), ``cam`` the full camera.
    ``total`` is the group's summed loss, ``l1`` the band l1s' mean.
    ``base_model`` gives the config and capacity."""
    refuse_rolling_shutter(cam_template, "make_dp_train_step")
    n_dev = comm.axis_size(group)
    full_w, full_h = cam_template.resolution
    band_h = band_rows(full_h, group)
    n_windows = 3 * (full_h - SSIM_WINDOW + 1) * (full_w - SSIM_WINDOW + 1)

    def device_loss(leaves, rgb_gt_band, n_active, cam):
        dev = comm.axis_index(group)
        model = ParamView(base_model, leaves, n_active)
        out = render_gut(band_camera(cam, band_h, dev), ut_cfg, raster_cfg,
                         model, sh_degree)
        pred = out["pred_features"]
        l1 = torch.mean(torch.abs(pred - rgb_gt_band))
        loss = loss_lambda_l1 * l1 / n_dev
        if loss_lambda_ssim:
            # the exact full-image SSIM: the band's windows with their
            # neighbours' halo rows, masked to the full image's valid
            # windows, over the full image's window count
            c = pred.shape[-1]
            ext = comm.halo_rows(torch.cat([pred, rgb_gt_band], dim=-1),
                                 HALO, group)
            smap = ssim_map(ext[..., :c].permute(2, 0, 1)[None],
                            ext[..., c:].permute(2, 0, 1)[None],
                            SSIM_WINDOW)
            centers = dev * band_h + torch.arange(band_h,
                                                  device=pred.device)
            valid = ((centers >= HALO) & (centers <= full_h - 1 - HALO)
                     ).to(smap.dtype)
            s = torch.sum(smap * valid[None, None, :, None]) / n_windows
            loss = loss + loss_lambda_ssim * (1.0 / n_dev - s)
        return loss, l1

    def sharded_grads(params, rgb_gt_band, n_active, cam):
        """(the group's loss, the mean band l1, the summed gradients)."""
        refuse_rolling_shutter(cam, "the dp step")
        leaves = grad_leaves(params)
        loss, l1 = device_loss(leaves, rgb_gt_band, n_active, cam)
        grads = leaf_grads(loss, leaves)
        names = list(grads)
        summed = comm.psum_tensors(
            [grads[k] for k in names] + [loss.detach()[None],
                                         l1.detach()[None]], group)
        return (summed[-2][0], summed[-1][0] / n_dev,
                dict(zip(names, summed)))

    def step(params, opt_state, lrs, rgb_gt_band, n_active, cam):
        loss, l1, grads = sharded_grads(params, rgb_gt_band, n_active, cam)
        opt_state = masked_adam(params, grads, opt_state, lrs, base_model,
                                n_active, eps)
        return params, opt_state, {"total": loss, "l1": l1}

    step.grads = sharded_grads
    return step


def masked_adam(params, grads, opt_state, lrs, base_model, n_active, eps):
    """``adam_step`` on the rows below ``n_active`` (dp.py:138-143)."""
    dev = next(iter(params.values())).device
    active = torch.arange(base_model.capacity, device=dev) < int(n_active)
    return adam_mod.adam_step(params, grads, opt_state, lrs, eps=eps,
                              update_mask=active)


def replicate_to_mesh(tree, group=None, src: int = 0):
    """Every rank's copy of ``tree`` (a tensor, a dict or list of them, or
    an AdamState) overwritten in place by rank ``src``'s (dp.py:152).
    Returns ``tree``."""
    comm.broadcast_(_leaves(tree), src, group)
    return tree


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, adam_mod.AdamState):
        return _leaves(tree.exp_avg) + _leaves(tree.exp_avg_sq)
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [t for v in tree for t in _leaves(v)]


def shard_image_rows(img: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's band of ``img`` [H, W, C] (dp.py:158)."""
    band_h = band_rows(img.shape[0], group)
    d = comm.axis_index(group)
    return img[d * band_h:(d + 1) * band_h]
