"""Optimization-based SH bake of fixed post-processing transforms
(port of threedgrut_tpu/export/sh_bake.py).

Reference: threedgrut/export/usd/post_processing/sh_bake.py — clone the
model, freeze everything except the SH coefficient tensors, and run a
photometric fit so that rendering the baked model WITHOUT the ISP
reproduces rendering the original model WITH the ISP. This folds the
nonlinear parts (vignetting averaged over views, homography
normalization, CRF) into the coefficients as far as SH expressivity
allows; the linear exposure part is used as the warm start
(scale_sh_output, sh_bake.py:33 — see usd.bake_ppisp_into_sh).

One Adam loop (``torch.optim.Adam`` with optax.adam's defaults) over
(features_albedo, features_specular) with the render closure supplied
by the caller, as in JAX: the bake is renderer-agnostic. ``bake_ppisp``
renders through ``render_gut`` on the model's device, so on the card
every step launches kernels A and B (forward) and C, D and D's
inversion (backward), and every target render A and B.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def scale_sh_warm_start(features_albedo: torch.Tensor,
                        features_specular: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference scale_sh_output (sh_bake.py:33): scale the SH output by
    ``s`` with DC compensation for the +0.5 radiance offset."""
    s = float(scale)
    alb = features_albedo * s + (s - 1.0) * 0.5 / SH_C0
    spec = features_specular * s
    return alb, spec


def bake_post_processing(render_fn: Callable,
                         apply_isp_fn: Callable,
                         features_albedo: torch.Tensor,
                         features_specular: torch.Tensor,
                         frames: Sequence,
                         iters: int = 3000,
                         lr: float = 2e-3,
                         warm_start_scale: Optional[float] = None,
                         log_every: int = 0) -> Dict:
    """Fit SH coefficients so un-ISP'd renders match ISP'd renders.

    Args:
        render_fn: (albedo, specular, frame) -> [H, W, 3] rendered
            radiance with the given SH tensors on the frozen geometry.
        apply_isp_fn: (rgb, frame) -> [H, W, 3] post-processed target
            transform (the fixed ISP for that frame's camera).
        features_albedo / features_specular: initial SH coefficients.
        frames: sequence of frame descriptors cycled through round-robin
            (cameras / indices — opaque to this function).
        iters: optimization steps (reference default 3000).
        warm_start_scale: optional linear pre-scale (e.g. mean
            responsivity*2^exposure) applied via scale_sh_warm_start.
    Returns: dict with baked ``features_albedo`` / ``features_specular``
        (on the inputs' device), the loss history (each step's loss
        before its update) and the fixed ``targets``.
    """
    # fixed targets: ISP'd renders of the ORIGINAL coefficients
    with torch.no_grad():
        targets = [apply_isp_fn(render_fn(features_albedo,
                                          features_specular, fr), fr)
                   for fr in frames]

    alb, spec = features_albedo.detach(), features_specular.detach()
    if warm_start_scale is not None:
        alb, spec = scale_sh_warm_start(alb, spec, warm_start_scale)
    params = [torch.nn.Parameter(alb.clone()),
              torch.nn.Parameter(spec.clone())]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    losses = []
    for i in range(iters):
        k = i % len(frames)
        opt.zero_grad(set_to_none=True)
        pred = render_fn(params[0], params[1], frames[k])
        loss = torch.mean((pred - targets[k]) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if log_every and (i + 1) % log_every == 0:
            print(f"[sh_bake {i + 1}/{iters}] loss={float(loss):.6g}")
    history = torch.stack(losses).tolist() if losses else []
    return {"features_albedo": params[0].detach(),
            "features_specular": params[1].detach(),
            "loss_history": history, "targets": targets}


def _lerp_rows(values: torch.Tensor, lo: int, hi: int, s) -> torch.Tensor:
    """``TrajectoryViewSampler.interpolate_frame_values`` on the device:
    rows ``lo`` and ``hi`` lerped by the segment weight in float64 and
    rounded to float32, as JAX's numpy lerp and its cast give them."""
    v = values.double()
    return ((1.0 - float(s)) * v[lo] + float(s) * v[hi]).float()


@dataclasses.dataclass
class BakeViews:
    """The views a PPISP bake fits: cameras, the ISP frame of each and
    its per-frame overrides ((exposure, color_latents), or Nones for the
    table's row), and the warm-start scale."""
    cams: list
    isp_frames: list
    isp_overrides: list
    warm_start_scale: float


def bake_views(ppisp_params: Dict, dataset, view_sampling: str = "training",
               frame_indices: Optional[Sequence[int]] = None,
               n_views: int = 8, device="cpu") -> BakeViews:
    """The cameras and ISP terms of ``bake_ppisp``'s views (JAX
    sh_bake.py:130-158).

    view_sampling (reference sh_bake.py view_sampling):
      * ``"training"`` — the selected training views and their frames'
        ISP rows.
      * ``"trajectory"`` — ``n_views`` poses slerped along the training
        views ordered as a smooth path (export/view_interpolation.py),
        each with exposure and colour latents lerped by the same segment
        weight, through frame 0's remaining terms.

    The interpolated ISP terms stay on ``device``; the warm start is the
    responsivity of camera 0 times 2 to the mean exposure of the views,
    one host float, as in JAX.
    """
    from ..train.trainer import camera_from_batch

    exposure = ppisp_params["exposure"].detach()
    if view_sampling == "trajectory":
        from .view_interpolation import TrajectoryViewSampler
        poses = np.asarray(dataset.get_poses())
        sampler = TrajectoryViewSampler(poses)
        template = dataset[0]
        lat = ppisp_params["color_latents"].detach()
        cams, overrides = [], []
        for t in np.linspace(0.0, 1.0, n_views):
            pose, (lo, hi, s) = sampler.sample(float(t))
            b = dataclasses.replace(template,
                                    T_to_world=pose.astype(np.float32))
            cams.append(camera_from_batch(b, device))
            overrides.append((_lerp_rows(exposure, lo, hi, s),
                              _lerp_rows(lat, lo, hi, s)))
        frames = [0] * len(cams)
        exp_for_warm = np.asarray([float(e) for e, _ in overrides])
    elif view_sampling == "training":
        idxs = list(frame_indices if frame_indices is not None
                    else range(min(len(dataset), n_views)))
        cams = [camera_from_batch(dataset[i], device) for i in idxs]
        frames = idxs
        overrides = [(None, None)] * len(idxs)
        exp_for_warm = exposure[idxs].cpu().numpy()
    else:
        raise ValueError(f"unknown view_sampling mode {view_sampling!r}")
    resp = float(ppisp_params["responsivity"].detach()[0])
    return BakeViews(cams, frames, overrides,
                     2.0 ** (resp + float(np.mean(exp_for_warm))))


def bake_ppisp(model, ppisp_params: Dict, dataset, ut_conf, raster_cfg,
               sh_degree: int, frame_indices: Optional[Sequence[int]] = None,
               iters: int = 3000, lr: float = 2e-3,
               view_sampling: str = "training", n_views: int = 8,
               log_every: int = 0) -> Dict:
    """Convenience wrapper: bake the trained PPISP of a 3DGUT model.

    Renders through render_gut on the frozen geometry, on the model's
    device; the warm start is the mean linear scale over the selected
    frames (``bake_views``). The fit covers the whole capacity-long SH
    tensors, as JAX's does: rows past ``n_active`` get no gradient, so
    Adam leaves them at their warm start.
    """
    from ..models.gaussians import GaussianModel
    from ..models.post_processing import apply_ppisp
    from ..render.gut import render_gut

    views = bake_views(ppisp_params, dataset, view_sampling, frame_indices,
                       n_views, model.device)
    # the geometry, detached (its storage shared with ``model``); each
    # render sets the SH tensors it is given
    frozen = GaussianModel({k: v.detach() for k, v in model.params().items()},
                           model.n_active, model.n_active_features,
                           model.config).requires_grad_(False)

    def render_fn(alb, spec, fr_idx):
        frozen.features_albedo = alb
        frozen.features_specular = spec
        return render_gut(views.cams[fr_idx], ut_conf, raster_cfg, frozen,
                          sh_degree)["pred_features"]

    def isp_fn(rgb, fr_idx):
        e_ov, l_ov = views.isp_overrides[fr_idx]
        return apply_ppisp(ppisp_params, rgb, 0, views.isp_frames[fr_idx],
                           exposure=e_ov, color_latents=l_ov)

    return bake_post_processing(
        render_fn, isp_fn, model.features_albedo, model.features_specular,
        list(range(len(views.cams))), iters=iters, lr=lr,
        warm_start_scale=views.warm_start_scale, log_every=log_every)
