"""The trainer (port of threedgrut_tpu/train/trainer.py, GS and MCMC
strategies, SH and NHT features, single steps).

One Trainer owns the dataset iteration, the train step (render -> [NHT
decoder] -> losses -> backward -> masked Adam), the strategy callbacks
between steps, the learning-rate schedules, progressive SH,
checkpointing and validation.

Contracts kept from the JAX trainer (reference threedgrut/trainer.py):
- loss: lambda_l1 * L1 + lambda_ssim * (1 - SSIM) (+ optional L2,
  opacity and scale terms),
- per-group learning rates, the positions one scaled by the scene extent
  with an exponential decay, and the cosine tail on the constant groups,
- GS hooks: the gradient buffer after the backward, densify / prune /
  reset / decay / prune by scale / blend-weight telemetry and prune by
  weight after the optimizer step; MCMC hooks after the optimizer step:
  relocate, then add, then perturb with the step's position lr
  (trainer.py:858-885),
- NHT (trainer.py:236-242, 345-370, 466-476, 714-715): the rendered ray
  features go through the decoder (models/nht_decoder.py) along the
  render's ray directions before the background; its weights are Adam
  groups that no row mask reaches, with their own cosine schedule, and
  its EMA shadow updates every step; the warmup and color-refine phases
  freeze positions, scale, rotation and density (the features keep
  training); validation decodes through the EMA shadow,
- progressive SH degree every ``increase_frequency`` steps,
- SelectiveAdam visibility masking (``optimizer.type: selective_adam``),
- ``post_processing: linear-to-srgb`` after the background, in the loss
  and in validation (trainer.py:483-485, 1264-1266); LPIPS in validation
  where its weights are found (trainer.py:1232-1242),
- ``post_processing: ppisp`` (trainer.py:244-252, 478-482, 898-970): the
  ISP's parameters (one camera, a row per dataset frame) are Adam groups
  ``ppisp/<name>`` at ``PPISP_LR`` that no row mask reaches unless a
  table has the capacity's length, so every frame's row moves on every
  step by its moments, as in JAX; the ISP runs on the composited colour
  in the loss, unclamped, with the step's frame. After training,
  ``distill_ppisp_controller`` fits the controller CNN to the learned
  per-frame terms on up to 32 training renders without the background
  (JAX's choice), and validation feeds the controller the composited
  image, or uses neutral per-frame terms without a controller,
- ``Trainer(enable_writer=True, out_dir=...)`` (trainer.py:216-231):
  the step's scalars and ``train/n_gaussians`` every step, the val
  scalars in ``validate`` and the panels of ``log_validation_images``
  through ``utils/misc.py:create_summary_writer``, which does nothing
  where tensorboardX does not import; ``train_torch.py`` turns it on
  nowhere, as ``train.py`` does not,
- checkpoints with the JAX trainer's npz keys (the decoder's as its
  flax key paths, params/nht_decoder//params/Dense_i/kernel; the ISP's
  as params/ppisp//<name>; no controller, as JAX saves none), so either
  package loads the other's.

Not ported (the JAX trainer's TPU-side machinery and other model kinds):
fused multi-step groups, the device GT cache and the pair-budget
calibration (the port sizes pairs per view).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..convert import flax_layer_names
from ..models import background as bg_mod
from ..models.gaussians import GaussianModel
from ..models.nht_decoder import FeatureDecoder
from ..models.ppisp import (PPISPControllerCNN, apply_ppisp_full,
                            init_ppisp_params)
from ..ops.cameras import (CameraModel, make_fisheye, make_ftheta,
                           make_pinhole, world_to_camera_pose)
from ..ops.ssim import psnr, ssim
from ..ops.ut import UTConfig, sensor_position
from ..optimizers import adam as adam_mod
from ..render.common import RasterConfig
from ..render.gut import render_gut
from ..strategy import base as strat_base
from ..strategy import gs as gs_strategy
from ..strategy import mcmc as mcmc_strategy
from ..utils import lpips as lpips_mod
from ..utils.misc import create_summary_writer, jet_map, linear_to_srgb
from ..utils.timer import ScopedTimer, host_read, timed

# the decoder's Adam groups, one per layer weight: "nht_decoder/<i>"
DECODER = "nht_decoder"
# the decoder's learning rate, cosine-decayed to a tenth over
# features_max_steps (configs/base.yaml nht_decoder; trainer.py:345-348)
DECODER_LR = 0.00068
# the ISP's Adam groups, "ppisp/<name>", and their fixed learning rate
# (JAX TrainerConfig.ppisp_lr, which no config sets; trainer.py:349-350)
PPISP = "ppisp"
PPISP_LR = 1e-3


@dataclasses.dataclass
class LossConfig:
    use_l1: bool = True
    lambda_l1: float = 0.8
    use_l2: bool = False
    lambda_l2: float = 1.0
    use_ssim: bool = True
    lambda_ssim: float = 0.2
    use_opacity: bool = False
    lambda_opacity: float = 0.0
    use_scale: bool = False
    lambda_scale: float = 0.0


@dataclasses.dataclass
class OptimizerConfig:
    """configs/base.yaml optimizer and scheduler blocks."""
    type: str = "adam"  # adam | selective_adam
    eps: float = 1e-15
    lr_positions: float = 0.00016
    lr_density: float = 0.05
    lr_features_albedo: float = 0.0025
    lr_features_specular: float = 0.000125
    lr_features: float = 0.015
    lr_rotation: float = 0.001
    lr_scale: float = 0.005
    positions_lr_final: float = 0.0000016
    positions_max_steps: int = 30000
    # the NHT features' cosine schedule (and the decoder's length)
    features_decay_final: float = 0.1
    features_max_steps: int = 30000
    # cosine tail on the constant groups from tail_start_frac of
    # positions_max_steps down to tail_final_scale (1.0: the reference's
    # constant learning rates)
    tail_start_frac: float = 0.66
    tail_final_scale: float = 0.1


@dataclasses.dataclass
class TrainerConfig:
    n_iterations: int = 30000
    strategy: str = "gs"
    background: bg_mod.BackgroundConfig = dataclasses.field(
        default_factory=bg_mod.BackgroundConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    gs: gs_strategy.GSStrategyConfig = dataclasses.field(
        default_factory=gs_strategy.GSStrategyConfig)
    mcmc: mcmc_strategy.MCMCStrategyConfig = dataclasses.field(
        default_factory=mcmc_strategy.MCMCStrategyConfig)
    ut: UTConfig = dataclasses.field(default_factory=UTConfig)
    raster: RasterConfig = dataclasses.field(default_factory=RasterConfig)
    # progressive SH
    init_n_features: int = 0
    max_n_features: int = 3
    increase_frequency: int = 1000
    increase_step: int = 1
    val_frequency: int = 5000
    seed: int = 42
    print_stats: bool = False
    # NHT phases that freeze the geometry groups: the last
    # nht_color_refine_steps steps, and the first nht_warmup_steps
    nht_color_refine_steps: int = 3000
    nht_warmup_steps: int = 0
    # post_processing.method: None, "linear-to-srgb" or "ppisp" on the
    # composited colour in the loss and in validation
    post_processing: Optional[str] = None
    ppisp_use_controller: bool = True
    ppisp_n_distillation_steps: int = 5000


_SHUTTER_NAMES = {
    "global": 0, "rolling_top_to_bottom": 1, "rolling_left_to_right": 2,
    "rolling_bottom_to_top": 3, "rolling_right_to_left": 4,
}


def camera_from_batch(batch, device="cpu") -> CameraModel:
    """A camera from a batch's camera-to-world pose(s) and intrinsics
    (JAX train/trainer.py:142-186): OpenCV fisheye, FTheta or pinhole by
    the intrinsics the batch carries; a rolling shutter, named by its
    ``shutter_type``, when it has an end pose ``T_to_world_end``."""
    t, q = world_to_camera_pose(batch.T_to_world)
    kw = dict(t=t, q=q, device=device)
    if getattr(batch, "T_to_world_end", None) is not None:
        kw["t_end"], kw["q_end"] = world_to_camera_pose(
            batch.T_to_world_end)
        kw["shutter_type"] = _SHUTTER_NAMES.get(
            str(getattr(batch, "shutter_type", "global")).lower(), 0)
    w, h = batch.resolution
    fish = getattr(batch, "intrinsics_OpenCVFisheyeCameraModelParameters",
                   None)
    if fish is not None:
        return make_fisheye((w, h), (fish["fx"], fish["fy"]),
                            (fish["cx"], fish["cy"]), fish["radial"],
                            fish.get("max_angle", np.pi / 2), **kw)
    fth = getattr(batch, "intrinsics_FThetaCameraModelParameters", None)
    if fth is not None:
        return make_ftheta(
            (w, h), (fth["cx"], fth["cy"]), fth["angle_to_pixeldist"],
            fth["pixeldist_to_angle"], fth.get("reference_poly", 0),
            fth.get("linear_cde", (1.0, 0.0, 0.0)),
            fth.get("max_angle", np.pi / 2), **kw)
    pin = getattr(batch, "intrinsics_OpenCVPinholeCameraModelParameters",
                  None)
    if pin is not None:
        return make_pinhole((w, h), (pin["fx"], pin["fy"]),
                            (pin["cx"], pin["cy"]), radial=pin["radial"],
                            tangential=pin["tangential"],
                            thin_prism=pin["thin_prism"], **kw)
    fx, fy, cx, cy = batch.intrinsics
    return make_pinhole((w, h), (fx, fy), (cx, cy), **kw)


def _as_image(rgb, device) -> torch.Tensor:
    """A view's [H, W, 3] GT (numpy or tensor) as f32 on ``device``."""
    if isinstance(rgb, torch.Tensor):
        return rgb.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(rgb, np.float32)).to(device)


class Trainer:
    """GS or MCMC training over one dataset, with the 3DGUT or, through
    ``conf.raster`` (``render/grt.py:grt_raster_config``, sorted
    compositing), the 3DGRT and sorted-3DGUT renderers; SH or NHT
    features."""

    def __init__(self, conf: TrainerConfig, dataset, model: GaussianModel,
                 val_dataset=None, out_dir: Optional[str] = None,
                 enable_writer: bool = False,
                 raw_conf: Optional[dict] = None):
        if conf.strategy not in ("gs", "mcmc"):
            raise NotImplementedError(f"strategy {conf.strategy}: gs or "
                                      "mcmc")
        if conf.post_processing not in (None, "linear-to-srgb", "ppisp"):
            raise ValueError(
                f"unknown post_processing method {conf.post_processing}")
        self.conf = conf
        self.raw_conf = raw_conf
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.model = model
        self.device = model.device
        # the summary writer (trainer.py:225-228): train and val scalars,
        # validation images; a MultiWriter that does nothing where no
        # backend imports
        self.out_dir = out_dir
        self.writer = None
        if enable_writer and out_dir:
            self.writer = create_summary_writer(out_dir)
        self.scene_extent = float(dataset.get_scene_extent())
        self.global_step = 0
        # random backgrounds, split, MCMC samples and perturb noise
        self.generator = torch.Generator(device=self.device).manual_seed(
            conf.seed)
        # the NHT decoder (threedgrut/model/feature_decoder.py), the JAX
        # trainer's defaults: 2 d ray features in, seeded by conf.seed
        self.decoder = None
        if model.config.feature_type == "nht":
            self.decoder = FeatureDecoder(model.features.shape[1] // 2,
                                          seed=conf.seed, device=self.device)
        # the learned ISP: one camera, a row per dataset frame
        # (trainer.py:249-252)
        self.ppisp_params = None
        self.ppisp_controller = None
        self.ppisp_distill_first_loss = None
        if conf.post_processing == "ppisp":
            self.ppisp_params = {
                k: torch.nn.Parameter(v) for k, v in init_ppisp_params(
                    1, len(dataset), device=self.device).items()}
        self.opt_state = adam_mod.init_adam_state(self.params())
        self.gs_buffers = None
        if conf.strategy == "gs":
            self.gs_buffers = gs_strategy.init_buffers(model.capacity,
                                                       self.device)
            # running max of the sampled views' blend weights, per
            # particle row, between weight-prune events (the JAX
            # trainer's gs_weight_buf)
            self.gs_weight_buf = torch.zeros(
                model.capacity, dtype=torch.float32, device=self.device)
        self.n_active_features = conf.init_n_features
        oc = conf.optimizer
        self._positions_lr = adam_mod.exp_scheduler(
            oc.lr_positions * self.scene_extent,
            oc.positions_lr_final * self.scene_extent,
            oc.positions_max_steps)
        self._features_lr = adam_mod.cosine_scheduler(
            oc.lr_features, oc.lr_features * oc.features_decay_final,
            oc.features_max_steps)
        self._decoder_lr = adam_mod.cosine_scheduler(
            DECODER_LR, DECODER_LR * 0.1, oc.features_max_steps)
        self.train_wall_time = 0.0
        self.event_stats = []   # (step, kind, stats) of strategy events
        self._gt_cache: Dict[int, torch.Tensor] = {}

    def params(self) -> Dict[str, torch.nn.Parameter]:
        """The optimizer's groups: the model's raw parameters, for NHT the
        decoder's weights as ``nht_decoder/<i>``, and for PPISP the ISP's
        tables as ``ppisp/<name>``."""
        out = dict(self.model.params())
        if self.decoder is not None:
            out.update({f"{DECODER}/{i}": w
                        for i, w in enumerate(self.decoder.weights())})
        if self.ppisp_params is not None:
            out.update({f"{PPISP}/{k}": v
                        for k, v in self.ppisp_params.items()})
        return out

    def current_lrs(self, step: Optional[int] = None) -> Dict[str, float]:
        """The learning rate of each group at ``step``, under the JAX
        trainer's names (one ``nht_decoder`` entry for the decoder)."""
        step = self.global_step if step is None else step
        oc = self.conf.optimizer
        tail = 1.0
        if oc.tail_final_scale < 1.0:
            t0 = oc.tail_start_frac * oc.positions_max_steps
            if step > t0:
                u = min((step - t0) / max(oc.positions_max_steps - t0, 1.0),
                        1.0)
                tail = (oc.tail_final_scale
                        + 0.5 * (1.0 - oc.tail_final_scale)
                        * (1.0 + float(np.cos(np.pi * u))))
        lrs = {"positions": self._positions_lr(step),
               "rotation": oc.lr_rotation * tail,
               "scale": oc.lr_scale * tail,
               "density": oc.lr_density * tail}
        if self.model.config.feature_type == "nht":
            lrs["features"] = self._features_lr(step)
        else:
            lrs["features_albedo"] = oc.lr_features_albedo * tail
            lrs["features_specular"] = oc.lr_features_specular * tail
        if self.decoder is not None:
            lrs[DECODER] = self._decoder_lr(step)
        if self.ppisp_params is not None:
            lrs[PPISP] = PPISP_LR
        # the NHT warmup and color-refine phases freeze the geometry only
        # (the reference's _color_refine_frozen_param_names)
        if self._in_color_refine(step):
            for k in ("positions", "scale", "rotation", "density"):
                lrs[k] = 0.0
        return lrs

    def _in_color_refine(self, step: int) -> bool:
        if self.decoder is None:
            return False
        if step < self.conf.nht_warmup_steps:
            return True
        return step >= max(self.conf.n_iterations
                           - self.conf.nht_color_refine_steps, 0)

    def _group_lrs(self) -> Dict[str, float]:
        """current_lrs by optimizer group (each decoder weight and ISP
        table its own)."""
        lrs = self.current_lrs()
        for prefix in (DECODER, PPISP):
            lr = lrs.pop(prefix, None)
            if lr is not None:
                lrs.update({k: lr for k in self.params()
                            if k.startswith(prefix + "/")})
        return lrs

    def sh_degree(self) -> int:
        return min(self.n_active_features, self.conf.max_n_features)

    def _gt(self, batch, frame_idx: Optional[int]) -> torch.Tensor:
        """The batch's GT on the device; a dataset frame (``frame_idx``
        given) is uploaded once."""
        if frame_idx is None:
            return _as_image(batch.rgb_gt, self.device)
        gt = self._gt_cache.get(frame_idx)
        if gt is None:
            gt = _as_image(batch.rgb_gt, self.device)
            self._gt_cache[frame_idx] = gt
        return gt

    def decode(self, out, use_ema: bool = False) -> torch.Tensor:
        """A render's [H, W, 3] colour: its features, or for NHT their
        decoding along the render's ray directions (trainer.py:466-474;
        ``use_ema``: through the EMA shadow, as validation does)."""
        features = out["pred_features"]
        if self.decoder is None:
            return features
        h, w, f = features.shape
        with ScopedTimer("grut.decoder"):
            return self.decoder(features.reshape(-1, f),
                                out["ray_d"].reshape(-1, 3),
                                use_ema=use_ema).reshape(h, w, 3)

    def post_process(self, pred: torch.Tensor, frame_idx: int = 0
                     ) -> torch.Tensor:
        """The configured post-processing of a composited colour in the
        loss (JAX trainer.py:478-485): the ISP of frame ``frame_idx``
        unclamped, linear-to-srgb on the clamped colour, or none."""
        if self.ppisp_params is not None:
            with ScopedTimer("grut.isp"):
                return apply_ppisp_full(self.ppisp_params, pred, 0,
                                        frame_idx)
        if self.conf.post_processing == "linear-to-srgb":
            return linear_to_srgb(torch.clamp(pred, 0.0, 1.0))
        return pred

    @timed("grut.loss")
    def loss(self, out, rgb_gt, frame_idx: int = 0):
        """(total, losses dict, pred) of one render of dataset frame
        ``frame_idx`` against its GT."""
        conf = self.conf
        color = self.decode(out)
        bg = bg_mod.background_color(conf.background, self.generator,
                                     train=True, device=self.device)
        pred = self.post_process(
            bg_mod.apply_background(color, out["pred_opacity"], bg),
            frame_idx)
        losses = {}
        total = torch.zeros((), device=self.device)
        if conf.loss.use_l1:
            losses["l1"] = torch.mean(torch.abs(pred - rgb_gt))
            total = total + conf.loss.lambda_l1 * losses["l1"]
        if conf.loss.use_l2:
            losses["l2"] = torch.mean((pred - rgb_gt) ** 2)
            total = total + conf.loss.lambda_l2 * losses["l2"]
        if conf.loss.use_ssim:
            s = ssim(pred.permute(2, 0, 1)[None],
                     rgb_gt.permute(2, 0, 1)[None])
            losses["ssim"] = 1.0 - s
            total = total + conf.loss.lambda_ssim * (1.0 - s)
        if conf.loss.use_opacity:
            losses["opacity"] = torch.mean(torch.abs(self.model.get_density()))
            total = total + conf.loss.lambda_opacity * losses["opacity"]
        if conf.loss.use_scale:
            losses["scale"] = torch.mean(torch.abs(self.model.get_scale()))
            total = total + conf.loss.lambda_scale * losses["scale"]
        losses["total"] = total
        return total, losses, pred

    @timed("grut.step", unit=True)
    def train_iteration(self, batch, frame_idx: Optional[int] = None
                        ) -> Dict[str, float]:
        """One step on one view; ``frame_idx`` is the view's index in the
        training dataset (its GT then stays on the device). Returns the
        step's metrics as floats."""
        cam = camera_from_batch(batch, self.device)
        rgb_gt = self._gt(batch, frame_idx)
        params = self.params()
        for p in params.values():
            p.grad = None
        out = render_gut(cam, self.conf.ut, self.conf.raster, self.model,
                         self.sh_degree())
        total, losses, pred = self.loss(out, rgb_gt, frame_idx or 0)
        with ScopedTimer("grut.backward"):
            total.backward()
        grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
                 for k, p in params.items()}
        visibility = (out["mog_visibility"]
                      if self.conf.optimizer.type == "selective_adam"
                      else None)
        self.opt_state = adam_mod.adam_step(
            params, grads, self.opt_state, self._group_lrs(),
            eps=self.conf.optimizer.eps, visibility=visibility,
            update_mask=self.model.active_mask())
        with torch.no_grad():
            metrics = {k: float(host_read("loss", v))
                       for k, v in losses.items()}
            metrics["psnr"] = float(host_read("psnr", psnr(
                torch.clamp(pred, 0.0, 1.0), rgb_gt)))
        metrics["pairs"] = int(host_read("pairs", out["num_pairs"]))
        metrics["overflow"] = int(host_read("overflow",
                                            out["pairs_overflow"]))
        self._last_cam = cam
        self.global_step += 1
        if self.decoder is not None:
            with ScopedTimer("grut.decoder.ema"):
                self.decoder.ema_update()
        self._post_backward(grads, cam)
        self._post_optimizer_step()
        self._progressive_features()
        if self.writer is not None:   # trainer.py:718-724
            for k, v in metrics.items():
                self.writer.add_scalar(f"train/{k}", float(v),
                                       self.global_step)
            self.writer.add_scalar("train/n_gaussians", self.model.n_active,
                                   self.global_step)
        return metrics

    def _post_backward(self, grads, cam):
        if self.conf.strategy != "gs":
            return
        c = self.conf.gs
        if strat_base.check_step_condition(self.global_step, 0,
                                           c.densify_end, 1):
            self.gs_buffers = gs_strategy.update_gradient_buffer(
                self.gs_buffers, grads["positions"],
                self.model.positions.detach(), sensor_position(cam))

    def _post_optimizer_step(self, split_noise=None):
        """The strategy events due at the current step, in the JAX
        trainer's order. ``split_noise`` optionally feeds densify's
        normals."""
        if self.conf.strategy == "mcmc":
            self._mcmc_events()
            return
        step = self.global_step
        c = self.conf.gs
        model, opt = self.model, self.opt_state
        if strat_base.check_step_condition(step, c.densify_start,
                                           c.densify_end,
                                           c.densify_frequency):
            self.gs_buffers, stats = gs_strategy.densify(
                model, opt, self.gs_buffers, self.scene_extent,
                clone_grad_threshold=c.clone_grad_threshold,
                split_grad_threshold=c.split_grad_threshold,
                relative_size_threshold=c.relative_size_threshold,
                n_split=c.split_n_gaussians, noise=split_noise,
                generator=self.generator)
            self._event(step, "densify", dict(stats, n=model.n_active))
        if strat_base.check_step_condition(step, c.prune_start, c.prune_end,
                                           c.prune_frequency):
            self.gs_buffers, n_pruned = gs_strategy.prune_opacity(
                model, opt, self.gs_buffers, c.prune_density_threshold)
            self._event(step, "pruned", dict(n_pruned=n_pruned,
                                             n=model.n_active))
        if strat_base.check_step_condition(step, c.reset_density_start,
                                           c.reset_density_end,
                                           c.reset_density_frequency):
            gs_strategy.reset_density(model, opt, c.new_max_density)
            self._event(step, "reset", dict(n=model.n_active))
        if strat_base.check_step_condition(step, c.density_decay_start,
                                           c.density_decay_end,
                                           c.density_decay_frequency):
            gs_strategy.decay_density(model, c.density_decay_gamma)
        if strat_base.check_step_condition(step, c.prune_scale_start,
                                           c.prune_scale_end,
                                           c.prune_scale_frequency):
            poses = np.asarray(self.dataset.get_poses())
            cam_normals = torch.tensor(poses[:, :3, 2], dtype=torch.float32,
                                       device=self.device)
            focal = (float(self.dataset[0].intrinsics[0])
                     if self.dataset[0].intrinsics else 1000.0)
            self.gs_buffers, n_pruned = gs_strategy.prune_scale(
                model, opt, self.gs_buffers, cam_normals, focal,
                c.prune_scale_threshold)
            self._event(step, "scale-pruned", dict(n_pruned=n_pruned,
                                                   n=model.n_active))
        if c.prune_weight_frequency > 0 and strat_base.check_step_condition(
                step, c.prune_weight_start, c.prune_weight_end,
                c.weight_telemetry_frequency):
            # sample the step's view into the running max (kernel E)
            out = render_gut(self._last_cam, self.conf.ut, self.conf.raster,
                             model, self.sh_degree(), weight_telemetry=True)
            torch.maximum(self.gs_weight_buf, out["particle_wmax"],
                          out=self.gs_weight_buf)
        if strat_base.check_step_condition(step, c.prune_weight_start,
                                           c.prune_weight_end,
                                           c.prune_weight_frequency):
            self.gs_buffers, n_pruned = gs_strategy.prune_weight(
                model, opt, self.gs_buffers, self.gs_weight_buf,
                c.prune_weight_threshold)
            # the next window accumulates fresh telemetry
            self.gs_weight_buf.zero_()
            self._event(step, "weight-pruned", dict(n_pruned=n_pruned,
                                                    n=model.n_active))

    @timed("grut.mcmc")
    def _mcmc_events(self):
        """relocate, add, then perturb with the position lr of the new
        step (trainer.py:858-885)."""
        step, c = self.global_step, self.conf.mcmc
        model, opt = self.model, self.opt_state
        if strat_base.check_step_condition(step, c.relocate_start,
                                           c.relocate_end,
                                           c.relocate_frequency):
            n_active = model.n_active
            with ScopedTimer("grut.mcmc.relocate"):
                n_rel = mcmc_strategy.relocate(
                    model, opt, self.generator,
                    opacity_threshold=c.opacity_threshold,
                    n_max=c.binom_n_max)
            self._event(step, "relocate", dict(n_relocated=n_rel,
                                               n_active=n_active))
        if strat_base.check_step_condition(step, c.add_start, c.add_end,
                                           c.add_frequency):
            with ScopedTimer("grut.mcmc.add"):
                n_added = mcmc_strategy.add_gaussians(
                    model, opt, self.generator, max_n=c.max_n_gaussians,
                    n_max=c.binom_n_max)
            self._event(step, "add", dict(n_added=n_added,
                                          n=model.n_active))
        if strat_base.check_step_condition(step, c.perturb_start,
                                           c.perturb_end,
                                           c.perturb_frequency):
            with ScopedTimer("grut.mcmc.perturb"):
                mcmc_strategy.perturb(model, self.generator,
                                      self._positions_lr(step), c.noise_lr)

    def _event(self, step, kind, stats):
        self.event_stats.append((step, kind, stats))
        if self.conf.print_stats:
            flat = " ".join(f"{k}={int(v)}" for k, v in stats.items())
            print(f"[{step}] {kind}: {flat}")

    def _progressive_features(self):
        conf = self.conf
        if (self.n_active_features < conf.max_n_features
                and conf.increase_frequency > 0
                and self.global_step % conf.increase_frequency == 0):
            self.n_active_features = min(
                conf.max_n_features,
                self.n_active_features + conf.increase_step)

    def run_training(self, max_steps: Optional[int] = None,
                     log_every: int = 0):
        """Single steps up to ``max_steps``, over the frames in a seeded
        shuffled order (the JAX trainer's order). Returns the metrics of
        every step."""
        n = max_steps or self.conf.n_iterations
        order = None
        history = []
        t0 = time.time()
        while self.global_step < n:
            if not order:
                order = list(np.random.default_rng(
                    self.conf.seed + self.global_step).permutation(
                        len(self.dataset)))
            idx = int(order.pop())
            metrics = self.train_iteration(self.dataset[idx], frame_idx=idx)
            history.append(metrics)
            if log_every and self.global_step % log_every == 0:
                dt = time.time() - t0
                print(f"step {self.global_step}: "
                      f"loss={metrics['total']:.4f} "
                      f"psnr={metrics['psnr']:.2f} "
                      f"n={self.model.n_active} "
                      # JAX's figure (trainer.py:1219): the global step
                      # over this call's time, which scripts/conv_table.py
                      # turns back into the window's rate
                      f"({self.global_step / dt:.1f} it/s)")
        self.train_wall_time += time.time() - t0
        return history

    # --- PPISP controller distillation (trainer.py:898-970) --------------

    def distill_ppisp_controller(self, steps: Optional[int] = None,
                                 max_frames: int = 32,
                                 downsample: int = 4) -> Optional[float]:
        """Fit the controller CNN to the learned per-frame (exposure,
        colour latents) on renders of the first ``max_frames`` training
        views with the frozen model, every ``downsample``-th pixel of
        ``pred_features`` without the background; Adam at 1e-3 on the
        loss (e - te)^2 + mean((c - tl)^2), averaged over the frames.
        Returns the last step's loss (None when PPISP or its controller
        is off)."""
        if self.ppisp_params is None or not self.conf.ppisp_use_controller:
            return None
        steps = steps or self.conf.ppisp_n_distillation_steps
        n_frames = min(len(self.dataset), max_frames)
        with torch.no_grad():
            imgs = []
            for i in range(n_frames):
                cam = camera_from_batch(self.dataset[i], self.device)
                out = render_gut(cam, self.conf.ut, self.conf.raster,
                                 self.model, self.sh_degree())
                imgs.append(out["pred_features"][::downsample,
                                                 ::downsample, :3])
            imgs = torch.stack(imgs)                      # [F, h, w, 3]
            t_exp = self.ppisp_params["exposure"][:n_frames].detach().clone()
            t_lat = self.ppisp_params["color_latents"][:n_frames] \
                .detach().clone()
        ctrl = PPISPControllerCNN(seed=self.conf.seed, device=self.device)
        opt = torch.optim.Adam(ctrl.parameters(), lr=1e-3)
        prior = torch.zeros(n_frames, device=self.device)
        loss = None
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            e, c = ctrl(imgs, prior)
            loss = torch.mean((e - t_exp) ** 2
                              + torch.mean((c - t_lat) ** 2, dim=-1))
            loss.backward()
            opt.step()
            if i == 0:
                self.ppisp_distill_first_loss = float(loss.detach())
        self.ppisp_controller = ctrl
        self._ppisp_distill_downsample = downsample
        return float(loss.detach()) if loss is not None else None

    def _apply_ppisp_eval(self, pred: torch.Tensor) -> torch.Tensor:
        """The validation-time ISP: the controller's prediction on the
        composited image through the trained per-camera transform; without
        a controller, neutral per-frame terms."""
        p = self.ppisp_params
        if self.ppisp_controller is not None:
            ds = self._ppisp_distill_downsample
            exposure, latents = self.ppisp_controller.predict(
                pred[::ds, ::ds, :3], 0.0)
            return apply_ppisp_full(p, pred, 0, 0, exposure=exposure,
                                    color_latents=latents)
        return apply_ppisp_full(
            p, pred, 0, 0, exposure=torch.zeros((), device=pred.device),
            color_latents=torch.zeros(8, device=pred.device))

    @torch.no_grad()
    def validate(self, dataset=None) -> Dict[str, float]:
        """PSNR and SSIM over a dataset's views, per-ray hit statistics,
        the best and worst frame, and LPIPS where its weights are found
        (``utils/lpips.py:load_weights``); NHT decodes through the EMA
        shadow."""
        ds = dataset or self.val_dataset or self.dataset
        psnrs, ssims, lpipss, hit_stats = [], [], [], []
        lpips_params = lpips_mod.load_weights(device=self.device)
        bg = bg_mod.background_color(self.conf.background, train=False,
                                     device=self.device)
        for i in range(len(ds)):
            batch = ds[i]
            cam = camera_from_batch(batch, self.device)
            out = render_gut(cam, self.conf.ut, self.conf.raster, self.model,
                             self.sh_degree())
            hc = out["hits_count"]
            hit_stats.append((float(hc.mean()), float(hc.std(correction=0)),
                              float(hc.min()), float(hc.max())))
            pred = bg_mod.apply_background(self.decode(out, use_ema=True),
                                           out["pred_opacity"], bg)
            # trainer.py:1262-1266
            pred = torch.clamp(self._apply_ppisp_eval(pred)
                               if self.ppisp_params is not None
                               else self.post_process(pred), 0.0, 1.0)
            gt = _as_image(batch.rgb_gt, self.device)
            psnrs.append(float(psnr(pred, gt)))
            ssims.append(float(ssim(pred.permute(2, 0, 1)[None],
                                    gt.permute(2, 0, 1)[None])))
            if lpips_params is not None:
                lpipss.append(float(lpips_mod.lpips(
                    lpips_params, pred.permute(2, 0, 1)[None],
                    gt.permute(2, 0, 1)[None])))
        hs = np.asarray(hit_stats)
        best, worst = int(np.argmax(psnrs)), int(np.argmin(psnrs))
        result = {"psnr": float(np.mean(psnrs)),
                  "ssim": float(np.mean(ssims)),
                  "n_views": len(psnrs), "psnr_best": psnrs[best],
                  "best_frame": best, "psnr_worst": psnrs[worst],
                  "worst_frame": worst,
                  "hits_mean": float(np.mean(hs[:, 0])),
                  "hits_std": float(np.mean(hs[:, 1])),
                  "hits_min": float(np.min(hs[:, 2])),
                  "hits_max": float(np.max(hs[:, 3]))}
        if lpipss:
            result["lpips"] = float(np.mean(lpipss))
        if self.writer is not None:   # trainer.py:1298-1304
            for k in ("psnr", "ssim", "hits_mean", "hits_max"):
                self.writer.add_scalar(f"val/{k}", result[k],
                                       self.global_step)
            if "lpips" in result:
                self.writer.add_scalar("val/lpips", result["lpips"],
                                       self.global_step)
        return result

    @torch.no_grad()
    def log_validation_images(self, batch, max_hits: float = 128.0):
        """Render one view and log its gt, pred, depth, opacity and hit
        count panels, the last three as jet maps (trainer.py:1307-1342);
        NHT decodes through the EMA shadow. Returns the [H, W, 3] images
        by name."""
        cam = camera_from_batch(batch, self.device)
        out = render_gut(cam, self.conf.ut, self.conf.raster, self.model,
                         self.sh_degree())
        bg = bg_mod.background_color(self.conf.background, train=False,
                                     device=self.device)
        pred = torch.clamp(bg_mod.apply_background(
            self.decode(out, use_ema=True), out["pred_opacity"], bg), 0, 1)
        images = {
            "pred": pred,
            "depth": jet_map(out["pred_dist"], 100.0),
            "opacity": jet_map(out["pred_opacity"], 1.0),
            "hits": jet_map(out["hits_count"], max_hits),
        }
        if batch.rgb_gt is not None:
            images["gt"] = torch.clamp(_as_image(batch.rgb_gt, self.device),
                                       0, 1)
        if self.writer is not None:
            for name, img in images.items():
                self.writer.add_image(f"val/{name}", img, self.global_step)
        return images

    # --- checkpoints (the JAX trainer's npz keys) -----------------------

    def _checkpoint_keys(self) -> Dict[str, str]:
        """optimizer group -> its name in the JAX checkpoints: the
        parameter's own, the decoder's flax key path, whose kernels are
        stored [in, out], or the ISP table's ``ppisp//<name>`` (JAX's
        '/'-joined key path of its dict group, trainer.py:1345-1356)."""
        keys = {k: k for k in self.model.params()}
        if self.decoder is not None:
            layers = flax_layer_names(len(self.decoder.weights()))
            keys.update({f"{DECODER}/{i}": f"{DECODER}//params/{n}/kernel"
                         for i, n in enumerate(layers)})
        if self.ppisp_params is not None:
            keys.update({f"{PPISP}/{k}": f"{PPISP}//{k}"
                         for k in self.ppisp_params})
        return keys

    def save_checkpoint(self, path: str):
        """The JAX trainer's npz keys (trainer.py:1374-1393); the decoder's
        EMA shadow goes under ``ema/``, which the JAX trainer does not
        read."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

        def arr(name, t):   # decoder weights are stored as flax kernels
            a = t.detach().cpu().numpy()
            return a.T if name.startswith(DECODER) else a

        flat = {}
        params, keys = self.params(), self._checkpoint_keys()
        for name, key in keys.items():
            flat[f"params/{key}"] = arr(name, params[name])
            flat[f"opt/m/{key}"] = arr(name, self.opt_state.exp_avg[name])
            flat[f"opt/v/{key}"] = arr(name, self.opt_state.exp_avg_sq[name])
        if self.decoder is not None:
            for i, t in enumerate(self.decoder.ema_shadow):
                flat[f"ema/{keys[f'{DECODER}/{i}']}"] = arr(DECODER, t)
        flat["opt/step"] = np.asarray(self.opt_state.step, np.int32)
        flat["n_active"] = np.asarray(self.model.n_active, np.int32)
        flat["global_step"] = np.asarray(self.global_step)
        flat["n_active_features"] = np.asarray(self.n_active_features)
        if self.gs_buffers is not None:
            flat["gs/grad_accum"] = \
                self.gs_buffers.grad_norm_accum.cpu().numpy()
            flat["gs/grad_denom"] = \
                self.gs_buffers.grad_norm_denom.cpu().numpy()
        if self.raw_conf is not None:
            flat["config_json"] = np.asarray(json.dumps(dict(self.raw_conf)))
        np.savez(path, **flat)

    def load_checkpoint(self, path: str):
        dev = self.device
        with np.load(path) as data:
            def get(name, key):
                t = torch.as_tensor(data[key], device=dev)
                return t.T.contiguous() if name.startswith(DECODER) else t

            keys = self._checkpoint_keys()
            with torch.no_grad():
                for name, p in self.params().items():
                    key = f"params/{keys[name]}"
                    if not name.startswith(PPISP + "/"):
                        p.copy_(get(name, key))
                    elif key in data.files:
                        # the ISP's tables as the file has them (JAX
                        # replaces its dict, trainer.py:314-316): a row per
                        # frame of the run that wrote it
                        self.ppisp_params[name.split("/", 1)[1]] = \
                            torch.nn.Parameter(get(name, key).clone())
                if self.decoder is not None:
                    for i, t in enumerate(self.decoder.ema_shadow):
                        key = f"ema/{keys[f'{DECODER}/{i}']}"
                        if key in data.files:
                            t.copy_(get(DECODER, key))
            self.model.n_active = int(data["n_active"])
            params = self.params()
            # an ISP table the file lacks starts its moments at zero
            moments = [{k: (get(k, f"opt/{which}/{v}").clone()
                            if f"opt/{which}/{v}" in data.files
                            or not k.startswith(PPISP + "/")
                            else torch.zeros_like(params[k]))
                        for k, v in keys.items()}
                       for which in ("m", "v")]
            self.opt_state = adam_mod.AdamState(
                step=int(data["opt/step"]), exp_avg=moments[0],
                exp_avg_sq=moments[1])
            self.global_step = int(data["global_step"])
            self.n_active_features = int(data["n_active_features"])
            if self.gs_buffers is not None and \
                    "gs/grad_accum" in data.files:
                self.gs_buffers = gs_strategy.GSBuffers(
                    get("", "gs/grad_accum").clone(),
                    get("", "gs/grad_denom").to(torch.int32).clone())
