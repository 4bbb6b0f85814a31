"""The GS trainer (port of threedgrut_tpu/train/trainer.py,
GS strategy, single steps).

One Trainer owns the dataset iteration, the train step (render -> losses
-> backward -> masked Adam), the GS strategy callbacks between steps, the
learning-rate schedules, progressive SH, checkpointing and validation.

Contracts kept from the JAX trainer (reference threedgrut/trainer.py):
- loss: lambda_l1 * L1 + lambda_ssim * (1 - SSIM) (+ optional L2,
  opacity and scale terms),
- per-group learning rates, the positions one scaled by the scene extent
  with an exponential decay, and the cosine tail on the constant groups,
- GS hooks: the gradient buffer after the backward, densify / prune /
  reset / decay / prune by scale / blend-weight telemetry and prune by
  weight after the optimizer step,
- progressive SH degree every ``increase_frequency`` steps,
- SelectiveAdam visibility masking (``optimizer.type: selective_adam``),
- checkpoints with the JAX trainer's npz keys, so either package loads
  the other's.

Not ported (the JAX trainer's TPU-side machinery and other model kinds):
fused multi-step groups, the device GT cache, the pair-budget
calibration (the port sizes pairs per view), NHT, PPISP and MCMC.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models import background as bg_mod
from ..models.gaussians import GaussianModel
from ..ops.cameras import CameraModel, make_pinhole, rotmat_to_quat
from ..ops.ssim import psnr, ssim
from ..ops.ut import UTConfig, sensor_position
from ..optimizers import adam as adam_mod
from ..render.common import RasterConfig
from ..render.gut import render_gut
from ..strategy import base as strat_base
from ..strategy import gs as gs_strategy


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
    lr_rotation: float = 0.001
    lr_scale: float = 0.005
    positions_lr_final: float = 0.0000016
    positions_max_steps: int = 30000
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


def camera_from_batch(batch, device="cpu") -> CameraModel:
    """A pinhole camera from a batch's camera-to-world pose and
    intrinsics (global shutter). Fisheye and FTheta batches are not
    ported yet."""
    if getattr(batch, "T_to_world_end", None) is not None:
        raise NotImplementedError("rolling-shutter batches are not ported")
    for kind in ("OpenCVFisheye", "FTheta"):
        if getattr(batch, f"intrinsics_{kind}CameraModelParameters",
                   None) is not None:
            raise NotImplementedError(f"{kind} cameras are not ported")
    c2w = np.asarray(batch.T_to_world, np.float64)
    r_wc = c2w[:3, :3].T
    t_wc = -r_wc @ c2w[:3, 3]
    kw = dict(t=t_wc.astype(np.float32),
              q=rotmat_to_quat(r_wc).astype(np.float32), device=device)
    w, h = batch.resolution
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
    """GS training over one dataset, with the 3DGUT or, through
    ``conf.raster`` (``render/grt.py:grt_raster_config``, sorted
    compositing), the 3DGRT and sorted-3DGUT renderers."""

    def __init__(self, conf: TrainerConfig, dataset, model: GaussianModel,
                 val_dataset=None, raw_conf: Optional[dict] = None):
        if conf.strategy != "gs":
            raise NotImplementedError(f"strategy {conf.strategy}: only GS "
                                      "is ported")
        self.conf = conf
        self.raw_conf = raw_conf
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.model = model
        self.device = model.device
        self.scene_extent = float(dataset.get_scene_extent())
        self.global_step = 0
        # random backgrounds and split samples
        self.generator = torch.Generator(device=self.device).manual_seed(
            conf.seed)
        self.opt_state = adam_mod.init_adam_state(model.params())
        self.gs_buffers = gs_strategy.init_buffers(model.capacity,
                                                   self.device)
        # running max of the sampled views' blend weights, per particle
        # row, between weight-prune events (the JAX trainer's
        # gs_weight_buf)
        self.gs_weight_buf = torch.zeros(model.capacity, dtype=torch.float32,
                                         device=self.device)
        self.n_active_features = conf.init_n_features
        oc = conf.optimizer
        self._positions_lr = adam_mod.exp_scheduler(
            oc.lr_positions * self.scene_extent,
            oc.positions_lr_final * self.scene_extent,
            oc.positions_max_steps)
        self.train_wall_time = 0.0
        self.event_stats = []   # (step, kind, stats) of strategy events
        self._gt_cache: Dict[int, torch.Tensor] = {}

    def current_lrs(self, step: Optional[int] = None) -> Dict[str, float]:
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
        return {"positions": self._positions_lr(step),
                "rotation": oc.lr_rotation * tail,
                "scale": oc.lr_scale * tail,
                "density": oc.lr_density * tail,
                "features_albedo": oc.lr_features_albedo * tail,
                "features_specular": oc.lr_features_specular * tail}

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

    def loss(self, out, rgb_gt):
        """(total, losses dict, pred) of one render against its GT."""
        conf = self.conf
        bg = bg_mod.background_color(conf.background, self.generator,
                                     train=True, device=self.device)
        pred = bg_mod.apply_background(out["pred_features"],
                                       out["pred_opacity"], bg)
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

    def train_iteration(self, batch, frame_idx: Optional[int] = None
                        ) -> Dict[str, float]:
        """One step on one view; ``frame_idx`` is the view's index in the
        training dataset (its GT then stays on the device). Returns the
        step's metrics as floats."""
        cam = camera_from_batch(batch, self.device)
        rgb_gt = self._gt(batch, frame_idx)
        params = self.model.params()
        for p in params.values():
            p.grad = None
        out = render_gut(cam, self.conf.ut, self.conf.raster, self.model,
                         self.sh_degree())
        total, losses, pred = self.loss(out, rgb_gt)
        total.backward()
        grads = {k: p.grad for k, p in params.items()}
        visibility = (out["mog_visibility"]
                      if self.conf.optimizer.type == "selective_adam"
                      else None)
        self.opt_state = adam_mod.adam_step(
            params, grads, self.opt_state, self.current_lrs(),
            eps=self.conf.optimizer.eps, visibility=visibility,
            update_mask=self.model.active_mask())
        with torch.no_grad():
            metrics = {k: float(v) for k, v in losses.items()}
            metrics["psnr"] = float(psnr(torch.clamp(pred, 0.0, 1.0),
                                         rgb_gt))
        metrics["pairs"] = int(out["num_pairs"])
        metrics["overflow"] = int(out["pairs_overflow"])
        self._last_cam = cam
        self.global_step += 1
        self._post_backward(grads, cam)
        self._post_optimizer_step()
        self._progressive_features()
        return metrics

    def _post_backward(self, grads, cam):
        c = self.conf.gs
        if strat_base.check_step_condition(self.global_step, 0,
                                           c.densify_end, 1):
            self.gs_buffers = gs_strategy.update_gradient_buffer(
                self.gs_buffers, grads["positions"],
                self.model.positions.detach(), sensor_position(cam))

    def _post_optimizer_step(self, split_noise=None):
        """The GS events due at the current step, in the JAX trainer's
        order. ``split_noise`` optionally feeds densify's normals."""
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
                      f"({len(history) / dt:.1f} it/s)")
        self.train_wall_time += time.time() - t0
        return history

    @torch.no_grad()
    def validate(self, dataset=None) -> Dict[str, float]:
        """PSNR and SSIM over a dataset's views, per-ray hit statistics and
        the best and worst frame (no LPIPS)."""
        ds = dataset or self.val_dataset or self.dataset
        psnrs, ssims, hit_stats = [], [], []
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
            pred = torch.clamp(bg_mod.apply_background(
                out["pred_features"], out["pred_opacity"], bg), 0.0, 1.0)
            gt = _as_image(batch.rgb_gt, self.device)
            psnrs.append(float(psnr(pred, gt)))
            ssims.append(float(ssim(pred.permute(2, 0, 1)[None],
                                    gt.permute(2, 0, 1)[None])))
        hs = np.asarray(hit_stats)
        best, worst = int(np.argmax(psnrs)), int(np.argmin(psnrs))
        return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
                "n_views": len(psnrs), "psnr_best": psnrs[best],
                "best_frame": best, "psnr_worst": psnrs[worst],
                "worst_frame": worst, "hits_mean": float(np.mean(hs[:, 0])),
                "hits_std": float(np.mean(hs[:, 1])),
                "hits_min": float(np.min(hs[:, 2])),
                "hits_max": float(np.max(hs[:, 3]))}

    # --- checkpoints (the JAX trainer's npz keys) -----------------------

    def save_checkpoint(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        flat = {}
        for name, p in self.model.params().items():
            flat[f"params/{name}"] = p.detach().cpu().numpy()
            flat[f"opt/m/{name}"] = self.opt_state.exp_avg[name].cpu().numpy()
            flat[f"opt/v/{name}"] = \
                self.opt_state.exp_avg_sq[name].cpu().numpy()
        flat["opt/step"] = np.asarray(self.opt_state.step, np.int32)
        flat["n_active"] = np.asarray(self.model.n_active, np.int32)
        flat["global_step"] = np.asarray(self.global_step)
        flat["n_active_features"] = np.asarray(self.n_active_features)
        flat["gs/grad_accum"] = self.gs_buffers.grad_norm_accum.cpu().numpy()
        flat["gs/grad_denom"] = self.gs_buffers.grad_norm_denom.cpu().numpy()
        if self.raw_conf is not None:
            flat["config_json"] = np.asarray(json.dumps(dict(self.raw_conf)))
        np.savez(path, **flat)

    def load_checkpoint(self, path: str):
        dev = self.device
        with np.load(path) as data:
            def get(key):
                return torch.as_tensor(data[key], device=dev)

            names = list(self.model.params())
            self.model.set_params(**{k: get(f"params/{k}") for k in names})
            self.model.n_active = int(data["n_active"])
            self.opt_state = adam_mod.AdamState(
                step=int(data["opt/step"]),
                exp_avg={k: get(f"opt/m/{k}").clone() for k in names},
                exp_avg_sq={k: get(f"opt/v/{k}").clone() for k in names})
            self.global_step = int(data["global_step"])
            self.n_active_features = int(data["n_active_features"])
            if "gs/grad_accum" in data.files:
                self.gs_buffers = gs_strategy.GSBuffers(
                    get("gs/grad_accum").clone(),
                    get("gs/grad_denom").to(torch.int32).clone())
