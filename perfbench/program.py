"""The system under test, as the benchmark drives it: the port's
configuration loader, model, trainer, cameras and serving renderer.

The benchmark hands the port only what a user would: the published app
configuration, raw parameters made from the seed, posed views with their
images. Imports of the port happen inside these functions, so that the
harness's own modules load without it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from . import scene


def trainer_config(conf: dict, seed: int):
    """The port's TrainerConfig of the configuration's published app,
    its seed set to the run's (and the file's ``app_overrides``, which
    only the CPU tests' small configurations give); raises where the app differs from what the
    configuration file states (the file then would not be the
    configuration as run)."""
    import contextlib
    import io

    from threedgrut_tpu_torch.config.loader import load_config
    from threedgrut_tpu_torch.train import trainer as trainer_mod
    from train_torch import trainer_config as to_trainer

    with contextlib.redirect_stderr(io.StringIO()):
        tc = to_trainer(load_config(conf["app"], overrides=[
            "path=none", *conf.get("app_overrides", [])]))
    t, r = conf["train"], conf["render"]
    got = {
        "strategy": tc.strategy, "optimizer": tc.optimizer.type,
        "background": tc.background.color,
        "post_processing": tc.post_processing,
        "ppisp_lr": trainer_mod.PPISP_LR,
        "loss": {"lambda_l1": tc.loss.lambda_l1 * tc.loss.use_l1,
                 "lambda_ssim": tc.loss.lambda_ssim * tc.loss.use_ssim,
                 "lambda_opacity": tc.loss.lambda_opacity
                 * tc.loss.use_opacity,
                 "lambda_scale": tc.loss.lambda_scale * tc.loss.use_scale},
        "lr": {"positions": tc.optimizer.lr_positions,
               "density": tc.optimizer.lr_density,
               "features_albedo": tc.optimizer.lr_features_albedo,
               "features_specular": tc.optimizer.lr_features_specular,
               "rotation": tc.optimizer.lr_rotation,
               "scale": tc.optimizer.lr_scale},
        "positions_lr_final": tc.optimizer.positions_lr_final,
        "positions_max_steps": tc.optimizer.positions_max_steps,
        "tail_start_frac": tc.optimizer.tail_start_frac,
        "tail_final_scale": tc.optimizer.tail_final_scale,
        "betas": [0.9, 0.999], "eps": tc.optimizer.eps,
        "relocate_start": tc.mcmc.relocate_start,
        "relocate_end": tc.mcmc.relocate_end,
        "relocate_frequency": tc.mcmc.relocate_frequency,
        "add_start": tc.mcmc.add_start,
        "add_end": tc.mcmc.add_end,
        "add_frequency": tc.mcmc.add_frequency,
        "binom_n_max": tc.mcmc.binom_n_max,
        "perturb_noise_lr": tc.mcmc.noise_lr,
        "perturb_end": tc.mcmc.perturb_end,
        "opacity_threshold": tc.mcmc.opacity_threshold,
    }
    got_render = {
        "particle_kernel_degree": tc.raster.kernel_degree,
        "particle_kernel_min_response": tc.raster.min_response,
        "particle_kernel_min_alpha": tc.raster.min_alpha,
        "particle_kernel_max_alpha": tc.raster.max_alpha,
        "min_transmittance": tc.raster.min_transmittance,
        "ut_alpha": tc.ut.alpha, "ut_beta": tc.ut.beta,
        "ut_kappa": tc.ut.kappa,
        "ut_in_image_margin_factor": tc.ut.image_margin_factor,
        "tile_based_culling": tc.raster.tile_culling,
        "rect_bounding": tc.ut.rect_bounding,
        "tight_opacity_bounding": tc.ut.tight_opacity_bounding,
        "global_z_order": tc.ut.global_z_order,
        "k_buffer_size": 16 if tc.raster.sorted_compositing else 0,
    }
    diffs = [f"{k}: app {got[k]} != file {t[k]}" for k in got
             if not _same(got[k], t[k])]
    diffs += [f"render.{k}: app {got_render[k]} != file {r[k]}"
              for k in got_render if not _same(got_render[k], r[k])]
    if tc.mcmc.max_n_gaussians != conf["max_n_gaussians"]:
        diffs.append("max_n_gaussians")
    if tc.max_n_features != conf["sh_degree"] or (
            tc.n_iterations != conf["n_iterations"]):
        diffs.append("sh degree or n_iterations")
    if diffs:
        raise SystemExit(f"{conf['app']} differs from {conf['name']}'s "
                         "file: " + "; ".join(diffs))
    return dataclasses.replace(tc, seed=seed)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b)) <= 1e-12 * max(abs(float(b)), 1.0)
    return a == b


def gaussian_model(params: Dict[str, torch.Tensor], sh_degree: int):
    """The port's model over raw parameters (every row active); the model
    takes the tensors over, so the caller keeps no reference."""
    from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                       GaussianModelConfig)

    n = params["positions"].shape[0]
    return GaussianModel(params, n_active=n, n_active_features=sh_degree,
                         config=GaussianModelConfig(max_sh_degree=sh_degree))


@dataclasses.dataclass
class View:
    """A posed image with the fields the trainer's batches carry."""
    T_to_world: np.ndarray
    intrinsics: list
    rgb_gt: torch.Tensor

    @property
    def resolution(self):
        h, w = self.rgb_gt.shape[:2]
        return (w, h)


class Capture:
    """The views a user's capture would load, with the dataset
    interface the trainer reads."""

    def __init__(self, views: List[View]):
        self.views = views

    def __len__(self):
        return len(self.views)

    def __getitem__(self, i) -> View:
        return self.views[i]

    def get_poses(self) -> np.ndarray:
        return np.stack([v.T_to_world for v in self.views])

    def get_scene_extent(self) -> float:
        from threedgrut_tpu_torch.data.protocols import compute_scene_extent

        return compute_scene_extent(self.get_poses()[:, :3, 3])


def camera(pose: scene.ViewPose, device):
    """The port's pinhole camera of a view."""
    from threedgrut_tpu_torch.ops.cameras import make_pinhole

    t, q = pose.world_to_camera()
    fx, fy, cx, cy = pose.intrinsics
    return make_pinhole((pose.width, pose.height), (fx, fy), (cx, cy), t=t,
                        q=q, device=device)


def warm_strategy(tconf, device):
    """Run MCMC's relocate and add once on a 256-row model of their own,
    so that their kernels are loaded before the window."""
    from threedgrut_tpu_torch.optimizers.adam import init_adam_state
    from threedgrut_tpu_torch.strategy import mcmc

    gen = torch.Generator(device=device).manual_seed(0)
    params = scene.standin_cloud(256, 0, device)
    params["density"][:64] = -8.0
    model = gaussian_model(params, 3)
    model.n_active = 192
    opt = init_adam_state(model.params())
    mcmc.relocate(model, opt, gen,
                  opacity_threshold=tconf.mcmc.opacity_threshold,
                  n_max=tconf.mcmc.binom_n_max)
    mcmc.add_gaussians(model, opt, gen, max_n=256,
                       n_max=tconf.mcmc.binom_n_max)
    mcmc.perturb(model, gen, 1e-4, tconf.mcmc.noise_lr)
