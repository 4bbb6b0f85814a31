#!/usr/bin/env python3
"""Training CLI of the PyTorch/CUDA port:

    python train_torch.py --config-name apps/nerf_synthetic_3dgut \\
        path=/data/lego [key=value ...] [--device cuda]

The counterpart of train.py for the port's GS trainer, with the 3DGUT
renderer (``apps/nerf_synthetic_3dgut``), the 3DGRT one
(``apps/nerf_synthetic_3dgrt``) or the sorted 3DGUT of the paper
(``paper/3dgut/sorted_nerf_synthetic``). It composes the
YAML configs with threedgrut_tpu.config.loader (yaml and numpy only) and
reads NeRF-synthetic datasets with threedgrut_tpu.data.nerf (numpy, and
PIL for PNG files), both imported here, so that the port's package stays
free of yaml and PIL. The port always renders with the reference's
exact kill: where the YAML sets ``exact_kill: false`` (the TPU package's
relaxed kill, configs/render/3dgrt.yaml and 3dgut.yaml), trainer_config
says so on stderr and composes the exact kill. The port sizes its pair
buffer per view (``max_pairs`` and ``auto_max_pairs`` are ignored).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch


def trainer_config(conf):
    """The port's TrainerConfig from a composed YAML config (the GS
    subset of threedgrut_tpu.config.loader.to_trainer_config)."""
    from threedgrut_tpu_torch.models.background import BackgroundConfig
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.strategy.gs import GSStrategyConfig
    from threedgrut_tpu_torch.train.trainer import (LossConfig,
                                                    OptimizerConfig,
                                                    TrainerConfig)

    loss = conf.get("loss", {})
    opt = conf.get("optimizer", {})
    lr = opt.get("params", {})
    sched = conf.get("scheduler", {})
    model = conf.get("model", {})
    prog = model.get("progressive_training", {})
    render = conf.get("render", {})
    splat = render.get("splat", {})
    strat = conf.get("strategy", {})
    if "MCMC" in str(strat.get("method", "GSStrategy")):
        raise NotImplementedError("the MCMC strategy is not ported")
    if render.get("method", "3dgut") not in ("3dgut", "3dgrt"):
        raise NotImplementedError(f"render.method {render.get('method')}: "
                                  "the port has 3dgut and 3dgrt")
    if not render.get("exact_kill", True):
        print("render.exact_kill is false: the port composites with the "
              "exact kill only, so it trains with exact_kill true",
              file=sys.stderr)
    d, p, r = (strat.get(k, {}) for k in ("densify", "prune",
                                           "reset_density"))
    decay, pscale, pweight = (strat.get(k, {}) for k in (
        "density_decay", "prune_scale", "prune_weight"))
    gs = GSStrategyConfig(
        densify_frequency=d.get("frequency", 300),
        densify_start=d.get("start_iteration", 500),
        densify_end=d.get("end_iteration", 15000),
        clone_grad_threshold=d.get("clone_grad_threshold", 0.0002),
        split_grad_threshold=d.get("split_grad_threshold", 0.0002),
        relative_size_threshold=d.get("relative_size_threshold", 0.01),
        split_n_gaussians=d.get("split", {}).get("n_gaussians", 2),
        prune_frequency=p.get("frequency", 100),
        prune_start=p.get("start_iteration", 500),
        prune_end=p.get("end_iteration", 15000),
        prune_density_threshold=p.get("density_threshold", 0.005),
        reset_density_frequency=r.get("frequency", 3000),
        reset_density_start=r.get("start_iteration", 0),
        reset_density_end=r.get("end_iteration", 15000),
        new_max_density=r.get("new_max_density", 0.01),
        density_decay_frequency=decay.get("frequency", 0),
        density_decay_start=decay.get("start_iteration", -1),
        density_decay_end=decay.get("end_iteration", -1),
        density_decay_gamma=decay.get("gamma", 0.99),
        prune_scale_frequency=pscale.get("frequency", 0),
        prune_scale_start=pscale.get("start_iteration", -1),
        prune_scale_end=pscale.get("end_iteration", -1),
        prune_scale_threshold=pscale.get("threshold", 1.0),
        prune_weight_frequency=pweight.get("frequency", 0),
        prune_weight_start=pweight.get("start_iteration", -1),
        prune_weight_end=pweight.get("end_iteration", -1),
        # configs/strategy/gs.yaml names it weight_threshold (the JAX
        # loader reads "threshold" and so falls back to 0.01)
        prune_weight_threshold=pweight.get("weight_threshold", 0.01),
        weight_telemetry_frequency=pweight.get("telemetry_frequency", 10))
    ut = UTConfig(
        alpha=splat.get("ut_alpha", 1.0), beta=splat.get("ut_beta", 2.0),
        kappa=splat.get("ut_kappa", 0.0),
        image_margin_factor=splat.get("ut_in_image_margin_factor", 0.1),
        require_all_sigma_points=splat.get(
            "ut_require_all_sigma_points_valid", False),
        rect_bounding=splat.get("rect_bounding", True),
        tight_opacity_bounding=splat.get("tight_opacity_bounding", True),
        alpha_threshold=render.get("particle_kernel_min_alpha", 1.0 / 255.0),
        global_z_order=splat.get("global_z_order", True))
    raster = RasterConfig(
        kernel_degree=render.get("particle_kernel_degree", 2),
        min_response=render.get("particle_kernel_min_response", 0.0113),
        min_alpha=render.get("particle_kernel_min_alpha", 1.0 / 255.0),
        max_alpha=render.get("particle_kernel_max_alpha", 0.99),
        min_transmittance=render.get("min_transmittance", 1e-4),
        tile_culling=splat.get("tile_based_culling", True),
        # config/loader.py:312-314: 3DGRT and the k-buffer 3DGUT configs
        # composite in per-ray sorted windows
        sorted_compositing=(splat.get("k_buffer_size", 0) > 0
                            or render.get("method") == "3dgrt"),
        sort_window=render.get("sort_window", 64))
    bgc = model.get("background", {})
    return TrainerConfig(
        n_iterations=conf.get("n_iterations", 30000),
        background=BackgroundConfig(name=bgc.get("name", "background-color"),
                                    color=bgc.get("color", "black")),
        loss=LossConfig(**{k: loss.get(k, v) for k, v in
                           vars(LossConfig()).items()}),
        optimizer=OptimizerConfig(
            type=opt.get("type", "adam"), eps=opt.get("eps", 1e-15),
            lr_positions=lr.get("positions", {}).get("lr", 0.00016),
            lr_density=lr.get("density", {}).get("lr", 0.05),
            lr_features_albedo=lr.get("features_albedo", {}).get(
                "lr", 0.0025),
            lr_features_specular=lr.get("features_specular", {}).get(
                "lr", 0.000125),
            lr_rotation=lr.get("rotation", {}).get("lr", 0.001),
            lr_scale=lr.get("scale", {}).get("lr", 0.005),
            positions_lr_final=sched.get("positions", {}).get(
                "lr_final", 0.0000016),
            positions_max_steps=sched.get("positions", {}).get(
                "max_steps", 30000),
            tail_start_frac=sched.get("tail", {}).get("start_frac", 0.66),
            tail_final_scale=sched.get("tail", {}).get("final_scale", 0.1)),
        gs=gs, ut=ut, raster=raster,
        init_n_features=prog.get("init_n_features", 0),
        max_n_features=prog.get("max_n_features", 3),
        increase_frequency=prog.get("increase_frequency", 1000),
        increase_step=prog.get("increase_step", 1),
        val_frequency=conf.get("val_frequency", 5000),
        seed=conf.get("seed_initialization", 42),
        print_stats=model.get("print_stats", False))


def use_pil_if_native_broken():
    """The reused NeRF loader decodes images with the repository's
    prebuilt ``native/libdataio.so`` when it loads, and with PIL when it
    is absent. On a host without the libjpeg that library links against,
    loading it raises OSError instead: treat it as absent there."""
    from threedgrut_tpu.data import native_loader

    try:
        native_loader.native_available()
    except OSError as e:
        print(f"native image decoder unavailable ({e}); using PIL")
        native_loader._load_lib = lambda: None


def make_dataset(conf, split):
    if conf.dataset.type != "nerf":
        raise NotImplementedError(f"dataset type {conf.dataset.type}: only "
                                  "NeRF-synthetic is wired to the port")
    from threedgrut_tpu.data.nerf import NeRFDataset

    use_pil_if_native_broken()

    return NeRFDataset(conf.path, split=split,
                       downsample=conf.dataset.get("downsample_factor", 1),
                       bg_color=conf.model.background.color)


def make_model(conf, dataset, device):
    from threedgrut_tpu_torch.models.gaussians import (
        GaussianModelConfig, default_capacity_for, random_initialization)

    mc = GaussianModelConfig(
        density_activation=conf.model.density_activation,
        scale_activation=conf.model.scale_activation,
        feature_type=conf.model.feature_type,
        max_sh_degree=min(conf.model.progressive_training.max_n_features,
                          conf.render.particle_radiance_sph_degree),
        default_density=conf.model.default_density,
        default_scale_factor=conf.model.default_scale_factor)
    init = conf.get("initialization", {})
    method = init.get("method", "random")
    if method != "random":
        raise NotImplementedError(f"initialization {method} is not wired "
                                  "to the port's CLI")
    n = init.get("num_gaussians", 100000)
    headroom = init.get("capacity_headroom", 4.0)   # GS grows the cloud
    return random_initialization(
        mc, n, extent=dataset.get_scene_extent(),
        capacity=default_capacity_for(n, headroom),
        seed=conf.seed_initialization, device=device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-name", default="apps/nerf_synthetic_3dgut")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda when present)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()

    from threedgrut_tpu.config.loader import load_config
    from threedgrut_tpu_torch.train.trainer import Trainer

    conf = load_config(args.config_name, overrides=args.overrides)
    if conf.path == "???":
        raise SystemExit("set the dataset path: train_torch.py ... "
                         "path=/data/...")
    device = torch.device(args.device or (
        "cuda" if torch.cuda.is_available() else "cpu"))
    dataset = make_dataset(conf, "train")
    val_dataset = make_dataset(conf, "val") if os.path.exists(
        os.path.join(conf.path, "transforms_val.json")) else None
    tconf = trainer_config(conf)
    out_dir = os.path.join(conf.out_dir, conf.experiment_name or "run")
    trainer = Trainer(tconf, dataset, make_model(conf, dataset, device),
                      val_dataset=val_dataset, raw_conf=conf)
    if conf.resume:
        trainer.load_checkpoint(conf.resume)
    os.makedirs(out_dir, exist_ok=True)
    chunk = max(conf.log_frequency * 100, 1)
    ckpt_iters = set(conf.checkpoint.iterations)
    while trainer.global_step < tconf.n_iterations:
        before = trainer.global_step
        trainer.run_training(min(before + chunk, tconf.n_iterations),
                             log_every=chunk)
        if any(before < c <= trainer.global_step for c in ckpt_iters):
            trainer.save_checkpoint(os.path.join(
                out_dir, f"ckpt_{trainer.global_step}.npz"))
        if (tconf.val_frequency and val_dataset is not None
                and before // tconf.val_frequency
                != trainer.global_step // tconf.val_frequency):
            print("val:", trainer.validate())
    trainer.save_checkpoint(os.path.join(out_dir, "ckpt_last.npz"))
    if conf.test_last and val_dataset is not None:
        final = trainer.validate()
        print("final:", final)
        with open(os.path.join(out_dir, "final_metrics.json"), "w") as f:
            json.dump({**{k: float(v) for k, v in final.items()},
                       "train_time_s": trainer.train_wall_time,
                       "n_iterations": trainer.global_step,
                       "n_gaussians": trainer.model.n_active,
                       "device": str(device)}, f)


if __name__ == "__main__":
    main()
