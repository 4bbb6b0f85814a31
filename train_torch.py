#!/usr/bin/env python3
"""Training CLI of the PyTorch/CUDA port:

    python train_torch.py --config-name apps/nerf_synthetic_3dgut \\
        path=/data/lego [key=value ...] [--device cpu]

The counterpart of train.py for the port's trainer, with the 3DGUT
renderer (``apps/nerf_synthetic_3dgut``, ``apps/colmap_3dgut``,
``apps/scannetpp_3dgut``), the 3DGRT one (``apps/nerf_synthetic_3dgrt``)
or the sorted 3DGUT of the paper (``paper/3dgut/sorted_nerf_synthetic``),
under the GS or the MCMC strategy (``apps/nerf_synthetic_3dgut_mcmc``),
with SH or NHT features (``apps/nerf_synthetic_3dgut_mcmc_nht``,
``apps/nerf_synthetic_3dgrt_mcmc_nht``). It trains on the card; without
one it stops, unless ``--device cpu`` asks for the CPU.
It composes the YAML configs with the port's ``config/loader.py`` and
reads NeRF-synthetic, COLMAP and ScanNet++ (OpenCV fisheye) captures
with its ``data/`` modules, decoding images with PIL; a COLMAP capture
can initialise the cloud from its sparse points
(``initialization.method: colmap``). NCore sequences need the NCore SDK,
which is not in the repository: ``dataset.type: ncore`` raises. The
port always renders with the reference's
exact kill: where the YAML sets ``exact_kill: false`` (the TPU package's
relaxed kill, configs/render/3dgrt.yaml and 3dgut.yaml), trainer_config
says so on stderr and composes the exact kill. Likewise bf16 records
(``records_bf16``, or ``particle_feature_half`` where the former is
unset, as the JAX loader reads them): the port keeps fp32 records and
says so, as it does for the TPU's segment layouts
(``aligned_segments``, ``flat_grid``), which change no image. The port
sizes its pair buffer per view
(``max_pairs`` and ``auto_max_pairs`` are ignored). It overwrites
``ckpt_periodic.npz`` every ``checkpoint.frequency`` steps, as train.py
does; ``final_metrics.json`` records the card's name and power limit
beside the device, and the run ends with the kernels' launch counts.
Keys that train.py acts on and the port does not port yet stop it
with their train.py line (``refuse_unported``): PLY import and export,
the gsplat COLMAP options, PPISP post-processing and the live GUI
(``linear-to-srgb`` post-processing trains).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch


def nht_features(conf):
    """The config's ``Features``; raises for NHT features other than one
    sincos frequency, which JAX's renderer hard-codes
    (render/gut.py:174)."""
    from threedgrut_tpu_torch.models.features import (ActivationType,
                                                      FeatureType, Features)

    feats = Features.from_config(conf)
    if feats.feature_type == FeatureType.NHT and (
            feats.activation != ActivationType.SINCOS
            or feats.num_frequencies != 1):
        raise NotImplementedError(
            f"NHT activation {feats.activation.name} with "
            f"{feats.num_frequencies} frequencies: the renderer composites "
            "sin and cos of one frequency only")
    return feats


# keys train.py acts on that the port does not yet: (key, whether the
# value asks for an action, what in train.py acts on it)
UNPORTED = (
    ("import_ply.enabled",
     lambda c: bool(c.get("import_ply", {}).get("enabled")),
     "train.py:95-97 (export/ply.import_model)"),
    ("export_ply.enabled",
     lambda c: bool(c.get("export_ply", {}).get("enabled")),
     "train.py:205-208 (export/ply.export_model)"),
    ("dataset.gsplat_normalize",
     lambda c: bool(c.get("dataset", {}).get("gsplat_normalize")),
     "train.py:32 (data/colmap.py:166-178)"),
    ("dataset.gsplat_image_downscale",
     lambda c: bool(c.get("dataset", {}).get("gsplat_image_downscale"))
     and c.get("dataset", {}).get("downsample_factor", 1) > 1,
     "train.py:33-34 (data/colmap.py:181-190 reads other images)"),
    ("post_processing.method",
     lambda c: c.get("post_processing", {}).get("method") == "ppisp",
     "train.py:196-199 and train/trainer.py:478-482 (PPISP)"),
    ("with_gui", lambda c: bool(c.get("with_gui")),
     "train.py:162-174 (playground/live_gui.py)"),
)


def refuse_unported(conf):
    """Stop (exit non-zero) where the config asks train.py for an action
    the port does not take yet, naming each key and its train.py line."""
    asked = [f"{key} ({where})" for key, asks, where in UNPORTED
             if asks(conf)]
    if asked:
        raise SystemExit("train_torch.py: not ported yet, so not silently "
                         "ignored: " + "; ".join(asked))


def trainer_config(conf):
    """The port's TrainerConfig from a composed YAML config (the subset
    of threedgrut_tpu.config.loader.to_trainer_config that the port
    trains)."""
    from threedgrut_tpu_torch.models.background import BackgroundConfig
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.strategy.gs import GSStrategyConfig
    from threedgrut_tpu_torch.strategy.mcmc import MCMCStrategyConfig
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
    mcmc = "MCMC" in str(strat.get("method", "GSStrategy"))
    nht_features(conf)
    if render.get("method", "3dgut") not in ("3dgut", "3dgrt"):
        raise NotImplementedError(f"render.method {render.get('method')}: "
                                  "the port has 3dgut and 3dgrt")
    if not render.get("exact_kill", True):
        print("render.exact_kill is false: the port composites with the "
              "exact kill only, so it trains with exact_kill true",
              file=sys.stderr)
    # config/loader.py:316-317 reads particle_feature_half as
    # records_bf16 where records_bf16 is unset (the render YAMLs set it
    # false): bf16 records, geometry included, a TPU knob
    if render.get("records_bf16", render.get("particle_feature_half",
                                             False)):
        print("render.records_bf16 (or particle_feature_half) asks for bf16 "
              "records, a TPU knob: the port keeps fp32 records",
              file=sys.stderr)
    # config/loader.py:318 maps aligned_segments; flat_grid is a
    # RasterConfig knob no YAML sets. Both lay out the same image for the
    # TPU: segments padded to chunk boundaries in the pair budget, a grid
    # step per (tile, chunk) visit
    layouts = [k for k in ("aligned_segments", "flat_grid")
               if render.get(k, False)]
    if layouts:
        print(f"render.{' and render.'.join(layouts)}: TPU layouts of the "
              "same image; the port composites each tile's pairs in one "
              "block and trains as before", file=sys.stderr)
    d, p, r = (strat.get(k, {}) for k in ("densify", "prune",
                                           "reset_density"))
    decay, pscale, pweight = (strat.get(k, {}) for k in (
        "density_decay", "prune_scale", "prune_weight"))
    # config/loader.py:222-287: the other strategy keeps its defaults
    gs = GSStrategyConfig() if mcmc else GSStrategyConfig(
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
    rl, ad, pb = (strat.get(k, {}) for k in ("relocate", "add", "perturb"))
    mc = MCMCStrategyConfig() if not mcmc else MCMCStrategyConfig(
        binom_n_max=strat.get("binom_n_max", 51),
        opacity_threshold=strat.get("opacity_threshold", 0.005),
        relocate_frequency=rl.get("frequency", 100),
        relocate_start=rl.get("start_iteration", 500),
        relocate_end=rl.get("end_iteration", 25000),
        add_frequency=ad.get("frequency", 100),
        add_start=ad.get("start_iteration", 500),
        add_end=ad.get("end_iteration", 25000),
        max_n_gaussians=ad.get("max_n_gaussians", 1000000),
        perturb_frequency=pb.get("frequency", 1),
        perturb_start=pb.get("start_iteration", 0),
        perturb_end=pb.get("end_iteration", 27500),
        noise_lr=pb.get("noise_lr", 5e5))
    ut = UTConfig(
        alpha=splat.get("ut_alpha", 1.0), beta=splat.get("ut_beta", 2.0),
        kappa=splat.get("ut_kappa", 0.0),
        n_rolling_shutter_iterations=splat.get(
            "n_rolling_shutter_iterations", 5),
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
    dec = model.get("nht_decoder", {})
    return TrainerConfig(
        n_iterations=conf.get("n_iterations", 30000),
        strategy="mcmc" if mcmc else "gs",
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
            lr_features=lr.get("features", {}).get("lr", 0.015),
            lr_rotation=lr.get("rotation", {}).get("lr", 0.001),
            lr_scale=lr.get("scale", {}).get("lr", 0.005),
            positions_lr_final=sched.get("positions", {}).get(
                "lr_final", 0.0000016),
            positions_max_steps=sched.get("positions", {}).get(
                "max_steps", 30000),
            features_decay_final=sched.get("features", {}).get(
                "decay_final", 0.1),
            features_max_steps=sched.get("features", {}).get(
                "max_steps", 30000),
            tail_start_frac=sched.get("tail", {}).get("start_frac", 0.66),
            tail_final_scale=sched.get("tail", {}).get("final_scale", 0.1)),
        gs=gs, mcmc=mc, ut=ut, raster=raster,
        init_n_features=prog.get("init_n_features", 0),
        max_n_features=prog.get("max_n_features", 3),
        increase_frequency=prog.get("increase_frequency", 1000),
        increase_step=prog.get("increase_step", 1),
        val_frequency=conf.get("val_frequency", 5000),
        seed=conf.get("seed_initialization", 42),
        print_stats=model.get("print_stats", False),
        nht_color_refine_steps=dec.get("color_refine_steps", 3000),
        nht_warmup_steps=dec.get("warmup_steps", 0),
        post_processing=conf.get("post_processing", {}).get("method"))


def make_dataset(conf, split):
    """The dataset of ``conf.dataset.type`` for ``split`` ("train", or
    "val" for the held-out views), or None where the capture has none."""
    kind = conf.dataset.type
    down = conf.dataset.get("downsample_factor", 1)
    if kind == "nerf":
        from threedgrut_tpu_torch.data.nerf import NeRFDataset

        if not os.path.exists(os.path.join(conf.path,
                                           f"transforms_{split}.json")):
            return None
        return NeRFDataset(conf.path, split=split, downsample=down,
                           bg_color=conf.model.background.color)
    if kind in ("colmap", "scannetpp"):
        from threedgrut_tpu_torch.data.colmap import (ColmapDataset,
                                                      ScannetppDataset)

        cls = ScannetppDataset if kind == "scannetpp" else ColmapDataset
        ds = cls(conf.path, split="train" if split == "train" else "test",
                 downsample=down,
                 test_split_interval=conf.dataset.get("test_split_interval",
                                                      8))
        return ds if len(ds) else None
    if kind == "ncore":
        raise NotImplementedError(
            "dataset.type ncore: the NCore loader needs the NCore SDK, which "
            "is not in the repository (threedgrut_tpu/data/ncore.py)")
    raise NotImplementedError(f"dataset type {kind}: the port reads nerf, "
                              "colmap and scannetpp")


def make_model(conf, dataset, device):
    from threedgrut_tpu_torch.models.gaussians import (
        GaussianModelConfig, default_capacity_for, initialize_from_points,
        random_initialization)

    mc = GaussianModelConfig(
        density_activation=conf.model.density_activation,
        scale_activation=conf.model.scale_activation,
        feature_type=conf.model.feature_type,
        max_sh_degree=min(conf.model.progressive_training.max_n_features,
                          conf.render.particle_radiance_sph_degree),
        nht_feature_dim=nht_features(conf).particle_feature_dim,
        default_density=conf.model.default_density,
        default_scale_factor=conf.model.default_scale_factor)
    init = conf.get("initialization", {})
    method = init.get("method", "random")
    strat = conf.get("strategy", {})
    if "MCMC" in str(strat.get("method", "")):
        # train.py:87-89: MCMC grows to a hard cap
        def capacity(n0):
            return default_capacity_for(
                max(n0, strat.get("add", {}).get("max_n_gaussians", n0)))
    else:
        def capacity(n0):   # GS grows the cloud by densifying
            return default_capacity_for(
                n0, init.get("capacity_headroom", 4.0))
    if method == "colmap":
        # train.py:98-102: the capture's sparse points and their colours
        pts, rgb, _ = dataset.load_points3d()
        return initialize_from_points(
            mc, pts, rgb.astype(np.float32), capacity=capacity(len(pts)),
            seed=conf.seed_initialization, device=device)
    if method != "random":
        raise NotImplementedError(f"initialization {method} is not wired "
                                  "to the port's CLI")
    n = init.get("num_gaussians", 100000)
    return random_initialization(
        mc, n, extent=dataset.get_scene_extent(), capacity=capacity(n),
        seed=conf.seed_initialization, device=device)


def device_record(device) -> dict:
    """``device``, and on the card its name and the power limit that
    ``nvidia-smi`` reads (None where it cannot be read), for
    final_metrics.json."""
    rec = {"device": str(device), "device_name": None, "power_limit": None}
    if device.type != "cuda":
        return rec
    import subprocess

    rec["device_name"] = torch.cuda.get_device_name(device)
    try:
        res = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        if res.returncode == 0:
            rec["power_limit"] = res.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-name", default="apps/nerf_synthetic_3dgut")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu trains on the "
                    "CPU, slowly)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_torch.py: no CUDA device; pass --device cpu "
                         "to train on the CPU")

    from threedgrut_tpu_torch.config.loader import load_config
    from threedgrut_tpu_torch.train.trainer import Trainer

    conf = load_config(args.config_name, overrides=args.overrides)
    refuse_unported(conf)
    if conf.path == "???":
        raise SystemExit("set the dataset path: train_torch.py ... "
                         "path=/data/...")
    dataset = make_dataset(conf, "train")
    val_dataset = make_dataset(conf, "val")
    tconf = trainer_config(conf)
    out_dir = os.path.join(conf.out_dir, conf.experiment_name or "run")
    trainer = Trainer(tconf, dataset, make_model(conf, dataset, device),
                      val_dataset=val_dataset, raw_conf=conf)
    if conf.resume:
        trainer.load_checkpoint(conf.resume)
    os.makedirs(out_dir, exist_ok=True)
    chunk = max(conf.log_frequency * 100, 1)
    ckpt_iters = set(conf.checkpoint.iterations)
    freq = conf.checkpoint.get("frequency", 0)
    while trainer.global_step < tconf.n_iterations:
        before = trainer.global_step
        trainer.run_training(min(before + chunk, tconf.n_iterations),
                             log_every=chunk)
        if any(before < c <= trainer.global_step for c in ckpt_iters):
            trainer.save_checkpoint(os.path.join(
                out_dir, f"ckpt_{trainer.global_step}.npz"))
        if freq and before // freq != trainer.global_step // freq:
            # train.py:187-193: overwrite one rolling checkpoint, so a
            # kill loses at most about ``freq`` steps
            trainer.save_checkpoint(os.path.join(out_dir,
                                                 "ckpt_periodic.npz"))
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
                       **device_record(device)}, f)
    from threedgrut_tpu_torch.ops.cuda import launch_counts

    print("launches:", json.dumps(launch_counts()))


if __name__ == "__main__":
    main()
