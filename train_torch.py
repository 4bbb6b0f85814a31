#!/usr/bin/env python3
"""Training CLI of the PyTorch/CUDA port:

    python train_torch.py --config-name apps/nerf_synthetic_3dgut \\
        path=/data/lego [key=value ...] [--device cpu] [--gui-port N]

The counterpart of train.py for the port's trainer, with the 3DGUT
renderer (``apps/nerf_synthetic_3dgut``, ``apps/colmap_3dgut``,
``apps/scannetpp_3dgut``), the 3DGRT one (``apps/nerf_synthetic_3dgrt``)
or the sorted 3DGUT of the paper (``paper/3dgut/sorted_nerf_synthetic``),
under the GS or the MCMC strategy (``apps/nerf_synthetic_3dgut_mcmc``),
with SH or NHT features (``apps/nerf_synthetic_3dgut_mcmc_nht``,
``apps/nerf_synthetic_3dgrt_mcmc_nht``), the cuSFM apps
(``apps/cusfm_3dgut``, ``apps/cusfm_3dgut_mcmc`` with PPISP
post-processing: the ISP trains with the scene, and its controller is
distilled before the last checkpoint), and the NCore apps
(``apps/ncore_3dgut``, ``ncore_3dgrt``, ``ncore_3dgut_mcmc``,
``ncore_3dgrt_mcmc``: rolling-shutter and fisheye sensors, lidar
initialisation). It trains on the card; without
one it stops, unless ``--device cpu`` asks for the CPU.
It composes the YAML configs with the port's ``config/loader.py`` and
reads NeRF-synthetic, COLMAP and ScanNet++ (OpenCV fisheye) captures
with its ``data/`` modules, decoding images with PIL (gsplat's
``dataset.gsplat_normalize`` and ``gsplat_image_downscale`` on COLMAP).
NCore sequences (``dataset.type: ncore``, ``data/ncore.py``) need the
NCore SDK's ``ncore.data.v4``, which is not in the repository: without
it they raise ImportError (``synthetic.py:ncore_stub_modules`` serves a
generated sequence in its place, for the tests and the card).
``make_model`` initialises as train.py does, in its order: a 3DGS PLY
(``import_ply``), the capture's sparse points (``colmap``), the NCore
lidar sweeps (``lidar``, ``point_cloud``), a fused
point cloud PLY (``fused_point_cloud``), a checkpoint's parameters
(``checkpoint``), else random; ``export_ply`` writes the final cloud.
``with_gui=true`` trains under the live web GUI
(``playground/live_gui.py``, on ``--gui-port``, 8091 as train.py's),
which keeps serving after the last step until it is stopped; then
``ckpt_last.npz`` is written and the CLI returns, without the PLY export
or the final metrics, as train.py does. The
port always renders with the reference's
exact kill: where the YAML sets ``exact_kill: false`` (the TPU package's
relaxed kill, configs/render/3dgrt.yaml and 3dgut.yaml), trainer_config
says so on stderr and composes the exact kill. Likewise bf16 records
(``records_bf16``, or ``particle_feature_half`` where the former is
unset, as the JAX loader reads them): the port keeps fp32 records and
says so, as it does for the TPU's segment layouts (``aligned_segments``,
``flat_grid``), which change no image; for NHT the half flags ask for
fp16 features, which the port keeps in fp32 with an fp16 decoder on the
card, and it says so. The port
sizes its pair buffer per view
(``max_pairs`` and ``auto_max_pairs`` are ignored). It overwrites
``ckpt_periodic.npz`` every ``checkpoint.frequency`` steps, as train.py
does; ``final_metrics.json`` records the card's name and power limit
beside the device, and the run ends with the kernels' launch counts.
"""

import argparse
import json
import os
import sys
import time

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
    nht = nht_features(conf).feature_type.value == "nht"
    if render.get("method", "3dgut") not in ("3dgut", "3dgrt"):
        raise NotImplementedError(f"render.method {render.get('method')}: "
                                  "the port has 3dgut and 3dgrt")
    if not render.get("exact_kill", True):
        print("render.exact_kill is false: the port composites with the "
              "exact kill only, so it trains with exact_kill true",
              file=sys.stderr)
    # config/loader.py:316-317 reads particle_feature_half as
    # records_bf16 where records_bf16 is unset (the render YAMLs set it
    # false): bf16 records, geometry included, a TPU knob. For NHT the two
    # half flags ask for fp16 particle and ray features (the reference's
    # tiny-cuda-nn build)
    if render.get("records_bf16", not nht and render.get(
            "particle_feature_half", False)):
        print("render.records_bf16 (or particle_feature_half) asks for bf16 "
              "records, a TPU knob: the port keeps fp32 records",
              file=sys.stderr)
    half = [k for k in ("particle_feature_half", "feature_output_half")
            if render.get(k, False)]
    if nht and half:
        print(f"render.{' and render.'.join(half)} ask for fp16 NHT "
              "features: the port keeps the particle and ray features in "
              "fp32; the decoder runs in fp16 on the card with a loss "
              "scale (fp32 on the CPU)", file=sys.stderr)
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
    if "normalize_world_space" in conf.get("dataset", {}):
        print("dataset.normalize_world_space: no code reads this key, in "
              "train.py or here (dataset.gsplat_normalize normalises)",
              file=sys.stderr)
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
        # config/loader.py:386-390
        post_processing=conf.get("post_processing", {}).get("method"),
        ppisp_use_controller=conf.get("post_processing", {}).get(
            "use_controller", True),
        ppisp_n_distillation_steps=conf.get("post_processing", {}).get(
            "n_distillation_steps", 5000))


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

        kw = dict(split="train" if split == "train" else "test",
                  downsample=down, test_split_interval=conf.dataset.get(
                      "test_split_interval", 8))
        if kind == "scannetpp":
            ds = ScannetppDataset(conf.path, **kw)
        else:   # train.py:29-34
            ds = ColmapDataset(
                conf.path, gsplat_normalize=conf.dataset.get(
                    "gsplat_normalize", False),
                gsplat_image_downscale=conf.dataset.get(
                    "gsplat_image_downscale", False), **kw)
        return ds if len(ds) else None
    if kind == "ncore":   # train.py:37-58; "test" holds the val frames
        from threedgrut_tpu_torch.data.ncore import NCoreDataset

        ds, tr = conf.dataset, conf.dataset.get("train", {})
        ncore = NCoreDataset(
            conf.path, split="train" if split == "train" else "test",
            camera_ids=ds.get("camera_ids"), lidar_ids=ds.get("lidar_ids"),
            downsample=float(ds.get("downsample", 1.0)),
            seek_offset_sec=tr.get("seek_offset_sec", 0.0),
            duration_sec=tr.get("duration_sec", -1),
            sample_full_image=tr.get("sample_full_image", True),
            window_size=tr.get("window_size", 256),
            n_samples_per_epoch=tr.get("n_samples_per_epoch", 1000),
            n_train_sample_camera_rays=tr.get(
                "n_train_sample_camera_rays", 4096),
            n_val_image_subsample=ds.get("n_val_image_subsample", 1),
            val_frame_interval=ds.get("val_frame_interval", 8),
            jpeg_backend_cpu=("native" if ds.get(
                "jpeg_backend_cpu", "native") != "PIL" else "PIL"),
            lidar_color_generic_data_name=ds.get(
                "lidar_color_generic_data_name", "rgb"))
        return ncore if len(ncore) else None
    raise NotImplementedError(f"dataset type {kind}: the port reads nerf, "
                              "colmap, scannetpp and ncore")


def make_model(conf, dataset, device):
    """The initial model, dispatched as train.py:make_model dispatches
    (train.py:95-129): a PLY import first; then the initialisation
    method where the dataset can serve it (``colmap`` needs
    ``load_points3d``, ``lidar`` and ``point_cloud`` need
    ``load_lidar_init``, which the NCore dataset has),
    ``fused_point_cloud`` or ``checkpoint``; else random. A PLY import
    pads to ``default_capacity_for(n)`` and a checkpoint keeps its own
    capacity, as in JAX: neither leaves the strategy's headroom."""
    from threedgrut_tpu_torch.export.ply import read_point_cloud_ply
    from threedgrut_tpu_torch.models.gaussians import (
        GaussianModel, GaussianModelConfig, default_capacity_for,
        initialize_from_points, random_initialization)

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
    method = init.get("method", "colmap")
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
    seed = conf.seed_initialization
    if conf.get("import_ply", {}).get("enabled"):
        return GaussianModel.from_ply(conf.import_ply.path, config=mc,
                                      device=device)
    if method == "colmap" and hasattr(dataset, "load_points3d"):
        # the capture's sparse points and their colours
        pts, rgb, _ = dataset.load_points3d()
        return initialize_from_points(
            mc, pts, rgb.astype(np.float32), capacity=capacity(len(pts)),
            seed=seed, device=device)
    if method in ("lidar", "point_cloud") and hasattr(dataset,
                                                      "load_lidar_init"):
        # observer-distance scales when use_observation_points
        pts, rgb, dists = dataset.load_lidar_init(
            num_points=init.get("num_points"))
        obs = (dists * init.get("observation_scale_factor", 0.01)
               if init.get("use_observation_points", True) else None)
        return initialize_from_points(
            mc, pts, rgb.astype(np.float32), observer_scale=obs,
            capacity=capacity(len(pts)), seed=seed, device=device)
    if method == "fused_point_cloud":
        pts, rgb = read_point_cloud_ply(init["fused_point_cloud_path"])
        return initialize_from_points(mc, pts, rgb,
                                      capacity=capacity(len(pts)),
                                      seed=seed, device=device)
    if method == "checkpoint":
        return GaussianModel.from_checkpoint(init["path"], mc, device)
    n = init.get("num_gaussians", 100000)
    return random_initialization(
        mc, n, extent=dataset.get_scene_extent(), capacity=capacity(n),
        seed=seed, device=device)


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
    ap.add_argument("--gui-port", type=int, default=8091,
                    help="port of the live GUI under with_gui=true (0: one "
                    "the system picks; the GUI prints its address)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_torch.py: no CUDA device; pass --device cpu "
                         "to train on the CPU")

    from threedgrut_tpu_torch.config.loader import load_config
    from threedgrut_tpu_torch.train.trainer import Trainer

    conf = load_config(args.config_name, overrides=args.overrides)
    if conf.path == "???":
        raise SystemExit("set the dataset path: train_torch.py ... "
                         "path=/data/...")
    dataset = make_dataset(conf, "train")
    val_dataset = make_dataset(conf, "val")
    tconf = trainer_config(conf)
    out_dir = os.path.join(conf.out_dir, conf.experiment_name or "run")
    model = make_model(conf, dataset, device)
    trainer = Trainer(tconf, dataset, model, val_dataset=val_dataset,
                      raw_conf=conf)
    if conf.resume:
        trainer.load_checkpoint(conf.resume)
    os.makedirs(out_dir, exist_ok=True)
    if conf.get("with_gui"):
        # train.py:162-174: the live GUI drives the training loop and
        # serves until stopped; then the last checkpoint, and no PLY
        # export or final metrics
        from threedgrut_tpu_torch.playground.live_gui import TrainingGUI

        n = model.n_active
        center = (model.positions.detach()[:n].mean(dim=0).cpu().numpy()
                  if n else np.zeros(3))
        gui = TrainingGUI(trainer, center=tuple(float(c) for c in center),
                          port=args.gui_port, out_dir=out_dir)
        gui.start()
        gui.run(max_steps=tconf.n_iterations)
        gui.stop()
        trainer.save_checkpoint(os.path.join(out_dir, "ckpt_last.npz"))
        return
    chunk = max(conf.log_frequency * 100, 1)
    ckpt_iters = set(conf.checkpoint.iterations)
    freq = conf.checkpoint.get("frequency", 0)
    try:
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
    except KeyboardInterrupt:
        print("interrupted; saving last checkpoint")
    if trainer.ppisp_params is not None and tconf.ppisp_use_controller:
        # train.py:200-203
        print("distilling PPISP controller...")
        t0 = time.perf_counter()
        loss = trainer.distill_ppisp_controller()
        print(f"controller distillation loss: {loss} (first step "
              f"{trainer.ppisp_distill_first_loss}; "
              f"{time.perf_counter() - t0:.2f} s)")
    trainer.save_checkpoint(os.path.join(out_dir, "ckpt_last.npz"))
    if conf.get("export_ply", {}).get("enabled"):
        from threedgrut_tpu_torch.export.ply import export_model

        export_model(trainer.model, conf.export_ply.path
                     or os.path.join(out_dir, "export_last.ply"))
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
