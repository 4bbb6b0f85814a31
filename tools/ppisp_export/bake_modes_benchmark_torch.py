#!/usr/bin/env python3
"""Sweep PPISP SH-bake modes on a trained checkpoint and report metrics,
with the PyTorch/CUDA port (the counterpart of
tools/ppisp_export/bake_modes_benchmark.py, plus ``--device``).

For each mode, bake the trained model's PPISP into its SH coefficients,
then validate per held-out frame against the reference output (full
PPISP applied to the un-baked render) and aggregate PSNR
mean/median/min/max into ``<out-dir>/metrics.json``.

Modes (two axes, as in the reference):
  * ``simple``          — no optimization: fold the linear responsivity/
                          exposure scale into the coefficients
                          (usd.bake_ppisp_into_sh / scale_sh_output).
  * ``fit-training``    — photometric Adam bake on training views
                          (export/sh_bake.py).
  * ``fit-trajectory``  — photometric bake on slerped in-between poses
                          (export/view_interpolation.py).

As in the JAX tool, a held-out view's reference goes through the ISP
with frame 0's per-frame terms (its own are unknown). Each fit mode's row
adds the mean loss of its first and of its last round over the fitted
views (``loss_first``, ``loss_last``). Renders on the card:
each bake step launches kernels A-D and D's inversion, each target
render and each validation render A and B. Without a card it stops,
unless ``--device cpu`` asks for the CPU. Ends with the kernels' launch
counts.

Usage:
    python tools/ppisp_export/bake_modes_benchmark_torch.py \\
        --checkpoint runs/<scene>/ckpt_last.npz --path /data/scene \\
        [--modes simple fit-training fit-trajectory] [--iters 600]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, _ROOT)

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--path", required=True)
    ap.add_argument("--out-dir", default="runs/bake_modes")
    ap.add_argument("--modes", nargs="+",
                    default=["simple", "fit-training", "fit-trajectory"])
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--n-views", type=int, default=8)
    ap.add_argument("--camera-id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu renders on the "
                    "CPU, slowly)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bake_modes_benchmark_torch.py: no CUDA device; "
                         "pass --device cpu to render on the CPU")

    from threedgrut_tpu_torch.config.loader import (config_from_dict,
                                                    load_config)
    from threedgrut_tpu_torch.export import usd as usd_mod
    from threedgrut_tpu_torch.export.sh_bake import bake_ppisp
    from threedgrut_tpu_torch.models.gaussians import GaussianModel
    from threedgrut_tpu_torch.models.post_processing import apply_ppisp
    from threedgrut_tpu_torch.ops.cuda import launch_counts
    from threedgrut_tpu_torch.ops.ssim import psnr
    from threedgrut_tpu_torch.render.gut import render_gut
    from threedgrut_tpu_torch.train.trainer import Trainer, camera_from_batch
    from train_torch import make_dataset, make_model, trainer_config

    overrides = [f"path={args.path}"] + args.overrides
    with np.load(args.checkpoint) as data:
        embedded = (json.loads(str(data["config_json"]))
                    if "config_json" in data.files else None)
    if embedded is not None:
        conf = config_from_dict(embedded, overrides=overrides)
    else:
        conf = load_config("apps/nerf_synthetic_3dgut", overrides=overrides)
    if conf.model.feature_type != "sh":
        sys.exit("NHT checkpoints have no SH coefficients to bake into")
    tconf = trainer_config(conf)
    train_ds = make_dataset(conf, "train")
    val_ds = make_dataset(conf, "val") or train_ds
    model = make_model(conf, train_ds, device)
    trainer = Trainer(tconf, train_ds, model, val_dataset=val_ds)
    trainer.load_checkpoint(args.checkpoint)
    model = trainer.model
    ppisp = trainer.ppisp_params
    if ppisp is None:
        sys.exit("checkpoint has no PPISP parameters")
    sh_degree = trainer.sh_degree()
    rc = tconf.raster

    def with_sh(alb, spec):
        arrays = {k: v.detach() for k, v in model.params().items()}
        arrays.update(features_albedo=alb, features_specular=spec)
        return GaussianModel(arrays, model.n_active, model.n_active_features,
                             model.config)

    @torch.no_grad()
    def validate(baked_model, tag):
        """Per-frame PSNR of baked render vs PPISP'd reference render."""
        rows = []
        for i in range(len(val_ds)):
            cam = camera_from_batch(val_ds[i], device)
            ref = render_gut(cam, tconf.ut, rc, model,
                             sh_degree)["pred_features"]
            # novel view: per-frame params unknown -> frame 0's, as the
            # JAX tool does
            ref = torch.clamp(apply_ppisp(ppisp, ref, args.camera_id, 0),
                              0.0, 1.0)
            baked = torch.clamp(render_gut(cam, tconf.ut, rc, baked_model,
                                           sh_degree)["pred_features"],
                                0.0, 1.0)
            rows.append(float(psnr(baked, ref)))
        arr = np.asarray(rows)
        return {"mode": tag, "psnr_mean": float(arr.mean()),
                "psnr_median": float(np.median(arr)),
                "psnr_min": float(arr.min()), "psnr_max": float(arr.max()),
                "per_frame": rows}

    results = []
    for mode in args.modes:
        t0 = time.time()
        history = None
        if mode == "simple":
            alb = model.features_albedo.detach().cpu().numpy()
            n = alb.shape[0]
            spec = model.features_specular.detach().cpu().numpy()
            ks = spec.shape[1] // 3 + 1
            sh = np.concatenate([alb.reshape(n, 1, 3),
                                 spec.reshape(n, ks - 1, 3)], axis=1)
            host_ppisp = {k: v.detach().cpu().numpy()
                          for k, v in ppisp.items()}
            baked_sh = usd_mod.bake_ppisp_into_sh(sh, host_ppisp,
                                                  camera_idx=args.camera_id)
            new_alb = torch.from_numpy(baked_sh[:, 0, :]).to(device)
            new_spec = torch.from_numpy(
                np.ascontiguousarray(baked_sh[:, 1:, :]).reshape(n, -1)
            ).to(device)
        else:
            sampling = ("trajectory" if mode == "fit-trajectory"
                        else "training")
            out = bake_ppisp(model, ppisp, train_ds, tconf.ut, rc,
                             sh_degree, iters=args.iters,
                             view_sampling=sampling,
                             n_views=args.n_views)
            new_alb = out["features_albedo"]
            new_spec = out["features_specular"]
            history = out["loss_history"]
            n_fit = len(out["targets"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        bake_s = time.time() - t0
        row = validate(with_sh(new_alb, new_spec), mode)
        row["bake_time_s"] = round(time.time() - t0, 2)
        row["bake_only_s"] = bake_s
        if history:
            # the mean loss of the first and of the last round over the
            # fitted views (one view's loss may rise while the mean falls)
            row.update(loss_first=float(np.mean(history[:n_fit])),
                       loss_last=float(np.mean(history[-n_fit:])),
                       iters=len(history), fit_views=n_fit)
        print(json.dumps({k: v for k, v in row.items()
                          if k != "per_frame"}))
        results.append(row)

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "metrics.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out_dir}/metrics.json")
    print("launches:", json.dumps(launch_counts()))


if __name__ == "__main__":
    main()
