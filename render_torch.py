#!/usr/bin/env python3
"""Checkpoint evaluation CLI of the PyTorch/CUDA port (the counterpart
of render.py):

    python render_torch.py --checkpoint runs/<name>/ckpt_last.npz \\
        --path /data/lego [--config-name apps/...] [--out-dir ./eval] \\
        [--save-images] [key=value ...] [--device cpu]

Loads a checkpoint (an .npz of train_torch.py or train.py, which share
their keys, or a 3DGS .ply), renders the dataset's test split and writes
``metrics.json`` with render.py's keys and layout: the mean psnr, ssim,
psnr_cc and ssim_cc (after a per-image affine colour correction,
``utils/color_correct.py``), lpips, the best and worst frame by PSNR and
every frame's metrics. LPIPS needs VGG16 and linear-head weights
(``utils/lpips.py:load_weights``: ``$LPIPS_WEIGHTS`` or
``~/.cache/threedgrut_tpu/``); none ship and nothing is downloaded, so
without them lpips is null per frame and the mean is render.py's
"unavailable ..." string. ``--save-images`` writes ``pred_{i:04d}.png``.

Without ``--config-name`` the config embedded in the checkpoint
(``config_json``) drives the run, else ``apps/nerf_synthetic_3dgut``.
The background, the post-processing and the clamp to [0, 1] are applied
as render.py applies them: a PPISP checkpoint's ISP through the loaded
trainer's ``_apply_ppisp_eval`` (the checkpoint holds no controller, so
its per-frame terms are neutral), else ``linear-to-srgb`` where
configured (not on a .ply, as in render.py). The port's
raster is render.py's default eval renderer: the exact kill and fp32
records, with an uncapped pair buffer. It renders on the card; without
one it stops, unless ``--device cpu`` asks for the CPU.

Refused, with the reason: NHT checkpoints (render.py composites their
ray features, 24 channels at the shipped width, as if they were RGB,
without the decoder, and fails on them; the port does not add what the
JAX CLI lacks).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

LPIPS_UNAVAILABLE = ("unavailable (no VGG16/LPIPS weights in this "
                     "environment; set $LPIPS_WEIGHTS)")


def load_conf(args):
    """render.py:45-58: the config embedded in an .npz checkpoint unless
    ``--config-name`` names one, with ``path`` and the overrides."""
    from threedgrut_tpu_torch.config.loader import (config_from_dict,
                                                    load_config)

    overrides = [f"path={args.path}"] + args.overrides
    if args.config_name is None and args.checkpoint.endswith(".npz"):
        with np.load(args.checkpoint) as data:
            if "config_json" in data.files:
                return config_from_dict(json.loads(str(data["config_json"])),
                                        overrides=overrides)
    return load_config(args.config_name or "apps/nerf_synthetic_3dgut",
                       overrides=overrides)


def refuse(conf):
    """Stop, with the reason, where render.py cannot score the
    checkpoint."""
    if conf.model.feature_type == "nht":
        raise SystemExit(
            "render_torch.py: NHT checkpoints are refused: render.py "
            "composites pred_features, the 2 d NHT ray features, without the "
            "NHT decoder (render.py:96-99), so it cannot score them against "
            "RGB either")


def frame_metrics(i, pred, gt, lpips_params):
    """render.py:107-125: psnr, ssim, their colour-corrected versions and
    lpips (None without weights) of one [H, W, 3] prediction."""
    from threedgrut_tpu_torch.ops.ssim import psnr, ssim
    from threedgrut_tpu_torch.utils import lpips as lpips_mod
    from threedgrut_tpu_torch.utils.color_correct import color_correct_affine

    cc = color_correct_affine(pred, gt)
    p, g, c = (x.permute(2, 0, 1)[None] for x in (pred, gt, cc))
    return {"frame": i, "psnr": float(psnr(pred, gt)),
            "ssim": float(ssim(p, g)), "psnr_cc": float(psnr(cc, gt)),
            "ssim_cc": float(ssim(c, g)),
            "lpips": (float(lpips_mod.lpips(lpips_params, p, g))
                      if lpips_params is not None else None)}


def summary(per_frame, lpips_available):
    """render.py:127-145's metrics.json."""
    def mean(k):
        return float(np.mean([m[k] for m in per_frame]))

    return {
        "psnr": mean("psnr"), "ssim": mean("ssim"),
        "psnr_cc": mean("psnr_cc"), "ssim_cc": mean("ssim_cc"),
        "lpips": mean("lpips") if lpips_available else LPIPS_UNAVAILABLE,
        "best_frame": max(per_frame, key=lambda m: m["psnr"])["frame"],
        "worst_frame": min(per_frame, key=lambda m: m["psnr"])["frame"],
        "per_frame": per_frame,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True,
                        help=".npz trainer checkpoint or .ply")
    parser.add_argument("--path", required=True, help="dataset path")
    parser.add_argument("--config-name", default=None,
                        help="config to compose; default: the resolved "
                             "config embedded in the checkpoint (falls "
                             "back to apps/nerf_synthetic_3dgut)")
    parser.add_argument("--out-dir", default="./eval")
    parser.add_argument("--save-images", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu renders on "
                        "the CPU, slowly)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("render_torch.py: no CUDA device; pass --device cpu "
                         "to render on the CPU")

    from threedgrut_tpu_torch.models import background as bg_mod
    from threedgrut_tpu_torch.models.gaussians import GaussianModel
    from threedgrut_tpu_torch.ops.cuda import launch_counts
    from threedgrut_tpu_torch.render.gut import render_gut
    from threedgrut_tpu_torch.train.trainer import Trainer, camera_from_batch
    from threedgrut_tpu_torch.utils import lpips as lpips_mod
    from threedgrut_tpu_torch.utils.misc import linear_to_srgb
    from train_torch import make_dataset, make_model, trainer_config

    conf = load_conf(args)
    refuse(conf)
    tconf = trainer_config(conf)
    dataset = make_dataset(conf, "test")
    if dataset is None:
        raise SystemExit(f"render_torch.py: no test split under {args.path}")

    trainer = None
    if args.checkpoint.endswith(".ply"):
        model = GaussianModel.from_ply(args.checkpoint, device=device)
        sh_degree = tconf.max_n_features
    else:
        trainer = Trainer(tconf, dataset, make_model(conf, dataset, device))
        trainer.load_checkpoint(args.checkpoint)
        model = trainer.model
        sh_degree = trainer.sh_degree()

    os.makedirs(args.out_dir, exist_ok=True)
    lpips_params = lpips_mod.load_weights(device=device)
    bg = bg_mod.background_color(tconf.background, train=False, device=device)
    per_frame = []
    for i in range(len(dataset)):
        batch = dataset[i]
        cam = camera_from_batch(batch, device)
        with torch.no_grad():
            out = render_gut(cam, tconf.ut, tconf.raster, model, sh_degree)
            pred = bg_mod.apply_background(out["pred_features"],
                                           out["pred_opacity"], bg)
            # render.py:100-105
            if trainer is not None and trainer.ppisp_params is not None:
                pred = trainer._apply_ppisp_eval(pred)
            elif tconf.post_processing == "linear-to-srgb":
                pred = linear_to_srgb(torch.clamp(pred, 0.0, 1.0))
            pred = torch.clamp(pred, 0.0, 1.0)
            gt = torch.as_tensor(np.asarray(batch.rgb_gt, np.float32),
                                 device=device)
            m = frame_metrics(i, pred, gt, lpips_params)
        per_frame.append(m)
        print(m)
        if args.save_images:
            from PIL import Image
            img = (pred.cpu().numpy() * 255).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(args.out_dir, f"pred_{i:04d}.png"))

    metrics = summary(per_frame, lpips_params is not None)
    with open(os.path.join(args.out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print("avg:", {k: v for k, v in metrics.items() if k != "per_frame"})
    print("launches:", json.dumps(launch_counts()))
    return metrics


if __name__ == "__main__":
    main()
