#!/usr/bin/env python3
"""Generate the NeRF-synthetic-format dataset of
scripts/gen_synthetic_scene.py with the PyTorch/CUDA port: the same
procedural "lego-class" teacher (~60k Gaussians: towers, an arch and a
ground slab; ``synthetic.py:build_teacher``) on the same orbits
(``synthetic.py:orbit_poses``, split seeds seed + 1, + 2 and + 3),
rendered with the port's 3DGUT ``render_gut`` at SH degree 3, written as
``{train,val,test}/r_{i}.png`` (RGBA, truncated to uint8 as that script
does) and ``transforms_{split}.json`` (OpenGL camera-to-world,
``camera_angle_x = 2 atan(0.5 / 1.111)``).

Usage: python scripts/gen_synthetic_scene_torch.py --out runs/synth_lego \\
           [--side 800] [--n-train 100] [--n-val 16] [--teacher-n 60000] \\
           [--seed 0] [--device cuda]

Renders on the card; without one it stops, unless ``--device cpu`` asks
for the CPU. The pair buffer is not capped: each view prints its pair
slots before the tile cull (what the JAX script's ``max_pairs = 2^20``
caps, padded to 128-pair chunks there), its pairs after the cull and the
overflow the port reports (0 uncapped).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

# the JAX script's pair budget (gen_synthetic_scene.py:153), for the
# per-view report only
JAX_MAX_PAIRS = 1 << 20


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--side", type=int, default=800)
    ap.add_argument("--n-train", type=int, default=100)
    ap.add_argument("--n-val", type=int, default=16)
    ap.add_argument("--teacher-n", type=int, default=60000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu renders on the "
                    "CPU, slowly)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gen_synthetic_scene_torch.py: no CUDA device; pass "
                         "--device cpu to render on the CPU")

    from PIL import Image

    from threedgrut_tpu_torch.ops.cuda import launch_counts
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.gut import render_gut
    from threedgrut_tpu_torch.synthetic import (build_teacher, orbit_poses,
                                                teacher_views)
    from threedgrut_tpu_torch.train.trainer import camera_from_batch

    teacher = build_teacher(args.teacher_n, args.seed, device=device)
    side = args.side
    camera_angle_x = 2 * np.arctan(0.5 / 1.111)   # focal = 1.111 * W
    ut_cfg, rc = UTConfig(), RasterConfig()
    os.makedirs(args.out, exist_ok=True)
    over_cap = []

    def write_split(name, n_frames, seed_off):
        frames = []
        d = os.path.join(args.out, name)
        os.makedirs(d, exist_ok=True)
        poses = orbit_poses(n_frames, args.seed, seed_off)
        views = teacher_views(n_frames, (side, side), "pinhole", args.seed,
                              seed_off)
        for i, (c2w, view) in enumerate(zip(poses, views)):
            cam = camera_from_batch(view, device)
            with torch.no_grad():
                out = render_gut(cam, ut_cfg, rc, teacher, sh_degree=3)
                img = torch.clamp(out["pred_features"], 0, 1)
                op = torch.clamp(out["pred_opacity"], 0, 1)
                rgba = torch.cat([img, op], dim=-1).cpu().numpy()
            fp = f"./{name}/r_{i}"
            Image.fromarray((rgba * 255).astype(np.uint8)).save(
                os.path.join(d, f"r_{i}.png"))
            frames.append({"file_path": fp,
                           "transform_matrix": c2w.tolist()})
            slots = int(out["num_slots"])
            if slots > JAX_MAX_PAIRS:
                over_cap.append(f"{name}/r_{i}")
            print(f"{name} r_{i}: {slots} pair slots before the tile cull "
                  f"({'over' if slots > JAX_MAX_PAIRS else 'within'} "
                  f"2^20), {int(out['num_pairs'])} pairs after it, "
                  f"overflow {int(out['pairs_overflow'])}", flush=True)
        with open(os.path.join(args.out,
                               f"transforms_{name}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x,
                       "frames": frames}, f)

    write_split("train", args.n_train, 1)
    write_split("val", args.n_val, 2)
    write_split("test", args.n_val, 3)
    print(f"views over the JAX script's 2^20 pair slots: {len(over_cap)}"
          + (f" ({', '.join(over_cap)})" if over_cap else ""))
    print("launches:", json.dumps(launch_counts()))
    print("done:", args.out)


if __name__ == "__main__":
    main()
