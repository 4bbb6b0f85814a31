#!/usr/bin/env python3
"""Serving-render speed of the PyTorch/CUDA port on one NVIDIA GPU.

The port's counterpart of scripts/eval_fps.py: renders ``--batch`` orbit
views of a frozen model through ``make_serving_renderer`` (exact kill,
fp32) and prints ms/frame beside the card's name and power limit. The
port sizes its pair buffer per view, so there is no budget calibration.

    python scripts/eval_fps_torch.py --synthetic 100000
    python scripts/eval_fps_torch.py --checkpoint ckpt.npz   # or .ply
    python scripts/eval_fps_torch.py --synthetic 100000 \
        --config-name apps/nerf_synthetic_3dgrt

``--config-name`` renders with the render settings of a YAML config
(train_torch.py's mapping): the 3DGRT frame, or the sorted 3DGUT one.
``--camera fisheye`` or ``rolling`` (the general-geometry kernels)
serves the orbit views with the intrinsics of
``threedgrut_tpu_torch/synthetic.py:bench_camera`` instead of the
pinhole's. ``--width`` and ``--height`` set the resolution of any camera
(default: 800x800 for the pinhole, 1752x1168 for the fisheye, 1920x1280
for the rolling shutter).

``--profile`` traces one more batch with torch.profiler and prints the
device time by kernel and the device's busy and idle shares of the
batch's wall time. Needs a CUDA device; it does not fall back to the CPU.

``--save-frame PATH`` writes the first view of the last served batch as
an npz (scripts/eval_fps.py:177-181): ``frame`` (float32 [H, W, 3]) and
``mode``, the render mode of the metric's name (``3dgut``, ``3dgrt``,
``3dgut_sorted``, with ``_rolling`` or ``_fisheye`` for those cameras).
``tools/compare_frames.py a.npz b.npz`` prints the PSNR between two such
files.

Runs on the card; ``--device cpu`` serves on the CPU (slowly, and
without the card's name in the record).
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="trainer .npz or 3DGS .ply")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="the bench.py cloud of N Gaussians (seed 0)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8, help="views per call")
    ap.add_argument("--reps", type=int, default=20, help="timed batches")
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--profile", action="store_true",
                    help="trace one extra batch: device time by kernel")
    ap.add_argument("--config-name", default=None,
                    help="take the render settings of this YAML config")
    ap.add_argument("--camera", default="pinhole",
                    choices=("pinhole", "fisheye", "rolling"))
    ap.add_argument("--save-frame", default="",
                    help="save the first view of the last served batch "
                    "to this .npz (tools/compare_frames.py reads it)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu serves on the "
                    "CPU)")
    args = ap.parse_args(argv)
    if (args.width is None) != (args.height is None):
        raise SystemExit("give both --width and --height, or neither")

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("eval_fps_torch.py needs a CUDA device; pass "
                             "--device cpu to serve on the CPU")
        dev = torch.device("cuda", dev.index or 0)
    elif args.profile:
        raise SystemExit("--profile traces the card: it needs --device cuda")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    from threedgrut_tpu_torch.models.gaussians import GaussianModel
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.serve import make_serving_renderer
    from threedgrut_tpu_torch.synthetic import bench_cloud, orbit_cameras

    if args.synthetic:
        model = bench_cloud(args.synthetic, seed=0, device=dev)
        source = f"synthetic {args.synthetic}"
    elif args.checkpoint.endswith(".ply"):
        model = GaussianModel.from_ply(args.checkpoint, device=dev)
        source = args.checkpoint
    else:
        model = GaussianModel.from_checkpoint(args.checkpoint, device=dev)
        source = args.checkpoint

    cams = orbit_cameras(model, args.batch, args.camera,
                         args.width and (args.width, args.height),
                         device=dev)
    res = cams[0].resolution
    from bench_train_torch import config_raster, render_tag

    rc = config_raster(args.config_name) if args.config_name else \
        RasterConfig()
    serve = make_serving_renderer(model, rc, args.sh_degree)
    t0 = time.perf_counter()
    imgs = serve(cams)               # first batch: kernel build + warm-up
    sync()
    first_s = time.perf_counter() - t0
    per_batch = []                   # ms/frame of each timed batch
    for _ in range(args.reps):
        t0 = time.perf_counter()
        imgs = serve(cams)
        sync()
        per_batch.append((time.perf_counter() - t0) * 1e3 / args.batch)
    ms = float(np.median(per_batch))
    mode = (render_tag(rc) if args.camera == "pinhole"
            else f"{render_tag(rc)}_{args.camera}")
    if args.save_frame:
        np.savez_compressed(args.save_frame,
                            frame=imgs[0].float().cpu().numpy(), mode=mode)
        print(f"saved the first served frame -> {args.save_frame}")
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        name = torch.cuda.get_device_name(dev)
    else:
        smi = name = "cpu"
    print(f"{source}: n={model.n_active}, {res[0]}x{res[1]}, batch "
          f"{args.batch}: median {ms:.3f} ms/frame = {1e3 / ms:.1f} FPS "
          f"over {args.reps} batches (min {min(per_batch):.3f}, max "
          f"{max(per_batch):.3f}; first batch {first_s:.2f} s) on {smi}")
    print(json.dumps({
        "metric": f"{mode}_serve_ms_per_frame_{res[0]}x{res[1]}",
        "camera": args.camera,
        "config": args.config_name or "render/3dgut defaults",
        "value": ms, "unit": "ms/frame (median over batches)",
        "min": min(per_batch), "max": max(per_batch),
        "n_particles": model.n_active,
        "batch": args.batch, "reps": args.reps,
        "finite": bool(torch.isfinite(imgs).all()),
        "device": name, "nvidia_smi": smi}))
    if args.profile:
        profile_batch(serve, cams)
    return 0


def profile_batch(serve, cams):
    """Device time by kernel over one traced batch, and the device's busy
    share of the batch's wall time (kernels of one stream do not
    overlap, so their sum is the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(cams)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: -e.self_device_time_total)
    n = len(cams)
    print(f"profile: {n} views, wall {wall_us / n:.1f} us/view, device "
          f"busy {busy_us / n:.1f} us/view, idle share "
          f"{1.0 - busy_us / wall_us:.3f}")
    for e in events[:20]:
        print(f"  {e.self_device_time_total / n:10.1f} us/view "
              f"{e.count // n:5d} calls/view  {e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
