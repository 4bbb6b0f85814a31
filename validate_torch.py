#!/usr/bin/env python3
"""Validation matrix CLI of the PyTorch/CUDA port (the counterpart of
validate.py):

    python validate_torch.py [--path /data/lego] [--iterations 120] \\
        [--out report.md] [--device cpu]

Trains small-budget runs of the {3DGUT + SH, 3DGRT + SH (sorted),
3DGUT + NHT} matrix and writes a markdown report with PSNR and SSIM
(validated on the training views), train time, it/s and the final
Gaussian count per experiment. Each experiment has validate.py's
TrainerConfig (validate.py:28-55: MCMC, capacity 256, SH degree 2 grown
every 20 steps, the sorted settings, relocate and add from step 20 every
40) and its 128 seeded initial points. NHT runs with 48 features, the
width of every shipped config and the only one the card's NHT kernels
take (validate.py uses 16). The pair buffer is sized per view.

With ``--path`` it reads that NeRF-synthetic capture's train split;
without, six 64x64 views of ``synthetic.py:build_teacher`` (the
generator's 60k-Gaussian teacher, seed 0) on black rendered through the
port (``teacher_dataset``), where validate.py takes
tests/test_training.py's SyntheticDataset. The report names the dataset.
It trains on the card; without one it stops, unless ``--device cpu``
asks for the CPU.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

EXPERIMENTS = (
    ("3DGUT + SH", "sh", False),
    ("3DGRT + SH (sorted)", "sh", True),
    ("3DGUT + NHT", "nht", False),
)
NHT_FEATURE_DIM = 48
TEACHER_VIEWS, TEACHER_SIDE = 6, 64


def run_experiment(name, feature_type, sorted_mode, dataset, iterations,
                   capacity=256, device="cpu"):
    """validate.py:run_experiment: its model, Trainer and steps, then a
    validation pass over the training views."""
    from threedgrut_tpu_torch.models.gaussians import (GaussianModelConfig,
                                                       initialize_from_points)
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = GaussianModelConfig(feature_type=feature_type,
                              nht_feature_dim=NHT_FEATURE_DIM,
                              max_sh_degree=2)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.2, 1.2, (128, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(3.0, 5.5, 128)
    model = initialize_from_points(cfg, pts, capacity=capacity,
                                   device=device)
    tconf = TrainerConfig(
        strategy="mcmc", n_iterations=iterations,
        raster=RasterConfig(sorted_compositing=sorted_mode,
                            kernel_degree=4 if sorted_mode else 2,
                            min_transmittance=1e-3 if sorted_mode else 1e-4),
        init_n_features=0, max_n_features=2, increase_frequency=20)
    tconf.mcmc = tconf.mcmc.replace(relocate_start=20, relocate_frequency=40,
                                    add_start=20, add_frequency=40,
                                    max_n_gaussians=capacity)
    tr = Trainer(tconf, dataset, model)
    t0 = time.time()
    for step in range(iterations):
        tr.train_iteration(dataset[step % len(dataset)])
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    train_s = time.time() - t0
    metrics = tr.validate()
    return dict(name=name, psnr=metrics["psnr"], ssim=metrics["ssim"],
                train_s=train_s, iters_per_s=iterations / train_s,
                n_gaussians=int(tr.model.n_active))


def default_dataset(device):
    """The default dataset: (dataset, its description)."""
    from threedgrut_tpu_torch.synthetic import build_teacher, teacher_dataset

    teacher = build_teacher(60000, seed=0, device=device)
    ds = teacher_dataset(teacher, n_views=TEACHER_VIEWS, side=TEACHER_SIDE,
                         background=0.0)
    return ds, (f"{TEACHER_VIEWS} views {TEACHER_SIDE}x{TEACHER_SIDE} of "
                "synthetic.py:build_teacher (60k Gaussians, seed 0) on black")


def write_report(path, rows, iterations, dataset_desc):
    with open(path, "w") as f:
        f.write("# Validation report (threedgrut_tpu_torch)\n\n")
        f.write(f"iterations per experiment: {iterations}\n\n")
        f.write(f"dataset: {dataset_desc}\n\n")
        f.write("| experiment | PSNR | SSIM | train (s) | it/s | N |\n")
        f.write("|---|---|---|---|---|---|\n")
        for r in rows:
            f.write(f"| {r['name']} | {r['psnr']:.2f} | {r['ssim']:.3f} | "
                    f"{r['train_s']:.1f} | {r['iters_per_s']:.1f} | "
                    f"{r['n_gaussians']} |\n")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default=None)
    parser.add_argument("--iterations", type=int, default=120)
    parser.add_argument("--out", default="report.md")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu trains on the "
                        "CPU, slowly)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("validate_torch.py: no CUDA device; pass --device "
                         "cpu to train on the CPU")

    if args.path:
        from threedgrut_tpu_torch.config.loader import load_config
        from train_torch import make_dataset

        conf = load_config("apps/nerf_synthetic_3dgut",
                           overrides=[f"path={args.path}"])
        dataset = make_dataset(conf, "train")
        desc = f"the train split of {args.path} ({len(dataset)} views)"
    else:
        dataset, desc = default_dataset(device)

    from threedgrut_tpu_torch.ops.cuda import launch_counts

    rows = []
    for name, ftype, sorted_mode in EXPERIMENTS:
        print(f"=== {name} ===")
        r = run_experiment(name, ftype, sorted_mode, dataset,
                           args.iterations, device=device)
        print(r)
        rows.append(r)
    write_report(args.out, rows, args.iterations, desc)
    print("launches:", json.dumps(launch_counts()))
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
