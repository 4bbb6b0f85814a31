#!/usr/bin/env python3
"""Train-step speed of the PyTorch/CUDA port on one NVIDIA GPU.

The port's counterpart of bench.py:118-217: one 3DGUT train step on the
100k-Gaussian bench cloud at 800x800, SH degree 3 (UT projection ->
binning -> raster forward -> L1 + DSSIM against a seeded GT -> backward
through the raster and fold kernels -> Adam over the active rows), with
the reference's exact kill in fp32. Prints one JSON line with it/s,
ms/step, the card's name and power limit, and the on-device oracle-parity
probe of bench.py:207-214 on the trained cloud (bulk and raw dB and the
flip fraction of ``render/oracle.py:oracle_parity_db``; null for NHT).

    python scripts/bench_train_torch.py [--steps 20] [--profile]
    python scripts/bench_train_torch.py --config-name apps/nerf_synthetic_3dgrt
    python scripts/bench_train_torch.py \
        --config-name apps/nerf_synthetic_3dgut_mcmc_nht
    python scripts/bench_train_torch.py --camera rolling

``--camera`` swaps the 800x800 pinhole for the ScanNet++-like fisheye at
1752x1168 (shared-origin kernels) or the NCore-like rolling shutter at
1920x1280 (the general-geometry kernels) of
``threedgrut_tpu_torch/synthetic.py:bench_camera``; the GT is seeded
noise at that resolution.

``--config-name`` takes the render settings (kernel degree, thresholds,
sorted compositing and its window) of a YAML config, through
train_torch.py's mapping: the 3DGRT step of tests/tpu_bench_grt.py, or
the sorted 3DGUT one. The workload stays the same, unless the config
trains NHT features (``apps/nerf_synthetic_3dgut_mcmc_nht``,
``apps/nerf_synthetic_3dgrt_mcmc_nht``): then the cloud carries 48 NHT
features per Gaussian (synthetic.py:nht_cloud), the rendered 24 ray
features go through the NHT decoder (whose weights join Adam, unmasked,
and whose EMA shadow updates every step), and an MCMC strategy's
perturb moves the positions after every step, as the trainer's step
does.

``--profile`` traces 5 more steps with torch.profiler and prints the
device time by kernel and the device's idle share of the steps' wall
time. Needs a CUDA device; it does not fall back to the CPU.
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

N_GAUSSIANS = 100_000
WARMUP_STEPS = 3     # kernel build, allocator, caches
PROFILE_STEPS = 5


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


class BenchStep:
    """bench.py's train step: the bench cloud, one 800x800 view, a seeded
    uniform GT, L1 0.8 + DSSIM 0.2, Adam (lr 1e-3 on every group) over the
    active rows. With ``nht``: NHT features, the decoder (and its EMA) in
    the step, and MCMC's perturb (noise ``noise_lr``, the lr 1e-3) after
    it."""

    def __init__(self, device, raster_cfg=None, camera="pinhole", nht=False,
                 noise_lr=5e5):
        from threedgrut_tpu_torch.models.nht_decoder import FeatureDecoder
        from threedgrut_tpu_torch.ops.ut import UTConfig
        from threedgrut_tpu_torch.optimizers.adam import init_adam_state
        from threedgrut_tpu_torch.render.common import RasterConfig
        from threedgrut_tpu_torch.synthetic import (bench_camera, bench_cloud,
                                                    nht_cloud)

        self.model = (nht_cloud if nht else bench_cloud)(
            N_GAUSSIANS, seed=0, device=device)
        self.cam = bench_camera(camera, device=device)
        w, h = self.cam.resolution
        rng = np.random.default_rng(1)
        self.gt = torch.tensor(rng.uniform(0, 1, (h, w, 3)).astype(
            np.float32), device=device)
        self.ut_cfg, self.rc = UTConfig(), raster_cfg or RasterConfig()
        self.params = self.model.params()
        self.decoder = None
        if nht:
            self.decoder = FeatureDecoder(self.model.features.shape[1] // 2,
                                          device=device)
            self.params.update({f"nht_decoder/{i}": w for i, w in
                                enumerate(self.decoder.weights())})
        self.noise_lr = noise_lr
        self.gen = torch.Generator(device=device).manual_seed(2)
        self.opt = init_adam_state(self.params)
        self.lrs = {k: 1e-3 for k in self.params}

    def __call__(self) -> torch.Tensor:
        """One step; returns the loss (a device scalar, not synced)."""
        from threedgrut_tpu_torch.ops.ssim import ssim
        from threedgrut_tpu_torch.optimizers.adam import adam_step
        from threedgrut_tpu_torch.render.gut import render_gut
        from threedgrut_tpu_torch.strategy.mcmc import perturb

        for p in self.params.values():
            p.grad = None
        out = render_gut(self.cam, self.ut_cfg, self.rc, self.model, 3)
        pred = out["pred_features"]
        if self.decoder is not None:
            h, w, f = pred.shape
            pred = self.decoder(pred.reshape(-1, f),
                                out["ray_d"].reshape(-1, 3)).reshape(h, w, 3)
        l1 = torch.mean(torch.abs(pred - self.gt))
        s = ssim(pred.permute(2, 0, 1)[None], self.gt.permute(2, 0, 1)[None])
        loss = 0.8 * l1 + 0.2 * (1.0 - s)
        loss.backward()
        self.opt = adam_step(
            self.params, {k: p.grad for k, p in self.params.items()},
            self.opt, self.lrs, update_mask=self.model.active_mask())
        if self.decoder is not None:
            self.decoder.ema_update()
            perturb(self.model, self.gen, 1e-3, self.noise_lr)
        return loss.detach()


def time_steps(step, n_steps: int):
    """(ms per step, losses) over n_steps, host clock with a device sync
    at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(n_steps)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_steps, losses


def config_raster(name: str):
    """The RasterConfig of a YAML config (train_torch.py's mapping)."""
    from threedgrut_tpu_torch.config.loader import load_config
    from train_torch import trainer_config

    return trainer_config(load_config(name, overrides=["path=none"])).raster


def config_step(name: str, device, camera="pinhole") -> BenchStep:
    """The bench step with a YAML config's render settings
    (train_torch.py's mapping) and, for an NHT config, its NHT step with
    the config's MCMC perturb noise."""
    from threedgrut_tpu_torch.config.loader import load_config
    from train_torch import trainer_config

    conf = load_config(name, overrides=["path=none"])
    tconf = trainer_config(conf)
    return BenchStep(device, tconf.raster, camera,
                     nht=conf.model.feature_type == "nht",
                     noise_lr=tconf.mcmc.noise_lr)


def render_tag(rc) -> str:
    """The metric names' prefix: 3dgut, 3dgut_sorted or 3dgrt."""
    if not rc.sorted_compositing:
        return "3dgut"
    return "3dgrt" if rc.kernel_degree == 4 else "3dgut_sorted"


def profile_steps(step, n_steps: int, top: int = 25):
    """Device time by kernel over n_steps traced steps, and the device's
    busy share of their wall time (one stream: kernels do not overlap,
    so their sum is the busy time). Prints them and returns
    (wall us/step, device busy us/step, device kernels/step)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: -e.self_device_time_total)
    print(f"profile: {n_steps} steps, wall {wall_us / n_steps:.1f} us/step, "
          f"device busy {busy_us / n_steps:.1f} us/step, idle share "
          f"{1.0 - busy_us / wall_us:.3f}")
    for e in events[:top]:
        print(f"  {e.self_device_time_total / n_steps:10.1f} us/step "
              f"{e.count / n_steps:6.1f} calls/step  {e.key[:90]}")
    return (wall_us / n_steps, busy_us / n_steps,
            sum(e.count for e in events) / n_steps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20, help="timed steps")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--config-name", default=None,
                    help="take the render settings of this YAML config")
    ap.add_argument("--camera", default="pinhole",
                    choices=("pinhole", "fisheye", "rolling"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_train_torch.py needs a CUDA device")
    dev = torch.device("cuda:0")
    step = (config_step(args.config_name, dev, args.camera)
            if args.config_name else BenchStep(dev, camera=args.camera))
    w, h = step.cam.resolution
    tag = render_tag(step.rc) + ("_nht" if step.decoder is not None else "")
    metric = (f"{tag}_train_iters_per_sec_100k_800px"
              if args.camera == "pinhole" else
              f"{tag}_{args.camera}_train_iters_per_sec_100k_{w}x{h}")
    t0 = time.perf_counter()
    time_steps(step, WARMUP_STEPS)
    warm_s = time.perf_counter() - t0
    ms, losses = time_steps(step, args.steps)
    smi = nvidia_smi_line()
    # the on-device oracle-parity probe of bench.py:207-214, on the
    # trained cloud (the oracle composites SH features only: null for NHT)
    parity = (None, None, None)
    if step.decoder is None:
        from threedgrut_tpu_torch.render.oracle import oracle_parity_db
        parity = oracle_parity_db(step.model, step.ut_cfg, step.rc)
    print(json.dumps({
        "metric": metric, "camera": args.camera,
        "config": args.config_name or "render/3dgut defaults",
        "raster": {k: getattr(step.rc, k) for k in (
            "kernel_degree", "min_transmittance", "sorted_compositing",
            "sort_window")},
        "it_s": 1e3 / ms, "ms_per_step": ms, "steps": args.steps,
        "warmup_s": warm_s, "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]),
        "finite": bool(all(torch.isfinite(x) for x in losses)),
        "oracle_parity_db": parity[0], "oracle_parity_raw_db": parity[1],
        "oracle_flip_frac": parity[2],
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    if args.profile:
        profile_steps(step, PROFILE_STEPS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
