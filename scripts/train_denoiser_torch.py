#!/usr/bin/env python3
"""Train the playground's learned CNN denoiser with the PyTorch/CUDA port
(the port's counterpart of scripts/train_denoiser.py, same flags and
defaults, plus ``--device``).

Pairs of procedural playground scenes, each a random coloured cloud of
220 Gaussians (capacity 256) with 1-2 mirror, glass or PBR icospheres
over a ground box and a random constant environment:

  * noisy input  = 1 SPP with depth-of-field aperture sampling and
    independent-random subpixel jitter (the playground's Monte-Carlo
    noise sources),
  * clean target = the same scene and camera accumulated to --spp-ref
    samples.

Every scene, camera and crop comes from ``np.random.default_rng(7)`` in
the JAX script's order, so both scripts draw the same scenes, cameras and
crops. The per-pair seed that the JAX script turns into a PRNG key seeds
the engine's torch generators here: only the jitter and aperture draws
differ (playground/sampling.py). The Gaussian segments of every bounce
go through ``render/grt.py:trace``'s brute force (capacity 256 <= 8192):
kernel B's shared-segment mode on the card.

Pairs are cached under --data as an npz of ``noisy`` and ``clean``
[N, side, side, 3] float32 arrays, the JAX script's format: a cache that
either script wrote is read by the other. Training is Adam on L1 + 0.5 *
(L1 of the finite differences) over random crops, in fp32 (TF32 off).
The weights go through ``denoise_cnn.save_params`` to --out (default
the port's ``denoise_cnn.WEIGHTS_PATH``), where
``denoise_cnn.denoise_frame(path=...)`` reads them.

    python scripts/train_denoiser_torch.py --scenes 16 --side 96 --steps 600
    python scripts/train_denoiser_torch.py --device cpu --data pairs.npz \\
        --steps 20 --crop 8 --batch 2 --out weights.npz
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def random_scene(rng, device, n=220):
    """A playground engine over a random scene drawn from ``rng`` (the
    JAX script's draws, in its order)."""
    from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                       GaussianModelConfig)
    from threedgrut_tpu_torch.ops.sh import rgb_to_sh0
    from threedgrut_tpu_torch.playground.engine import (Engine3DGRUT,
                                                        EngineConfig,
                                                        EnvironmentMap,
                                                        PBRMaterial)
    from threedgrut_tpu_torch.playground.mesh import make_box, make_icosphere

    cap = 256
    pos = np.zeros((cap, 3), np.float32)
    pos[:n] = rng.uniform(-0.9, 0.9, (n, 3))
    pos[:n, 1] = rng.uniform(-0.3, 0.8, n)
    pos[n:, 2] = 1e6
    quat = rng.normal(size=(cap, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    scale = np.log(rng.uniform(0.03, 0.12, (cap, 3)).astype(np.float32))
    dens = rng.normal(size=(cap, 1)).astype(np.float32) * 0.6 + 0.5
    albedo = rgb_to_sh0(torch.from_numpy(
        rng.uniform(0.05, 0.95, (cap, 3)).astype(np.float32))).numpy()
    model = GaussianModel.from_numpy(
        dict(positions=pos, rotation=quat, scale=scale, density=dens,
             features_albedo=albedo,
             features_specular=np.zeros((cap, 45), np.float32)),
        n_active=n, n_active_features=3, config=GaussianModelConfig(),
        device=device)

    cfg = EngineConfig(
        max_bounces=3, spp=1, spp_mode="independent_random",
        aperture=float(rng.uniform(0.04, 0.14)),
        focus_distance=float(rng.uniform(2.4, 3.6)),
        gaussian_sh_degree=0)
    env = EnvironmentMap(constant=tuple(rng.uniform(0.2, 0.9, 3)),
                         device=device)
    eng = Engine3DGRUT(model, cfg, env)
    kinds = ["mirror", "glass", "pbr"]
    for _ in range(int(rng.integers(1, 3))):
        kind = kinds[int(rng.integers(0, 3))]
        mat = PBRMaterial(
            kind=kind, base_color=tuple(rng.uniform(0.3, 0.9, 3)),
            roughness=float(rng.uniform(0.05, 0.5)),
            metallic=float(rng.uniform(0.0, 1.0)),
            ior=1.45)
        c = rng.uniform(-0.6, 0.6, 3)
        c[1] = rng.uniform(-0.1, 0.5)
        eng.add_primitive(
            make_icosphere(c, float(rng.uniform(0.18, 0.35)),
                           subdivisions=1), mat)
    eng.add_primitive(make_box((0.0, -0.55, 0.0), (2.4, 0.1, 2.4)),
                      PBRMaterial(kind="diffuse",
                                  base_color=(0.6, 0.6, 0.6)))
    return eng


def pair_camera(rng, side, device):
    """The pair's camera from ``rng``: an orbit pose (azimuth, elevation
    10-40 degrees, radius 2.6-3.4) looking at the origin, as a pinhole
    ``side`` x ``side`` view with focal 1.1 * side."""
    from threedgrut_tpu_torch.data.protocols import Batch
    from threedgrut_tpu_torch.synthetic import camera_pose
    from threedgrut_tpu_torch.train.trainer import camera_from_batch

    az = rng.uniform(0, 2 * np.pi)
    el = np.deg2rad(rng.uniform(10, 40))
    radius = rng.uniform(2.6, 3.4)
    cv = camera_pose(az, el, radius)
    cv[:3, 1] *= -1                  # OpenGL -> OpenCV axes
    cv[:3, 2] *= -1
    b = Batch(rays_ori=np.zeros((side, side, 3), np.float32),
              rays_dir=np.zeros((side, side, 3), np.float32),
              T_to_world=cv.astype(np.float32),
              intrinsics=[1.1 * side, 1.1 * side, side / 2, side / 2])
    return camera_from_batch(b, device)


def render_pair(eng, rng, side, spp_ref):
    """(noisy, clean) [side, side, 3] float32 renders of one camera: 1 spp
    and ``spp_ref`` spp, their random draws seeded from ``rng``."""
    cam = pair_camera(rng, side, eng.device)
    seed = int(rng.integers(0, 2 ** 31 - 1))
    noisy = eng.render(cam, seed=seed)
    eng.config.spp = spp_ref         # render_progressive reads it per call
    clean = eng.render(cam, seed=seed + 1)
    eng.config.spp = 1
    return noisy, clean


def loss_fn(params, x, y):
    """L1 of the denoised crops plus half the L1 of their finite
    differences against the target's (edge preservation)."""
    from threedgrut_tpu_torch.playground import denoise_cnn

    out = denoise_cnn.apply_cnn(params, x)
    l1 = torch.mean(torch.abs(out - y))
    gx = torch.mean(torch.abs((out[:, :, 1:] - out[:, :, :-1])
                              - (y[:, :, 1:] - y[:, :, :-1])))
    gy = torch.mean(torch.abs((out[:, 1:] - out[:, :-1])
                              - (y[:, 1:] - y[:, :-1])))
    return l1 + 0.5 * (gx + gy)


def crop_batch(rng, noisy, clean, batch, crop):
    """``batch`` random crops of random pairs, drawn from ``rng`` as the
    JAX script draws them: (noisy, clean) [batch, crop, crop, 3]."""
    side = noisy.shape[1]
    idx = rng.integers(0, len(noisy), batch)
    ys = rng.integers(0, side - crop + 1, batch)
    xs = rng.integers(0, side - crop + 1, batch)
    xb = np.stack([noisy[i, y:y + crop, x:x + crop]
                   for i, y, x in zip(idx, ys, xs)])
    yb = np.stack([clean[i, y:y + crop, x:x + crop]
                   for i, y, x in zip(idx, ys, xs)])
    return xb, yb


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--side", type=int, default=96)
    ap.add_argument("--spp-ref", type=int, default=24)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--data", default="runs/denoiser_pairs.npz")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu renders and "
                    "trains on the CPU, slowly)")
    return ap.parse_args(argv)


def main(argv=None):
    """Render (or load) the pairs, fit the CNN, save its weights. Returns
    the MSEs and the dB gain over the full set and the ms of each
    rendered pair and training step."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_denoiser_torch.py: no CUDA device; pass "
                         "--device cpu to train on the CPU")
    # fp32 convolutions: cuDNN would otherwise round them through TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from threedgrut_tpu_torch.playground import denoise_cnn
    from threedgrut_tpu_torch.utils.timer import DeviceTimer

    # ms of each pair and step: CUDA events on the card, the host clock
    # on the CPU
    timer = DeviceTimer(device=device)

    def timed(fn):
        timer.reset()
        timer.start()
        out = fn()
        timer.end()
        return out, timer.timing()

    rng = np.random.default_rng(7)
    pair_ms = []
    if os.path.exists(args.data):
        with np.load(args.data) as blob:
            noisy, clean = blob["noisy"], blob["clean"]
        print(f"loaded {len(noisy)} cached pairs from {args.data}",
              flush=True)
    else:
        noisy, clean = [], []
        for s in range(args.scenes):
            eng = random_scene(rng, device)
            (n, c), ms = timed(lambda: render_pair(eng, rng, args.side,
                                                   args.spp_ref))
            pair_ms.append(ms)
            noisy.append(n)
            clean.append(c)
            print(f"scene {s + 1}/{args.scenes} rendered in "
                  f"{ms:.1f} ms (noise rms "
                  f"{np.sqrt(np.mean((n - c) ** 2)):.4f})", flush=True)
        noisy = np.stack(noisy).astype(np.float32)
        clean = np.stack(clean).astype(np.float32)
        os.makedirs(os.path.dirname(args.data) or ".", exist_ok=True)
        np.savez_compressed(args.data, noisy=noisy, clean=clean)

    params = denoise_cnn.init_params(torch.Generator().manual_seed(0),
                                     guides=False, device=device)
    leaves = [p for layer in params.values() for p in layer.values()]
    for p in leaves:
        p.requires_grad_(True)
    # torch's Adam with its defaults is optax.adam(lr)'s update: b1 0.9,
    # b2 0.999, eps 1e-8 added outside the square root, bias-corrected
    opt = torch.optim.Adam(leaves, lr=args.lr)

    base_mse = float(np.mean((noisy - clean) ** 2))

    def step(xb, yb):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, torch.from_numpy(xb).to(device),
                       torch.from_numpy(yb).to(device))
        loss.backward()
        opt.step()
        return loss

    step_ms = []
    for it in range(args.steps):
        xb, yb = crop_batch(rng, noisy, clean, args.batch, args.crop)
        loss, ms = timed(lambda: step(xb, yb))
        step_ms.append(ms)
        loss = float(loss.detach())
        if (it + 1) % 100 == 0:
            print(f"step {it + 1}: loss {loss:.5f}", flush=True)

    with torch.no_grad():
        out = denoise_cnn.apply_cnn(params, torch.from_numpy(noisy).to(
            device)).cpu().numpy()
    out_mse = float(np.mean((out - clean) ** 2))
    gain = float(10 * np.log10(base_mse / max(out_mse, 1e-12)))
    print(f"full-set MSE noisy={base_mse:.6f} denoised={out_mse:.6f} "
          f"({gain:.2f} dB gain)", flush=True)
    path = args.out or denoise_cnn.WEIGHTS_PATH
    denoise_cnn.save_params(params, path)
    print("saved:", path)
    return dict(base_mse=base_mse, out_mse=out_mse, gain_db=gain,
                pair_ms=pair_ms, step_ms=step_ms)


if __name__ == "__main__":
    main()
