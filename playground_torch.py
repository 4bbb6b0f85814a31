#!/usr/bin/env python3
"""Interactive playground of the PyTorch/CUDA port (the counterpart of
playground.py):

    python playground_torch.py --asset runs/run/ckpt_last.npz [--port 8090]
    python playground_torch.py --asset scene.ply --demo-primitives

Loads a trained checkpoint (``.npz``) or a 3DGS PLY, optionally adds the
demo primitives (a glass icosphere and a mirror box beside the scene's
centre) and mesh assets, and serves the dependency-free web viewer of
``threedgrut_tpu_torch/playground/web_gui.py``. Frames render on the
card through ``Engine3DGRUT`` (3 bounces, ``trace`` on the raster
kernels); without a card it stops, unless ``--device cpu`` asks for the
CPU.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch


def load_model(path: str, device):
    from threedgrut_tpu_torch.models.gaussians import GaussianModel

    if path.endswith(".ply"):
        return GaussianModel.from_ply(path, device=device)
    if path.endswith(".npz"):
        return GaussianModel.from_checkpoint(path, device=device)
    raise ValueError(f"unsupported asset {path}: .npz or .ply")


def build_engine(model, demo_primitives=False, meshes=(), envmap=None,
                 max_bounces=3):
    """The playground's engine over ``model``: the demo primitives
    (playground.py:73-79) and the ``FILE[:kind]`` mesh assets added.
    Returns (engine, the cloud's centre)."""
    from threedgrut_tpu_torch.playground.engine import (Engine3DGRUT,
                                                        EngineConfig,
                                                        EnvironmentMap,
                                                        PBRMaterial)
    from threedgrut_tpu_torch.playground.mesh import (load_mesh_file,
                                                      make_box,
                                                      make_icosphere)

    env = None
    if envmap:
        from PIL import Image
        env = EnvironmentMap(np.asarray(Image.open(envmap), np.float32)
                             / 255.0, device=model.device)
    engine = Engine3DGRUT(model, EngineConfig(max_bounces=max_bounces), env)
    center = model.positions.detach()[:model.n_active].mean(0).cpu().numpy()
    if demo_primitives:
        engine.add_primitive(
            make_icosphere(center + [0.5, 0, 0], 0.4, 3),
            PBRMaterial(kind="glass", base_color=(0.95, 0.95, 1.0)))
        engine.add_primitive(
            make_box(center + [-0.8, 0, 0], (0.5, 0.5, 0.5)),
            PBRMaterial(kind="mirror", base_color=(0.9, 0.9, 0.9)))
    for spec in meshes:
        path, _, kind = spec.partition(":")
        mat = PBRMaterial(kind=kind or "pbr")
        for m in load_mesh_file(path):
            engine.add_primitive(m, mat)
    return engine, center


def frame_renderer(engine, center, resolution):
    """render(azimuth, elevation, distance) -> uint8 [H, W, 3] of an
    orbit camera around ``center``."""
    from threedgrut_tpu_torch.playground.web_gui import orbit_camera

    def render(az, el, dist):
        cam = orbit_camera(az, el, dist, center=center,
                           resolution=resolution, device=engine.device)
        return (engine.render(cam) * 255).astype(np.uint8)

    return render


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--asset", required=True, help=".npz ckpt or .ply")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--demo-primitives", action="store_true")
    ap.add_argument("--mesh", action="append", default=[],
                    metavar="FILE[:glass|mirror|pbr]",
                    help=".obj/.glb mesh asset to insert (repeatable)")
    ap.add_argument("--envmap", default=None, help="lat-long image")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu renders on the "
                    "CPU, slowly)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("playground_torch.py: no CUDA device; pass "
                         "--device cpu to render on the CPU")

    from threedgrut_tpu_torch.playground.web_gui import ViewerServer

    model = load_model(args.asset, device)
    engine, center = build_engine(model, args.demo_primitives, args.mesh,
                                  args.envmap)
    res = (args.resolution, args.resolution)
    server = ViewerServer(frame_renderer(engine, center, res),
                          resolution=res, port=args.port)
    url = server.start(blocking=False)
    print(f"playground viewer at {url} (ctrl-c to stop)")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
