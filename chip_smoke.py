#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without printing the final result line:

1. device  - a CUDA device is present; its name and power limit.
2. build   - both kernels compile with nvcc from csrc/ (sm_90a).
3. kernel A vs plain - bin_decode on the 100k bench cloud, one 800x800
   view: pair_tile, pair_particle and tile_start EQUAL to the plain
   PyTorch version.
4. kernel B vs plain - raster_fwd on the same view and pairs: features
   and opacity within 1e-4, depth within 1e-3 relative, hit counts
   differing on < 1% of pixels.
5. JAX values - render_gut against the JAX outputs saved in
   tests/fixtures/torch_port_gut_small.npz, at the CPU test tolerances.
6. serving slice - make_serving_renderer on the 100k cloud, 8 orbit
   views at 800x800, SH degree 3: both kernels' launch counters equal
   the number of views; outputs finite with real coverage; ms/frame.
7. oracle probe - 200x200, the first 60k particles, the port's oracle
   against render_gut: bulk >= 80 dB and flip_frac <= 0.01.

Then a JSON line with each kernel's launches, error and times, the
card's name and power limit, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX. Needs one card; there is no CPU fallback.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_VIEWS = 8
SIDE = 800


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU only")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    phase("device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    from threedgrut_tpu_torch.ops import binning
    from threedgrut_tpu_torch.ops.cameras import make_pinhole, orbit_camera
    from threedgrut_tpu_torch.ops.cuda import build
    from threedgrut_tpu_torch.ops.cuda.expand import (
        expand_decode_pairs, expand_decode_pairs_plain)
    from threedgrut_tpu_torch.ops.cuda.raster import (rasterize_tiles,
                                                      rasterize_tiles_plain)
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                       GaussianModelConfig)
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.gut import prepare_view, render_gut
    from threedgrut_tpu_torch.render.oracle import parity_db, render_oracle
    from threedgrut_tpu_torch.render.serve import make_serving_renderer
    from threedgrut_tpu_torch.synthetic import bench_cloud, orbit_geometry

    # 2. build
    t0 = time.perf_counter()
    for name in ("bin_decode", "raster_fwd"):
        build.load(name, verbose=True)
    phase("build", f"bin_decode + raster_fwd for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s (nvcc: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in build.BUILD_SECONDS.items())
          + f") -> {build.BUILD_DIR}")

    ut_cfg = UTConfig()
    rc = RasterConfig()
    model = bench_cloud(100_000, seed=0, device=dev)
    cam = make_pinhole((SIDE, SIDE), (1.1 * SIDE, 1.1 * SIDE),
                       (SIDE / 2, SIDE / 2), device=dev)
    grid = (SIDE // 16, SIDE // 16)
    report = {}

    # 3. kernel A vs plain
    with torch.no_grad():
        v = prepare_view(cam, ut_cfg, rc, model, 3)
        s = binning.pair_slots(v.proj, grid, ut_cfg.alpha_threshold)
        a_args = (s.rows, s.order, s.excl, s.counts, s.total, grid)
        got = binning.sort_pairs(*expand_decode_pairs(*a_args),
                                 grid[0] * grid[1])
        ref = binning.sort_pairs(*expand_decode_pairs_plain(*a_args),
                                 grid[0] * grid[1])
        torch.cuda.synchronize()
        names = ("pair_tile", "pair_particle", "tile_start")
        for nm, g, r in zip(names, got, ref):
            if not torch.equal(g, r):
                bad = int((g != r).sum())
                raise AssertionError(f"kernel A: {nm} differs at {bad} slots")
        a_err = max(float((g - r).abs().max()) if g.numel() else 0.0
                    for g, r in zip(got, ref))
        a_ms = cuda_ms(lambda: expand_decode_pairs(*a_args), 20)
        a_plain_ms = cuda_ms(lambda: expand_decode_pairs_plain(*a_args), 5)
    n_pairs = int(got[2][-1])
    report["bin_decode"] = dict(max_abs_err=a_err, ms=a_ms,
                                plain_ms=a_plain_ms)
    phase("kernel A", f"{s.total} slots, {n_pairs} pairs after the cull: "
          f"pair_tile, pair_particle, tile_start equal to plain; "
          f"kernel {a_ms:.4f} ms, plain {a_plain_ms:.4f} ms")

    # 4. kernel B vs plain
    with torch.no_grad():
        b_args = (v.table, v.binning.pair_particle, v.binning.tile_start,
                  v.ray_d, v.tmin, v.tmax, rc)
        got = rasterize_tiles(*b_args)
        ref = rasterize_tiles_plain(*b_args)
        torch.cuda.synchronize()
        err_f = float((got[0] - ref[0]).abs().max())
        err_o = float((got[1] - ref[1]).abs().max())
        err_d = float(((got[2] - ref[2]).abs()
                       / ref[2].abs().clamp(min=1e-3)).max())
        flips = float((got[3] != ref[3]).float().mean())
        b_ms = cuda_ms(lambda: rasterize_tiles(*b_args), 20)
        b_plain_ms = cuda_ms(lambda: rasterize_tiles_plain(*b_args), 3)
    if not (err_f <= 1e-4 and err_o <= 1e-4 and err_d <= 1e-3
            and flips < 0.01):
        raise AssertionError(
            f"kernel B vs plain: features {err_f:.3g}, opacity {err_o:.3g},"
            f" depth rel {err_d:.3g}, hits flip {flips:.4f}")
    report["raster_fwd"] = dict(max_abs_err=max(err_f, err_o), ms=b_ms,
                                plain_ms=b_plain_ms)
    phase("kernel B", f"features |d| {err_f:.3g}, opacity |d| {err_o:.3g}, "
          f"depth rel {err_d:.3g}, hits flip {flips:.5f}; "
          f"kernel {b_ms:.4f} ms, plain {b_plain_ms:.4f} ms")

    # 5. against the JAX package's values
    fx = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "fixtures", "torch_port_gut_small.npz")
    with np.load(fx) as f:
        cfg = GaussianModelConfig(
            density_activation=str(f["density_activation"]),
            scale_activation=str(f["scale_activation"]),
            max_sh_degree=int(f["n_active_features"]))
        small = GaussianModel.from_numpy(
            {k[len("params/"):]: f[k] for k in f.files
             if k.startswith("params/")},
            int(f["n_active"]), int(f["n_active_features"]), cfg, dev)
        small_cam = make_pinhole(tuple(int(x) for x in f["resolution"]),
                                 f["focal"], f["principal"], t=f["t"],
                                 q=f["q"], device=dev)
        with torch.no_grad():
            out = render_gut(small_cam, ut_cfg, rc, small,
                             int(f["sh_degree"]))
        e_feat = float(np.abs(out["pred_features"].cpu().numpy()
                              - f["pred_features"]).max())
        e_opac = float(np.abs(out["pred_opacity"].cpu().numpy()
                              - f["pred_opacity"]).max())
        e_dist = float(np.abs(out["pred_dist"].cpu().numpy()
                              - f["pred_dist"]).max())
        flip = float((out["hits_count"].cpu().numpy()
                      != f["hits_count"]).mean())
        same_pairs = int(out["num_pairs"]) == int(f["num_pairs"])
    if not (e_feat <= 1e-4 and e_opac <= 1e-4 and e_dist <= 1e-3
            and flip < 0.01 and same_pairs):
        raise AssertionError(
            f"against JAX: features {e_feat:.3g}, opacity {e_opac:.3g}, "
            f"depth {e_dist:.3g}, hits flip {flip:.4f}, "
            f"pairs equal {same_pairs}")
    phase("vs JAX", f"fixture {os.path.basename(fx)}: features {e_feat:.3g}"
          f", opacity {e_opac:.3g}, depth {e_dist:.3g}, hits flip {flip}, "
          f"num_pairs equal")

    # 6. serving slice
    center, dist = orbit_geometry(model)
    cams = [orbit_camera(az, 0.35, dist, center=center,
                         resolution=(SIDE, SIDE), device=dev)
            for az in np.linspace(0.0, 2 * math.pi, N_VIEWS, endpoint=False)]
    serve = make_serving_renderer(model, rc, sh_degree=3, ut_cfg=ut_cfg)
    serve(cams)                              # warm-up (allocator, caches)
    torch.cuda.synchronize()
    expand_decode_pairs.launches = 0
    rasterize_tiles.launches = 0
    t0 = time.perf_counter()
    imgs = serve(cams)
    torch.cuda.synchronize()
    per_batch = [(time.perf_counter() - t0) * 1e3 / N_VIEWS]
    launches = {"bin_decode": expand_decode_pairs.launches,
                "raster_fwd": rasterize_tiles.launches}
    # more batches for the time only: the host clock varies per batch
    for _ in range(4):
        t0 = time.perf_counter()
        serve(cams)
        torch.cuda.synchronize()
        per_batch.append((time.perf_counter() - t0) * 1e3 / N_VIEWS)
    ms_frame = float(np.median(per_batch))
    if launches != {"bin_decode": N_VIEWS, "raster_fwd": N_VIEWS}:
        raise AssertionError(f"serving launches {launches}, "
                             f"expected {N_VIEWS} each")
    if tuple(imgs.shape) != (N_VIEWS, SIDE, SIDE, 3):
        raise AssertionError(f"serving output shape {tuple(imgs.shape)}")
    if not bool(torch.isfinite(imgs).all()):
        raise AssertionError("serving output has non-finite values")
    coverage = [float((im.amax(dim=-1) > 1e-3).float().mean()) for im in imgs]
    if min(coverage) < 0.05:
        raise AssertionError(f"serving coverage too low: {coverage}")
    phase("serving", f"{N_VIEWS} views {SIDE}x{SIDE}, 100k Gaussians, SH 3: "
          f"{ms_frame:.3f} ms/frame ({1e3 / ms_frame:.1f} FPS) host clock, "
          f"median of {len(per_batch)} batches (min {min(per_batch):.3f}, "
          f"max {max(per_batch):.3f}); "
          f"launches {launches}; coverage min {min(coverage):.3f}")

    # 7. oracle probe
    side, n = 200, 60_000
    probe = bench_cloud(100_000, seed=0, device=dev)
    keep = 60_160
    with torch.no_grad():
        arrays = {k: getattr(probe, k)[:keep].cpu().numpy() for k in
                  ("positions", "rotation", "scale", "density",
                   "features_albedo", "features_specular")}
    probe = GaussianModel.from_numpy(arrays, n, 3, GaussianModelConfig(), dev)
    pcam = make_pinhole((side, side), (1.1 * side, 1.1 * side),
                        (side / 2, side / 2), device=dev)
    with torch.no_grad():
        got = render_gut(pcam, ut_cfg, rc, probe, 3)["pred_features"]
        ref = render_oracle(pcam, ut_cfg, rc, probe, 3,
                            chunk=512)["pred_features"]
    bulk, raw, flip = parity_db(got.cpu().numpy(), ref.cpu().numpy())
    if not (bulk >= 80.0 and flip <= 0.01):
        raise AssertionError(f"oracle probe: bulk {bulk:.1f} dB, "
                             f"flip_frac {flip:.5f}")
    phase("oracle", f"{side}x{side}, {n} particles: bulk {bulk:.1f} dB, "
          f"raw {raw:.1f} dB, flip_frac {flip:.5f}")

    kernels = [
        dict(name="bin_decode", route="cuda",
             source="threedgrut_tpu_torch/csrc/bin_decode.cu",
             replaces="threedgrut_tpu/ops/pallas/expand.py:86",
             launches=launches["bin_decode"], **report["bin_decode"]),
        dict(name="raster_fwd", route="cuda",
             source="threedgrut_tpu_torch/csrc/raster_fwd.cu",
             replaces="threedgrut_tpu/ops/pallas/raster.py:1147",
             launches=launches["raster_fwd"], **report["raster_fwd"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
