#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without printing the final result line:

1. device  - a CUDA device is present; its name and power limit.
2. build   - the four kernels compile with nvcc from csrc/ (sm_90a), one
   nvcc process per source, all started together.
3. kernel A vs plain - bin_decode on the 100k bench cloud, one 800x800
   view: pair_tile, pair_particle and tile_start EQUAL to the plain
   PyTorch version.
4. kernel B vs plain - raster_fwd on the same view and pairs: features,
   opacity and T_final within 1e-4, depth within 1e-3 relative, hit
   counts differing on < 1% of pixels.
5. JAX values - render_gut against the JAX outputs saved in
   tests/fixtures/torch_port_gut_small.npz, at the CPU test tolerances.
6. serving slice - make_serving_renderer on the 100k cloud, 8 orbit
   views at 800x800, SH degree 3: both kernels' launch counters equal
   the number of views; outputs finite with real coverage; ms/frame.
7. oracle probe - 200x200, the first 60k particles, the port's oracle
   against render_gut: bulk >= 80 dB and flip_frac <= 0.01.
8. kernel C vs plain - raster_bwd on the phase-4 view with seeded random
   upstream gradients: per record field group (a, M, density, rgb)
   cosine >= 0.9999 and relative L2 <= 1e-3 against the float64
   autograd plain version.
9. kernel D vs plain - fold on kernel C's output: max |diff| <= 1e-5 of
   max |ref|, and two runs bitwise equal.
10. gradients vs JAX - render_gut's gradients of the six parameter
   leaves against tests/fixtures/torch_port_grad_small.npz:
   max-normalised error <= 2e-3 and cosine >= 0.9999.
11. train step - scripts/bench_train_torch.py's step (100k, 800x800,
   SH 3, L1 + DSSIM, Adam): 3 warm-up steps, then 20 timed steps in
   which kernels A-D launch 20 times each; loss finite; every parameter
   gradient finite and non-zero; ms/step and it/s.
12. trainer - Trainer from 100k random Gaussians (capacity headroom 4)
   on 8 teacher views at 800x800, 260 steps: densify grows the cloud,
   n_active changes, the mean train PSNR of steps 230-249 beats steps
   1-20 by >= 2 dB, the density reset at step 250 clamps every active
   density, and a checkpoint round trip repeats the next step's loss.

The 3DGRT and sorted-3DGUT path (sorted compositing: per-ray windows of
W candidates; render/grt.py):

The two sorted settings are those train_torch.py composes for
apps/nerf_synthetic_3dgrt (3DGRT: degree 4, min_transmittance 1e-3,
W = 16) and paper/3dgut/sorted_nerf_synthetic (sorted 3DGUT: degree 2,
min_transmittance 1e-4, W = 16), read from the sorted gradient fixture,
whose settings tests/test_torch_grt.py holds to the YAML.

13. sorted kernel B vs plain - raster_fwd on the phase-3 view and pairs
   with both sorted settings: the tolerances of phase 4; then 3DGRT
   serving, 8 views at 800x800 through make_serving_renderer (ms/frame).
14. sorted kernel C vs plain - raster_bwd at both settings against the
   float64 autograd plain version: cosine >= 0.9999 and relative L2
   <= 1e-3 per field group, and two runs bitwise equal.
15. kernel E vs plain - wmax (the blend-weight telemetry) on the same
   view, global-Z and both sorted settings: max |diff| <= 1e-6, two runs
   bitwise equal.
16. sorted gradients vs JAX - render_gut's gradients with both sorted
   settings against tests/fixtures/torch_port_grt_grad_small.npz:
   max-normalised error <= 2e-3 and cosine >= 0.9999.
17. 3DGRT and sorted-3DGUT train steps - phase 11's step with each sorted
   setting: 20 timed steps in which kernels A-D launch 20 times each (B
   and C in the sorted mode) and E never; ms/step; 5 traced steps:
   device busy, idle share and device kernels per step.
18. 3DGRT trainer - phase 12's run with the 3DGRT settings and weight
   pruning on (telemetry every 10 steps from step 100, a prune at 150):
   >= 2 dB, the weight prune drops particles, kernel E launched.

Then a JSON line with each kernel's launches (A-D from phase 11, sorted
B and C of each setting from phase 17, E from phase 18), error and times
(phases 3, 4, 8, 9, 13-15), the card's name and power limit, and the last
line
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
TRAIN_STEPS = 20
REPO = os.path.dirname(os.path.abspath(__file__))
PARAM_NAMES = ("positions", "rotation", "scale", "density",
               "features_albedo", "features_specular")
# kernel libraries built from csrc/
LIBS = ("bin_decode", "raster_fwd", "raster_bwd", "fold", "wmax")
# reported kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "bin_decode": ("threedgrut_tpu_torch/csrc/bin_decode.cu",
                   "threedgrut_tpu/ops/pallas/expand.py:86"),
    "raster_fwd": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                   "threedgrut_tpu/ops/pallas/raster.py:1147"),
    "raster_bwd": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                   "threedgrut_tpu/ops/pallas/raster.py:1981"),
    "fold": ("threedgrut_tpu_torch/csrc/fold.cu",
             "threedgrut_tpu/ops/pallas/fold.py:76"),
    # kernel B in the sorted mode, 3DGRT (W = 16, degree 4):
    # bitonic_sort_by_key and bitonic_replay_unsort in the forward strip
    # kernel
    "raster_fwd_sorted": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                          "threedgrut_tpu/ops/pallas/raster.py:686"),
    # kernel C in the sorted mode, 3DGRT: _bwd_chunk_fast_sorted
    "raster_bwd_sorted": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                          "threedgrut_tpu/ops/pallas/raster.py:1814"),
    # the same in the sorted 3DGUT setting (W = 16, degree 2)
    "raster_fwd_sorted_3dgut": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                                "threedgrut_tpu/ops/pallas/raster.py:686"),
    "raster_bwd_sorted_3dgut": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                                "threedgrut_tpu/ops/pallas/raster.py:1814"),
    "wmax": ("threedgrut_tpu_torch/csrc/wmax.cu",
             "threedgrut_tpu/ops/pallas/raster.py:2199"),
}


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


def fixture_scene(f, dev):
    """(model, camera) of a JAX parity fixture (tests/fixtures)."""
    from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                       GaussianModelConfig)
    from threedgrut_tpu_torch.ops.cameras import make_pinhole

    cfg = GaussianModelConfig(
        density_activation=str(f["density_activation"]),
        scale_activation=str(f["scale_activation"]),
        max_sh_degree=int(f["n_active_features"]))
    model = GaussianModel.from_numpy(
        {k: f[f"params/{k}"] for k in PARAM_NAMES},
        int(f["n_active"]), int(f["n_active_features"]), cfg, dev)
    cam = make_pinhole(tuple(int(x) for x in f["resolution"]), f["focal"],
                       f["principal"], t=f["t"], q=f["q"], device=dev)
    return model, cam


def fixture_loss(out):
    """The loss of tests/test_render_parity.py:49-61 (zero target)."""
    return (out["pred_features"].square().mean()
            + 0.1 * out["pred_opacity"].mean()
            + 0.01 * out["pred_dist"].mean())


def trainer_phase(dev, raster=None, prune_weight=False):
    """Phases 12 and 18: a Trainer from 100k random Gaussians on 8 teacher
    views at 800x800 (white background), 260 steps with the GS events
    moved early: densify and prune at steps 100 and 200, a density reset
    at 250; with ``prune_weight``, blend-weight telemetry every 10 steps
    after step 100 and a weight prune at 150. ``raster`` is the student's
    RasterConfig (default: 3DGUT). Returns the launches of kernel E."""
    from threedgrut_tpu_torch.models.background import BackgroundConfig
    from threedgrut_tpu_torch.ops.cuda.wmax import pair_weight_max
    from threedgrut_tpu_torch.models.gaussians import (
        GaussianModelConfig, default_capacity_for, random_initialization)
    from threedgrut_tpu_torch.synthetic import build_teacher, teacher_dataset
    from threedgrut_tpu_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    ds = teacher_dataset(build_teacher(60000, seed=0, device=dev),
                         n_views=8, side=SIDE)
    extent = ds.get_scene_extent()

    def fresh_model():
        return random_initialization(
            GaussianModelConfig(), 100_000, extent=extent, seed=42,
            capacity=default_capacity_for(100_000, headroom=4.0),
            device=dev)

    conf = TrainerConfig(background=BackgroundConfig(color="white"))
    if raster is not None:
        conf.raster = raster
    conf.gs = conf.gs.replace(
        densify_start=50, densify_frequency=100, densify_end=210,
        prune_start=50, prune_frequency=100, prune_end=210,
        reset_density_start=240, reset_density_frequency=250,
        reset_density_end=260)
    if prune_weight:
        conf.gs = conf.gs.replace(
            prune_weight_start=100, prune_weight_frequency=50,
            prune_weight_end=160, weight_telemetry_frequency=10,
            prune_weight_threshold=0.01)
    trainer = Trainer(conf, ds, fresh_model())
    pair_weight_max.launches = 0
    n0 = trainer.model.n_active
    hist = trainer.run_training(250)
    dens = trainer.model.get_density()[:trainer.model.n_active]
    reset_ok = bool((dens <= conf.gs.new_max_density).all())
    hist += trainer.run_training(260)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    e_launches = pair_weight_max.launches
    events = trainer.event_stats
    densified = [st for _, kind, st in events if kind == "densify"]
    grown = sum(st["n_cloned"] + st["n_split"] for st in densified)
    counts = [n0] + [st["n"] for _, _, st in events]
    early = float(np.mean([h["psnr"] for h in hist[0:20]]))
    late = float(np.mean([h["psnr"] for h in hist[229:249]]))
    ckpt = os.path.join(REPO, "build", "smoke_trainer_ckpt.npz")
    trainer.save_checkpoint(ckpt)
    frame = ds[0]
    loss_a = trainer.train_iteration(frame, frame_idx=0)["total"]
    again = Trainer(conf, ds, fresh_model())
    again.load_checkpoint(ckpt)
    loss_b = again.train_iteration(frame, frame_idx=0)["total"]
    os.remove(ckpt)
    checks = {
        "densify grew": len(densified) == 2 and grown > 0,
        "n_active changed": len(set(counts)) > 1,
        "psnr +2 dB": late >= early + 2.0,
        "reset clamps density": reset_ok,
        "checkpoint round trip": abs(loss_a - loss_b) <= 1e-6,
        "finite": all(np.isfinite(h["total"]) for h in hist),
    }
    if prune_weight:
        wpruned = [st for _, kind, st in events if kind == "weight-pruned"]
        checks["weight prune dropped particles"] = (
            len(wpruned) == 1 and wpruned[0]["n_pruned"] > 0)
        checks["kernel E launched"] = e_launches > 0
    summary = (f"{len(hist)} steps in {train_s:.1f} s; kernel E launches "
               f"{e_launches}; events "
               + "; ".join(f"[{s_}] {k} " + " ".join(
                   f"{a}={b}" for a, b in st.items())
                   for s_, k, st in events)
               + f"; psnr steps 1-20 {early:.2f} dB, 230-249 {late:.2f} dB;"
               f" resumed loss |d| {abs(loss_a - loss_b):.3g}")
    failed = [k for k, ok in checks.items() if not ok]
    name = "3DGRT trainer" if prune_weight else "trainer"
    if failed:
        raise AssertionError(f"{name}: {failed} ({summary})")
    phase(name, summary)
    return e_launches


def grad_agreement(got, ref):
    """(cosine, relative L2) per record field group of per-pair
    gradients."""
    stats = {}
    for nm, sl in (("a", slice(0, 3)), ("M", slice(3, 12)),
                   ("density", slice(12, 13)), ("rgb", slice(13, 16))):
        x = got[:, sl].double().flatten()
        y = ref[:, sl].double().flatten()
        cos = float(x @ y / (x.norm() * y.norm()).clamp(min=1e-300))
        rel = float((x - y).norm() / y.norm().clamp(min=1e-300))
        stats[nm] = (cos, rel)
    return stats


GRT_GRAD_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                                "torch_port_grt_grad_small.npz")
# label -> (fixture mode, report-name suffix) of the two sorted settings
SORTED = {"3DGRT": ("grt", ""), "sorted 3DGUT": ("sorted3dgut", "_3dgut")}


def sorted_settings():
    """{label: RasterConfig} of the two sorted settings, as the gradient
    fixture records them (tests/test_torch_grt.py holds them to
    train_torch.py's composition of the two configs)."""
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.grt import grt_raster_config

    with np.load(GRT_GRAD_FIXTURE) as f:
        out = {label: RasterConfig(**{
            k: f[f"{mode}/raster/{k}"].item() for k in (
                "kernel_degree", "min_transmittance", "sorted_compositing",
                "sort_window")}) for label, (mode, _) in SORTED.items()}
    if out["3DGRT"] != grt_raster_config():
        raise AssertionError(f"fixture's 3DGRT settings {out['3DGRT']} are "
                             "not grt_raster_config()")
    return out


def sorted_kernel_phases(dev, b_args, fwd, c_args, v, model, ut_cfg):
    """Phases 13-15: kernels B and C in the sorted mode and kernel E
    against their plain versions on the phase-3 view, and 3DGRT serving.
    Returns the report entries of the sorted kernels B and C of each
    setting and of wmax."""
    from threedgrut_tpu_torch.ops.cameras import orbit_camera
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles_backward, rasterize_tiles_backward_plain,
        rasterize_tiles_forward, rasterize_tiles_plain)
    from threedgrut_tpu_torch.ops.cuda.wmax import (pair_weight_max,
                                                    pair_weight_max_plain)
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.grt import grt_raster_config
    from threedgrut_tpu_torch.render.serve import make_serving_renderer
    from threedgrut_tpu_torch.synthetic import orbit_geometry

    settings = sorted_settings()
    report = {}
    # 13. sorted kernel B
    msgs = []
    for label, rc in settings.items():
        args = b_args[:6] + (rc,)
        with torch.no_grad():
            got = rasterize_tiles_forward(*args)
            ref = rasterize_tiles_plain(*args)
            torch.cuda.synchronize()
            err_f = float((got[0] - ref[0]).abs().max())
            err_o = float((got[1] - ref[1]).abs().max())
            err_t = float((got[4] - ref[4]).abs().max())
            err_d = float(((got[2] - ref[2]).abs()
                           / ref[2].abs().clamp(min=1e-3)).max())
            flips = float((got[3] != ref[3]).float().mean())
            # how far the windows move the image from global-Z order
            moved = float((got[0] - rasterize_tiles_forward(
                *b_args[:6], rc.replace(sorted_compositing=False))[0]
                           ).abs().max())
            ms = cuda_ms(lambda: rasterize_tiles_forward(*args), 20)
            plain_ms = cuda_ms(lambda: rasterize_tiles_plain(*args), 2)
        if not (err_f <= 1e-4 and err_o <= 1e-4 and err_t <= 1e-4
                and err_d <= 1e-3 and flips < 0.01):
            raise AssertionError(
                f"sorted kernel B ({label}) vs plain: features {err_f:.3g},"
                f" opacity {err_o:.3g}, T_final {err_t:.3g}, depth rel "
                f"{err_d:.3g}, hits flip {flips:.4f}")
        report["raster_fwd_sorted" + SORTED[label][1]] = dict(
            max_abs_err=max(err_f, err_o, err_t), ms=ms, plain_ms=plain_ms)
        msgs.append(f"{label} (degree {rc.kernel_degree}, W "
                    f"{rc.sort_window}): features |d| {err_f:.3g}, opacity |d| "
                    f"{err_o:.3g}, T_final |d| {err_t:.3g}, depth rel "
                    f"{err_d:.3g}, hits flip {flips:.5f} (sorted vs "
                    f"global-Z features |d| {moved:.3g}); kernel {ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms")
    phase("sorted kernel B", "; ".join(msgs))

    # 3DGRT serving: 8 orbit views through make_serving_renderer
    center, dist = orbit_geometry(model)
    cams = [orbit_camera(az, 0.35, dist, center=center,
                         resolution=(SIDE, SIDE), device=dev)
            for az in np.linspace(0.0, 2 * math.pi, N_VIEWS, endpoint=False)]
    serve = make_serving_renderer(model, grt_raster_config(), sh_degree=3,
                                  ut_cfg=ut_cfg)
    serve(cams)
    per_batch = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = serve(cams)
        torch.cuda.synchronize()
        per_batch.append((time.perf_counter() - t0) * 1e3 / N_VIEWS)
    if not bool(torch.isfinite(imgs).all()):
        raise AssertionError("3DGRT serving output has non-finite values")
    phase("3DGRT serving", f"{N_VIEWS} views {SIDE}x{SIDE}, 100k, SH 3: "
          f"median {float(np.median(per_batch)):.3f} ms/frame host clock "
          f"over 3 batches ({', '.join(f'{x:.3f}' for x in per_batch)})")

    # 14. sorted kernel C, and bitwise repeatability
    msgs = []
    for label, rc in settings.items():
        with torch.no_grad():
            sfwd = rasterize_tiles_forward(*b_args[:6], rc)
            args = c_args[:6] + (sfwd[0], sfwd[2], sfwd[4]) + c_args[9:12] \
                + (rc,)
            d1 = rasterize_tiles_backward(*args)
            d2 = rasterize_tiles_backward(*args)
            d_ref = rasterize_tiles_backward_plain(*args)
            torch.cuda.synchronize()
            stats = grad_agreement(d1, d_ref)
            same = bool(torch.equal(d1, d2))
            err = float((d1 - d_ref).abs().max())
            ms = cuda_ms(lambda: rasterize_tiles_backward(*args), 10)
            plain_ms = cuda_ms(lambda: rasterize_tiles_backward_plain(*args),
                               1)
        bad = {k: x for k, x in stats.items()
               if not (x[0] >= 0.9999 and x[1] <= 1e-3)}
        if bad or not same:
            raise AssertionError(f"sorted kernel C ({label}) vs plain "
                                 f"(cosine, rel L2): {bad}; bitwise "
                                 f"repeatable {same}")
        report["raster_bwd_sorted" + SORTED[label][1]] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms)
        msgs.append(f"{label}: " + ", ".join(
            f"{k} cos {x[0]:.8f} relL2 {x[1]:.3g}" for k, x in stats.items())
            + f"; max |d| {err:.3g}; two runs bitwise equal; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    phase("sorted kernel C", "; ".join(msgs))

    # 15. kernel E
    msgs = []
    for label, rc in (("global-Z", RasterConfig()), *settings.items()):
        args = b_args[:6] + (rc,)
        with torch.no_grad():
            w1 = pair_weight_max(*args)
            w2 = pair_weight_max(*args)
            w_ref = pair_weight_max_plain(*args)
            torch.cuda.synchronize()
            err = float((w1 - w_ref).abs().max())
            same = bool(torch.equal(w1, w2))
            live = float((w1 > 0).float().mean())
            ms = cuda_ms(lambda: pair_weight_max(*args), 20)
            plain_ms = cuda_ms(lambda: pair_weight_max_plain(*args), 2)
        if not (err <= 1e-6 and same):
            raise AssertionError(f"kernel E ({label}) vs plain: max |d| "
                                 f"{err:.3g}; bitwise repeatable {same}")
        if label == "3DGRT":
            report["wmax"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        msgs.append(f"{label}: max |d| {err:.3g}, two runs bitwise equal, "
                    f"{live:.3f} of the pairs weighted; kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms")
    phase("kernel E", "; ".join(msgs))
    return report


def grt_grad_phase(dev, ut_cfg):
    """Phase 16: the sorted render's gradients against the JAX fixture."""
    from threedgrut_tpu_torch.render.gut import render_gut

    fx = GRT_GRAD_FIXTURE
    msgs = []
    with np.load(fx) as f:
        for label, rc in sorted_settings().items():
            mode = SORTED[label][0]
            gmodel, gcam = fixture_scene(f, dev)
            out = render_gut(gcam, ut_cfg, rc, gmodel, int(f["sh_degree"]))
            fixture_loss(out).backward()
            errs = {}
            for k in PARAM_NAMES:
                got_g = getattr(gmodel, k).grad.double().cpu().numpy()
                ref_g = f[f"{mode}/grad/{k}"].astype(np.float64)
                scale = np.abs(ref_g).max() + 1e-12
                cos = float((got_g * ref_g).sum() / max(
                    np.linalg.norm(got_g) * np.linalg.norm(ref_g), 1e-300))
                errs[k] = (float(np.abs(got_g - ref_g).max() / scale), cos)
            bad = {k: x for k, x in errs.items()
                   if not (x[0] <= 2e-3 and x[1] >= 0.9999)}
            if bad:
                raise AssertionError(f"sorted gradients vs JAX ({mode}; "
                                     f"max-normalised error, cosine): {bad}")
            msgs.append(f"{mode} (W {rc.sort_window}, degree "
                        f"{rc.kernel_degree}): " + ", ".join(
                            f"{k} {x[0]:.2g}/{x[1]:.7f}"
                            for k, x in errs.items()))
    phase("sorted grad vs JAX", f"fixture {os.path.basename(fx)}: "
          + "; ".join(msgs))


def sorted_train_step_phase(dev, label, rc):
    """Phase 17: the bench train step with one sorted setting. Returns the
    sorted kernels' launches under their report names."""
    from bench_train_torch import BenchStep, profile_steps, time_steps
    from threedgrut_tpu_torch.ops.cuda.expand import expand_decode_pairs
    from threedgrut_tpu_torch.ops.cuda.fold import fold_pairs
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles, rasterize_tiles_backward)
    from threedgrut_tpu_torch.ops.cuda.wmax import pair_weight_max

    suffix = SORTED[label][1]
    step = BenchStep(dev, rc)
    time_steps(step, 3)                       # warm-up
    counters = {"bin_decode": expand_decode_pairs,
                "raster_fwd_sorted" + suffix: rasterize_tiles,
                "raster_bwd_sorted" + suffix: rasterize_tiles_backward,
                "fold": fold_pairs, "wmax": pair_weight_max}
    for fn in counters.values():
        fn.launches = 0
    step_ms, losses = time_steps(step, TRAIN_STEPS)
    launches = {k: fn.launches for k, fn in counters.items()}
    want = dict.fromkeys(counters, TRAIN_STEPS)
    want["wmax"] = 0
    if launches != want:
        raise AssertionError(f"{label} train-step launches {launches}, "
                             f"expected {want}")
    if not all(bool(torch.isfinite(x)) for x in losses):
        raise AssertionError(f"{label} train-step loss not finite")
    for k, p in step.params.items():
        if not (bool(torch.isfinite(p.grad).all())
                and float(p.grad.abs().max()) > 0.0):
            raise AssertionError(f"{label} train-step gradient of {k} is "
                                 "not finite and non-zero")
    wall_us, busy_us, n_device = profile_steps(step, 5, top=12)
    phase(f"{label} train step", f"100k Gaussians, {SIDE}x{SIDE}, SH 3, "
          f"L1+DSSIM, Adam, degree {rc.kernel_degree}, W {rc.sort_window}: "
          f"{step_ms:.3f} ms/step ({1e3 / step_ms:.2f} it/s) host clock over "
          f"{TRAIN_STEPS} steps; loss {float(losses[0]):.5f} -> "
          f"{float(losses[-1]):.5f}; launches {launches}; 5 traced steps: "
          f"wall {wall_us:.1f} us/step, device busy {busy_us:.1f} us/step, "
          f"idle share {1.0 - busy_us / wall_us:.3f}, {n_device:.1f} device "
          f"kernels per step")
    return {k: launches[k] for k in counters if k.startswith("raster")}


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
    from threedgrut_tpu_torch.ops.cuda.fold import (fold_pairs,
                                                    fold_pairs_plain)
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles, rasterize_tiles_backward,
        rasterize_tiles_backward_plain, rasterize_tiles_forward,
        rasterize_tiles_plain)
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                       GaussianModelConfig)
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.grt import grt_raster_config
    from threedgrut_tpu_torch.render.gut import prepare_view, render_gut
    from threedgrut_tpu_torch.render.oracle import parity_db, render_oracle
    from threedgrut_tpu_torch.render.serve import make_serving_renderer
    from threedgrut_tpu_torch.synthetic import bench_cloud, orbit_geometry

    # 2. build: one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    build.load_all(list(LIBS), verbose=True)
    phase("build", f"{' + '.join(LIBS)} for sm_90a in "
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
        got = rasterize_tiles_forward(*b_args)
        ref = rasterize_tiles_plain(*b_args)
        torch.cuda.synchronize()
        err_f = float((got[0] - ref[0]).abs().max())
        err_o = float((got[1] - ref[1]).abs().max())
        err_t = float((got[4] - ref[4]).abs().max())
        err_d = float(((got[2] - ref[2]).abs()
                       / ref[2].abs().clamp(min=1e-3)).max())
        flips = float((got[3] != ref[3]).float().mean())
        b_ms = cuda_ms(lambda: rasterize_tiles_forward(*b_args), 20)
        b_plain_ms = cuda_ms(lambda: rasterize_tiles_plain(*b_args), 3)
    if not (err_f <= 1e-4 and err_o <= 1e-4 and err_t <= 1e-4
            and err_d <= 1e-3 and flips < 0.01):
        raise AssertionError(
            f"kernel B vs plain: features {err_f:.3g}, opacity {err_o:.3g},"
            f" T_final {err_t:.3g}, depth rel {err_d:.3g}, "
            f"hits flip {flips:.4f}")
    report["raster_fwd"] = dict(max_abs_err=max(err_f, err_o, err_t),
                                ms=b_ms, plain_ms=b_plain_ms)
    phase("kernel B", f"features |d| {err_f:.3g}, opacity |d| {err_o:.3g}, "
          f"T_final |d| {err_t:.3g}, depth rel {err_d:.3g}, "
          f"hits flip {flips:.5f}; "
          f"kernel {b_ms:.4f} ms, plain {b_plain_ms:.4f} ms")
    fwd = got

    # 5. against the JAX package's values
    fx = os.path.join(REPO, "tests", "fixtures", "torch_port_gut_small.npz")
    with np.load(fx) as f:
        small, small_cam = fixture_scene(f, dev)
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

    # 8. kernel C vs plain: seeded upstream gradients on the same view
    rng = np.random.default_rng(7)
    g_feat, g_opac, g_dep = (
        torch.tensor(rng.normal(size=(SIDE, SIDE, c)).astype(np.float32),
                     device=dev) for c in (3, 1, 1))
    c_args = b_args[:6] + (fwd[0], fwd[2], fwd[4], g_feat, g_opac, g_dep,
                           rc)
    with torch.no_grad():
        d_rec = rasterize_tiles_backward(*c_args)
        d_ref = rasterize_tiles_backward_plain(*c_args)
        torch.cuda.synchronize()
        c_stats = {}
        for nm, sl in (("a", slice(0, 3)), ("M", slice(3, 12)),
                       ("density", slice(12, 13)), ("rgb", slice(13, 16))):
            x = d_rec[:, sl].double().flatten()
            y = d_ref[:, sl].double().flatten()
            cos = float(x @ y / (x.norm() * y.norm()).clamp(min=1e-300))
            rel = float((x - y).norm() / y.norm().clamp(min=1e-300))
            c_stats[nm] = (cos, rel)
        c_err = float((d_rec - d_ref).abs().max())
        c_ms = cuda_ms(lambda: rasterize_tiles_backward(*c_args), 10)
        c_plain_ms = cuda_ms(lambda: rasterize_tiles_backward_plain(*c_args),
                             1)
    bad = {k: v for k, v in c_stats.items()
           if not (v[0] >= 0.9999 and v[1] <= 1e-3)}
    if bad:
        raise AssertionError(f"kernel C vs plain (cosine, rel L2): {bad}")
    report["raster_bwd"] = dict(max_abs_err=c_err, ms=c_ms,
                                plain_ms=c_plain_ms)
    phase("kernel C", ", ".join(f"{k} cos {v[0]:.8f} relL2 {v[1]:.3g}"
                                for k, v in c_stats.items())
          + f"; max |d| {c_err:.3g}; kernel {c_ms:.4f} ms, "
          f"plain {c_plain_ms:.4f} ms")

    # 9. kernel D vs plain, and bitwise determinism
    vb = v.binning
    d_args = (d_rec, vb.perm, vb.order, vb.excl, vb.counts, vb.limit,
              model.capacity)
    with torch.no_grad():
        d1 = fold_pairs(*d_args)
        d2 = fold_pairs(*d_args)
        d_ref = fold_pairs_plain(*d_args)
        torch.cuda.synchronize()
        d_err = float((d1 - d_ref).abs().max())
        d_scale = float(d_ref.abs().max())
        same = bool(torch.equal(d1, d2))
        d_ms = cuda_ms(lambda: fold_pairs(*d_args), 20)
        d_plain_ms = cuda_ms(lambda: fold_pairs_plain(*d_args), 5)
    if not (d_err <= 1e-5 * d_scale and same):
        raise AssertionError(f"kernel D vs plain: max |d| {d_err:.3g} "
                             f"(max |ref| {d_scale:.3g}); bitwise "
                             f"deterministic {same}")
    report["fold"] = dict(max_abs_err=d_err, ms=d_ms, plain_ms=d_plain_ms)
    phase("kernel D", f"max |d| {d_err:.3g} of max |ref| {d_scale:.3g}; "
          f"two runs bitwise equal; kernel {d_ms:.4f} ms, "
          f"plain {d_plain_ms:.4f} ms")

    # 10. render gradients against the JAX package's
    grad_fx = os.path.join(REPO, "tests", "fixtures",
                           "torch_port_grad_small.npz")
    with np.load(grad_fx) as f:
        gmodel, gcam = fixture_scene(f, dev)
        out = render_gut(gcam, ut_cfg, rc, gmodel, int(f["sh_degree"]))
        fixture_loss(out).backward()
        g_errs = {}
        for k in PARAM_NAMES:
            got_g = getattr(gmodel, k).grad.double().cpu().numpy()
            ref_g = f[f"grad/{k}"].astype(np.float64)
            scale = np.abs(ref_g).max() + 1e-12
            cos = float((got_g * ref_g).sum() / max(
                np.linalg.norm(got_g) * np.linalg.norm(ref_g), 1e-300))
            g_errs[k] = (float(np.abs(got_g - ref_g).max() / scale), cos)
    bad = {k: v for k, v in g_errs.items()
           if not (v[0] <= 2e-3 and v[1] >= 0.9999)}
    if bad:
        raise AssertionError(f"gradients vs JAX (max-normalised error, "
                             f"cosine): {bad}")
    phase("grad vs JAX", f"fixture {os.path.basename(grad_fx)}: " + ", ".join(
        f"{k} {v[0]:.2g}/{v[1]:.7f}" for k, v in g_errs.items()))

    # 11. train step: bench.py's step at 100k / 800x800 / SH 3
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from bench_train_torch import BenchStep, time_steps

    step = BenchStep(dev)
    time_steps(step, 3)                       # warm-up
    counters = (expand_decode_pairs, rasterize_tiles,
                rasterize_tiles_backward, fold_pairs)
    for fn in counters:
        fn.launches = 0
    step_ms, losses = time_steps(step, TRAIN_STEPS)
    launches = dict(zip(("bin_decode", "raster_fwd", "raster_bwd", "fold"),
                        (fn.launches for fn in counters)))
    if any(n != TRAIN_STEPS for n in launches.values()):
        raise AssertionError(f"train-step launches {launches}, expected "
                             f"{TRAIN_STEPS} each")
    if not all(bool(torch.isfinite(x)) for x in losses):
        raise AssertionError("train-step loss not finite")
    for k, p in step.params.items():
        if not (bool(torch.isfinite(p.grad).all())
                and float(p.grad.abs().max()) > 0.0):
            raise AssertionError(f"train-step gradient of {k} is not "
                                 "finite and non-zero")
    phase("train step", f"100k Gaussians, {SIDE}x{SIDE}, SH 3, L1+DSSIM, "
          f"Adam: {step_ms:.3f} ms/step ({1e3 / step_ms:.2f} it/s) host "
          f"clock over {TRAIN_STEPS} steps; loss {float(losses[0]):.5f} -> "
          f"{float(losses[-1]):.5f}; launches {launches}")
    del step

    # 12. trainer: GS densify / prune / reset on teacher views
    trainer_phase(dev)

    # 13-18. the 3DGRT and sorted-3DGUT path
    report.update(sorted_kernel_phases(dev, b_args, fwd, c_args, v, model,
                                       ut_cfg))
    grt_grad_phase(dev, ut_cfg)
    for label, src in sorted_settings().items():
        launches.update(sorted_train_step_phase(dev, label, src))
    launches["wmax"] = trainer_phase(dev, grt_raster_config(),
                                     prune_weight=True)

    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches.get(k, 0), **report[k])
               for k, (src, rep) in KERNELS.items()]
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
