#!/usr/bin/env python3
"""Time this checkout's port beside another checkout's on one NVIDIA GPU.

    python scripts/compare_tree_torch.py --other <dir> [--rounds 2]
        [--groups trace,playground,guard800,layout]

``--other`` is another checkout of the repository, e.g. an earlier
commit unpacked with ``git archive <commit> | tar -x -C build/other``.
Each round runs the two trees in turns (other, this, this, other), each
in a process of its own that imports that tree's ``threedgrut_tpu_torch``
and builds its kernels into that tree's ``build/``, and measures on the
same card, with the inputs and timers of this checkout's chip_smoke.py.
The groups (``--groups``, all by default; a run of the groups a change
touches saves the minutes of the slow ones, such as ``nht_step``):

- ``trace``: kernels B and C in trace()'s windows of 128 on phase 31's
  (brute force over 8,192 slots, kernel 7) and phase 33's (the grid at
  100k) inputs, by CUDA events and by device time (torch.profiler), and a
  SHA-256 of B's five outputs; one differentiated ``trace`` call
  (forward, then the backward of chip_smoke.py:fixture_loss) on each,
  host ms (synchronised) and device ms;
- ``playground``: phase 36's frame (100k, glass icosphere and mirror
  box, 512x512, 3 bounces): host ms over 3 frames, then device busy and
  idle share over 2 traced frames;
- ``guard800``: kernels B and C at 800x800 on the 100k bench view in the
  3DGUT and the 3DGRT setting (phases 4, 8 and 13-14's inputs), and
  kernels D (on C's output) and E there (phases 9 and 15): CUDA events
  and a SHA-256 of B's five outputs, of C's, D's and E's;
- ``nht_c``: kernel C's NHT mode at 800x800 on the 100k NHT cloud (48
  features), degree 2 and 4, on phase 27's inputs (CUDA events);
- ``f``: kernel F with its set-up on the 800x800 bench view's 691,175
  pair rows x 16 (phase 37's inputs): with its set-up, the set-up alone
  and the kernel alone (CUDA events), and with its set-up by device time
  (torch.profiler), beside ``index_add_`` by both, and a SHA-256 of its
  output;
- ``nht_step``: the NHT + MCMC train step of both NHT configs
  (scripts/bench_train_torch.py's step: host ms over 20 steps, then
  device busy and idle share over 5 traced steps);
- ``table_route``: the table route's raster forward and backward at
  800x800 (``rasterize_tiles_table``: B, C, F; the same);
- ``rgb_c``: kernel C's RGB modes on the inputs of chip_smoke.py phases
  8 (3DGUT, 800x800, degree 2), 14 (3DGRT, degree 4, and sorted 3DGUT,
  degree 2, both W 16, on phase 3's pairs) and 20 (the 1920x1280 rolling
  shutter, general mode, 3DGUT and 3DGRT), and trace()'s brute force in
  rank order (the general W 0 shared-segment mode, phase 31's rays):
  CUDA events, a SHA-256 of each output, and after the run its relative
  L2 against the other tree's output per field group (a or p, M,
  density, rgb);
- ``nht_b``: kernel B's NHT mode at 800x800 on the 100k NHT cloud,
  degree 2 and 4 (phase 26's inputs): CUDA events, a SHA-256 of
  opacity, depth, hits and T_final, and after the run the 24 features'
  max |d| against the other tree's;
- ``gs_steps``: the 3DGUT and 3DGRT train steps at 800x800 and the
  3DGUT step through the 1920x1280 rolling shutter (as ``nht_step``);
- ``rgb_b``: kernels B and E in their eight RGB modes (degree 2 and 4,
  W 0 and 16, shared origin and general) on the inputs of chip_smoke.py
  phases 4 and 13-15 (the 800x800 bench view: 3DGUT, 3DGRT and sorted
  3DGUT, and degree 4 at W 0) and 19 and 21 (the 1920x1280 rolling
  shutter: the same four settings in the general mode): CUDA events,
  device time, and a SHA-256 of B's five outputs and of E's ``wpair``;
- ``binning_fold``: kernel A on phase 3's slots (its two outputs and the
  sort's tile_start hashed) and kernel D in every mode as that tree's
  backward calls it, with its wrapper's set-up (the inverse of the tile
  sort; the parent's ``repeat_fold`` of kernel 7's segment): 16 wide on
  the 800x800 3DGUT and 3DGRT views (phases 9 and 14), the 1920x1280
  rolling 3DGUT view (phase 20), 64 wide on the NHT view (phase 27),
  kernel 7's 8.4M per-block rows (phase 32) and the grid trace's rows
  (phase 33): CUDA events, device time and a SHA-256 of each output, and
  after the run each output's max |d| against the other tree's;
- ``layout``: kernel G at both of chip_smoke.py phase 39's shapes (the
  pair expansion, 100k rows x 16, and the tile expansion, 2,500 x 3, onto
  the 800x800 bench view's 691,175 slots) and kernel H's two calls on
  phase 40's inputs (``forward_fill`` at 2^20 x 12 with 100k marks, and
  ``segmented_fill_rows`` of 100k rows): CUDA events, device time in all
  and by kernel (which parts the negative-slot check's reduction and
  read-back from the fill), and a SHA-256 of each output.

``rgb_c``, ``nht_b`` and ``binning_fold`` leave each tree's outputs in
``--out`` (default ``build/compare`` of this checkout) for the
comparison across trees.

Prints one line per tree and turn and a JSON line of all of them, with
the card's ``nvidia-smi`` name and power limit. Needs a CUDA device.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NHT_CONFIGS = ("apps/nerf_synthetic_3dgut_mcmc_nht",
               "apps/nerf_synthetic_3dgrt_mcmc_nht")
# measurement groups, in the order a run takes them (GROUP_FNS below)
GROUPS = ("trace", "playground", "guard800", "nht_c", "f", "nht_step",
          "table_route", "rgb_c", "nht_b", "gs_steps", "rgb_b",
          "binning_fold", "layout")
# kernel C's record field groups (a or p, M, density, rgb)
FIELD_GROUPS = {"a": slice(0, 3), "M": slice(3, 12), "density": slice(12, 13),
                "rgb": slice(13, 16)}


def smoke():
    """This checkout's chip_smoke.py as a module (its input builders and
    timers), whichever tree's package the process imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sha256(*tensors):
    """SHA-256 of the tensors' bytes, one after another."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def trace_group(cs, dev, res):
    """trace's B and C on phases 31 and 33's inputs, and one differentiated
    trace call on each."""
    import numpy as np
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles_backward, rasterize_tiles_forward)
    from threedgrut_tpu_torch.render.grt import prepare_trace, trace
    from threedgrut_tpu_torch.synthetic import bench_cloud

    n_blocks = cs.TRACE_SIDE * cs.TRACE_SIDE // 256
    rng = np.random.default_rng(31)
    upstream = [torch.tensor(rng.normal(size=(16 * n_blocks, 16, c)).astype(
        np.float32), device=dev) for c in (3, 1, 1)]
    for label, n in (("kernel7", 8192), ("grid", 100_000)):
        model = bench_cloud(n, seed=0, device=dev)
        ro, rd = cs.trace_rays(model)
        with torch.no_grad():
            inp = prepare_trace(model, ro, rd)
            args = inp.args()
            out = rasterize_tiles_forward(*args)
            c_args = args[:6] + (out[0], out[2], out[4], *upstream, inp.cfg,
                                 inp.ray_o, inp.shared)
            r = dict(b_sha256=sha256(*out),
                     b_ms=cs.cuda_ms(lambda: rasterize_tiles_forward(*args),
                                     10),
                     b_device_ms=cs.device_ms(
                         lambda: rasterize_tiles_forward(*args), 10),
                     c_ms=cs.cuda_ms(
                         lambda: rasterize_tiles_backward(*c_args), 5),
                     c_device_ms=cs.device_ms(
                         lambda: rasterize_tiles_backward(*c_args), 5))
            del out, c_args

        def differentiated():
            for q in model.params().values():
                q.grad = None
            cs.fixture_loss(trace(model, ro, rd)).backward()

        r["trace_grad_host_ms"] = cs.host_ms(differentiated, 3)
        r["trace_grad_device_ms"] = cs.device_ms(differentiated, 3)
        res[f"trace_{label}"] = r
        del model, inp, args
        torch.cuda.empty_cache()


def playground_group(cs, dev, res):
    """Phase 36's playground frame: host ms, device busy, idle share."""
    import time

    import bench_train_torch as bt
    from playground_torch import build_engine
    from threedgrut_tpu_torch.ops.cameras import orbit_camera
    from threedgrut_tpu_torch.synthetic import bench_cloud, orbit_geometry

    model = bench_cloud(100_000, seed=0, device=dev)
    engine, center = build_engine(model, demo_primitives=True)
    _, dist = orbit_geometry(model)
    cam = orbit_camera(0.0, 0.35, dist, center=center,
                       resolution=(cs.TRACE_SIDE, cs.TRACE_SIDE), device=dev)
    engine.render(cam)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.render(cam)
        times.append((time.perf_counter() - t0) * 1e3)
    wall, busy, _ = bt.profile_steps(lambda: engine.render(cam), 2, top=0)
    res["playground"] = dict(ms=sum(times) / len(times), busy_us=busy,
                             idle=1.0 - busy / wall)
    del engine, model
    torch.cuda.empty_cache()


def guard800_group(cs, dev, res):
    """Kernels B and C at 800x800, 3DGUT and 3DGRT: times and hashes."""
    from threedgrut_tpu_torch.ops.cameras import make_pinhole
    from threedgrut_tpu_torch.ops.cuda.fold import fold_pairs
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles_backward, rasterize_tiles_forward)
    from threedgrut_tpu_torch.ops.cuda.wmax import pair_weight_max
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.grt import grt_raster_config
    from threedgrut_tpu_torch.synthetic import bench_cloud

    side = cs.SIDE
    cam = make_pinhole((side, side), (1.1 * side, 1.1 * side),
                       (side / 2, side / 2), device=dev)
    model = bench_cloud(100_000, seed=0, device=dev)
    up = cs.seeded_upstream(dev, side, side, (3, 1, 1), 7)
    for label, rc in (("3dgut", RasterConfig()),
                      ("3dgrt", grt_raster_config())):
        with torch.no_grad():
            v, b_args, fwd, c_args = cs.view_inputs(cam, UTConfig(), rc,
                                                    model, 3, up)
            d_rec = rasterize_tiles_backward(*c_args)
            vb = v.binning
            d_args = (d_rec, vb.perm, vb.order, vb.excl, vb.counts, vb.limit,
                      model.capacity)
            res[f"guard800_{label}"] = dict(
                b_sha256=sha256(*fwd), c_sha256=sha256(d_rec),
                d_sha256=sha256(fold_pairs(*d_args)),
                e_sha256=sha256(pair_weight_max(*b_args)),
                b_ms=cs.cuda_ms(lambda: rasterize_tiles_forward(*b_args), 20),
                c_ms=cs.cuda_ms(lambda: rasterize_tiles_backward(*c_args),
                                10),
                d_ms=cs.cuda_ms(lambda: fold_pairs(*d_args), 20),
                e_ms=cs.cuda_ms(lambda: pair_weight_max(*b_args), 20))


def nht_c_group(cs, dev, res):
    """Kernel C's NHT mode at both degrees."""
    from threedgrut_tpu_torch.ops.cameras import make_pinhole
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles_backward
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.synthetic import nht_cloud

    side = cs.SIDE
    cam = make_pinhole((side, side), (1.1 * side, 1.1 * side),
                       (side / 2, side / 2), device=dev)
    with torch.no_grad():
        model = nht_cloud(100_000, seed=0, device=dev)
        up = cs.seeded_upstream(dev, side, side, (24, 1, 1), 26)
        for rc in cs.nht_settings().values():
            c_args = cs.view_inputs(cam, UTConfig(), rc, model, 0, up)[3]
            res[f"nht_c_deg{rc.kernel_degree}_ms"] = cs.cuda_ms(
                lambda: rasterize_tiles_backward(*c_args), 10)


def bench_view(cs, dev):
    """The 800x800 3DGUT bench view and C's arguments (phases 3 and 8)."""
    from threedgrut_tpu_torch.ops.cameras import make_pinhole
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.synthetic import bench_cloud

    side = cs.SIDE
    cam = make_pinhole((side, side), (1.1 * side, 1.1 * side),
                       (side / 2, side / 2), device=dev)
    rc = RasterConfig()
    with torch.no_grad():
        v, _, _, c_args = cs.view_inputs(
            cam, UTConfig(), rc, bench_cloud(100_000, seed=0, device=dev), 3,
            cs.seeded_upstream(dev, side, side, (3, 1, 1), 7))
    return rc, v, c_args


def f_group(cs, dev, res):
    """Kernel F with its set-up beside index_add_."""
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles_backward
    from threedgrut_tpu_torch.ops.cuda.scatter import (
        id_runs, scatter_accumulate_rows, scatter_runs)

    _, v, c_args = bench_view(cs, dev)
    with torch.no_grad():
        d_rec = rasterize_tiles_backward(*c_args)
        ids, n_rows = v.binning.pair_particle, v.table.shape[0]
        runs = id_runs(ids, n_rows)
        idx = ids.to(torch.int64)

        def f():
            return scatter_accumulate_rows(d_rec, ids, n_rows)

        def library():
            return torch.zeros((n_rows, d_rec.shape[1]),
                               device=dev).index_add_(0, idx, d_rec)

        res["f_ms"] = cs.cuda_ms(f, 20)
        res["f_setup_ms"] = cs.cuda_ms(lambda: id_runs(ids, n_rows), 20)
        res["f_kernel_ms"] = cs.cuda_ms(lambda: scatter_runs(d_rec, *runs),
                                        20)
        res["index_add_ms"] = cs.cuda_ms(library, 20)
        res["f_device_ms"] = cs.device_ms(f, 20)
        res["index_add_device_ms"] = cs.device_ms(library, 20)
        # F's output, to hold the trees' equal bit for bit
        res["f_sha256"] = sha256(f())


def nht_step_group(cs, dev, res):
    """The NHT + MCMC train step of both NHT configs."""
    import bench_train_torch as bt

    for name in NHT_CONFIGS:
        step = bt.config_step(name, dev)
        bt.time_steps(step, 3)
        ms, _ = bt.time_steps(step, 20)
        wall, busy, _ = bt.profile_steps(step, 5, top=0)
        res[name] = dict(ms=ms, busy_us=busy, idle=1.0 - busy / wall)
        del step
        torch.cuda.empty_cache()


def table_route_group(cs, dev, res):
    """The table route's raster forward and backward at 800x800."""
    import bench_train_torch as bt
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles_table

    rc, v, c_args = bench_view(cs, dev)
    b = v.binning
    g_feat, g_opac, g_dep = c_args[9:12]

    def table_step():
        t = v.table.detach().clone().requires_grad_(True)
        out = rasterize_tiles_table(t, b.pair_particle, b.tile_start,
                                    v.ray_d, v.tmin, v.tmax, rc)
        ((out[0] * g_feat).sum() + (out[1] * g_opac).sum()
         + (out[2] * g_dep).sum()).backward()

    bt.time_steps(table_step, 3)
    ms, _ = bt.time_steps(table_step, 20)
    wall, busy, _ = bt.profile_steps(table_step, 5, top=0)
    res["table_route"] = dict(ms=ms, busy_us=busy, idle=1.0 - busy / wall)


def rgb_c_inputs(cs, dev):
    """Yield (label, C's arguments) of kernel C's RGB modes on chip_smoke.py
    phases 8, 14, 20 and 31's inputs (``rgb_c`` above)."""
    import numpy as np
    from threedgrut_tpu_torch.ops.cameras import make_pinhole
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles_forward
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.grt import prepare_trace
    from threedgrut_tpu_torch.render.gut import prepare_view
    from threedgrut_tpu_torch.synthetic import bench_camera, bench_cloud

    side, ut_cfg = cs.SIDE, UTConfig()
    cam = make_pinhole((side, side), (1.1 * side, 1.1 * side),
                       (side / 2, side / 2), device=dev)
    model = bench_cloud(100_000, seed=0, device=dev)
    with torch.no_grad():
        _, b_args, _, c_args = cs.view_inputs(
            cam, ut_cfg, RasterConfig(), model, 3,
            cs.seeded_upstream(dev, side, side, (3, 1, 1), 7))
        yield "3dgut", c_args
        for label, rc in cs.sorted_settings().items():
            sfwd = rasterize_tiles_forward(*b_args[:6], rc)
            yield (label.replace(" ", "").lower(), c_args[:6]
                   + (sfwd[0], sfwd[2], sfwd[4]) + c_args[9:12] + (rc,))
        del b_args, c_args, sfwd
        rcam = bench_camera("rolling", device=dev)
        w, h = rcam.resolution
        rng = np.random.default_rng(8)
        up = [torch.tensor(rng.normal(size=(h, w, c)).astype(np.float32),
                           device=dev) for c in (3, 1, 1)]
        for label, rc in cs.general_settings().items():
            v = prepare_view(rcam, ut_cfg, rc, model, 3)
            args = (v.table, v.binning.pair_particle, v.binning.tile_start,
                    v.ray_d, v.tmin, v.tmax, rc, v.ray_o)
            out = rasterize_tiles_forward(*args)
            yield (f"rolling{label.lower()}", args[:6]
                   + (out[0], out[2], out[4], *up, rc, v.ray_o))
            del v, args, out
        small = bench_cloud(8192, seed=0, device=dev)
        ro, rd = cs.trace_rays(small)
        inp = prepare_trace(small, ro, rd, accelerate=False, _sorted=False)
        args = inp.args()
        out = rasterize_tiles_forward(*args)
        n_blocks = cs.TRACE_SIDE * cs.TRACE_SIDE // 256
        rng = np.random.default_rng(31)
        up = [torch.tensor(rng.normal(size=(16 * n_blocks, 16, c)).astype(
            np.float32), device=dev) for c in (3, 1, 1)]
        yield "shared_w0", args[:6] + (out[0], out[2], out[4], *up, inp.cfg,
                                       inp.ray_o, inp.shared)


def rgb_c_group(cs, dev, res, out_dir):
    """Kernel C's RGB modes: times, hashes, and the outputs kept for the
    comparison across trees."""
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles_backward

    for label, c_args in rgb_c_inputs(cs, dev):
        with torch.no_grad():
            d = rasterize_tiles_backward(*c_args)
            torch.save(d.cpu(), os.path.join(
                out_dir, f"{res['tree']}_rgb_c_{label}.pt"))
            res[f"rgb_c_{label}"] = dict(
                sha256=sha256(d),
                ms=cs.cuda_ms(lambda: rasterize_tiles_backward(*c_args), 10))
            del d
        torch.cuda.empty_cache()


def nht_b_group(cs, dev, res, out_dir):
    """Kernel B's NHT mode at both degrees: times, hashes of opacity,
    depth, hits and T_final, and the features kept for the comparison
    across trees."""
    from threedgrut_tpu_torch.ops.cameras import make_pinhole
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles_forward
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.synthetic import nht_cloud

    side = cs.SIDE
    cam = make_pinhole((side, side), (1.1 * side, 1.1 * side),
                       (side / 2, side / 2), device=dev)
    with torch.no_grad():
        model = nht_cloud(100_000, seed=0, device=dev)
        up = cs.seeded_upstream(dev, side, side, (24, 1, 1), 26)
        for rc in cs.nht_settings().values():
            b_args, fwd = cs.view_inputs(cam, UTConfig(), rc, model, 0,
                                         up)[1:3]
            label = f"nht_b_deg{rc.kernel_degree}"
            torch.save(fwd[0].cpu(), os.path.join(
                out_dir, f"{res['tree']}_{label}.pt"))
            res[label] = dict(
                sha256=sha256(*fwd[1:]),
                ms=cs.cuda_ms(lambda: rasterize_tiles_forward(*b_args), 20))


def gs_steps_group(cs, dev, res):
    """The 3DGUT and 3DGRT train steps at 800x800 and the rolling 3DGUT
    step: host ms over 20 steps, then device busy and idle share over 5
    traced steps."""
    import bench_train_torch as bt
    from threedgrut_tpu_torch.render.grt import grt_raster_config

    for label, rc, camera in (("step_3dgut", None, "pinhole"),
                              ("step_3dgrt", grt_raster_config(), "pinhole"),
                              ("step_rolling_3dgut", None, "rolling")):
        step = bt.BenchStep(dev, rc, camera)
        bt.time_steps(step, 3)
        ms, _ = bt.time_steps(step, 20)
        wall, busy, kernels = bt.profile_steps(step, 5, top=0)
        res[label] = dict(ms=ms, busy_us=busy, idle=1.0 - busy / wall,
                          kernels=kernels)
        del step
        torch.cuda.empty_cache()


def rgb_b_inputs(cs, dev):
    """Yield (label, B's and E's arguments) of the eight RGB modes
    (``rgb_b`` above): the 800x800 bench view (shared origin) and the
    1920x1280 rolling shutter (general), each with 3DGUT (degree 2, W 0),
    3DGRT (degree 4, W 16), sorted 3DGUT (degree 2, W 16) and degree 4 at
    W 0."""
    from threedgrut_tpu_torch.ops.cameras import make_pinhole
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.gut import prepare_view
    from threedgrut_tpu_torch.synthetic import bench_camera, bench_cloud

    side = cs.SIDE
    grt = cs.sorted_settings()["3DGRT"]
    settings = {"3dgut": RasterConfig(), "3dgrt": grt,
                "sorted3dgut": cs.sorted_settings()["sorted 3DGUT"],
                "deg4_w0": grt.replace(sorted_compositing=False)}
    model = bench_cloud(100_000, seed=0, device=dev)
    cams = {"": make_pinhole((side, side), (1.1 * side, 1.1 * side),
                             (side / 2, side / 2), device=dev),
            "rolling_": bench_camera("rolling", device=dev)}
    for prefix, cam in cams.items():
        with torch.no_grad():
            v = prepare_view(cam, UTConfig(), RasterConfig(), model, 3)
        base = (v.table, v.binning.pair_particle, v.binning.tile_start,
                v.ray_d, v.tmin, v.tmax)
        for label, rc in settings.items():
            yield prefix + label, base + (rc, v.ray_o)
        del v, base


def rgb_b_group(cs, dev, res):
    """Kernels B and E in their eight RGB modes: times and hashes."""
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles_forward
    from threedgrut_tpu_torch.ops.cuda.wmax import pair_weight_max

    for label, args in rgb_b_inputs(cs, dev):
        with torch.no_grad():
            res[f"rgb_b_{label}"] = dict(
                b_sha256=sha256(*rasterize_tiles_forward(*args)),
                e_sha256=sha256(pair_weight_max(*args)),
                b_ms=cs.cuda_ms(lambda: rasterize_tiles_forward(*args), 20),
                b_device_ms=cs.device_ms(
                    lambda: rasterize_tiles_forward(*args), 20),
                e_ms=cs.cuda_ms(lambda: pair_weight_max(*args), 20),
                e_device_ms=cs.device_ms(lambda: pair_weight_max(*args),
                                         20))
        torch.cuda.empty_cache()


def binning_fold_calls(cs, dev):
    """Yield (label, a call of kernel A or D as this tree's main path makes
    it, the one PyTorch call of the same function or None) on the inputs
    of chip_smoke.py phases 3, 9, 14, 20, 27, 32 and 33 (``binning_fold``
    above): D's yardstick is ``index_add_`` of its rows by particle, the
    rows of no particle (trace's dead row) left out. A tree whose fold
    module has no ``fold_shared_segment`` (before the fold's redesign)
    folds kernel 7's rows through ``repeat_fold`` and reads no
    ``n_valid``."""
    import numpy as np
    from threedgrut_tpu_torch.ops import binning
    from threedgrut_tpu_torch.ops.cameras import make_pinhole
    from threedgrut_tpu_torch.ops.cuda import fold as fmod
    from threedgrut_tpu_torch.ops.cuda.expand import expand_decode_pairs
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles_backward, rasterize_tiles_forward, repeat_fold)
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.grt import prepare_trace
    from threedgrut_tpu_torch.render.gut import prepare_view
    from threedgrut_tpu_torch.synthetic import (bench_camera, bench_cloud,
                                                nht_cloud)

    redesigned = hasattr(fmod, "fold_shared_segment")

    def binned(d_rec, b, cap):
        args = (d_rec, b.perm, b.order, b.excl, b.counts, b.limit, cap)
        if redesigned:
            return lambda: fmod.fold_pairs(*args, None, b.num_pairs)
        return lambda: fmod.fold_pairs(*args)

    def index_add(rows, particle, cap):
        return lambda: torch.zeros((cap, rows.shape[1]), device=dev
                                   ).index_add_(0, particle, rows)

    side, ut_cfg = cs.SIDE, UTConfig()
    cam = make_pinhole((side, side), (1.1 * side, 1.1 * side),
                       (side / 2, side / 2), device=dev)
    model = bench_cloud(100_000, seed=0, device=dev)
    up = cs.seeded_upstream(dev, side, side, (3, 1, 1), 7)
    grid = (side // 16, side // 16)
    with torch.no_grad():
        for label, rc in (("3dgut", RasterConfig()),
                          ("3dgrt", cs.sorted_settings()["3DGRT"])):
            v, _, _, c_args = cs.view_inputs(cam, ut_cfg, rc, model, 3, up)
            if label == "3dgut":
                s = binning.pair_slots(v.proj, grid, ut_cfg.alpha_threshold)
                a_args = (s.rows, s.order, s.excl, s.counts, s.total, grid)
                yield "a", lambda: expand_decode_pairs(*a_args), None
            d_rec = rasterize_tiles_backward(*c_args)
            pp = v.binning.pair_particle.long()
            yield (f"d16_{label}", binned(d_rec, v.binning, model.capacity),
                   index_add(d_rec, pp, model.capacity))
            del v, c_args, d_rec
        rcam = bench_camera("rolling", device=dev)
        w, h = rcam.resolution
        rng = np.random.default_rng(8)
        rup = [torch.tensor(rng.normal(size=(h, w, c)).astype(np.float32),
                            device=dev) for c in (3, 1, 1)]
        rc = RasterConfig()
        v = prepare_view(rcam, ut_cfg, rc, model, 3)
        args = (v.table, v.binning.pair_particle, v.binning.tile_start,
                v.ray_d, v.tmin, v.tmax, rc, v.ray_o)
        out = rasterize_tiles_forward(*args)
        d_rec = rasterize_tiles_backward(*(args[:6] + (
            out[0], out[2], out[4], *rup, rc, v.ray_o)))
        yield ("d16_rolling", binned(d_rec, v.binning, model.capacity),
               index_add(d_rec, v.binning.pair_particle.long(),
                         model.capacity))
        del v, args, out, d_rec
        nmodel = nht_cloud(100_000, seed=0, device=dev)
        v, _, _, c_args = cs.view_inputs(
            cam, ut_cfg, cs.nht_settings()["3DGUT"], nmodel, 0,
            cs.seeded_upstream(dev, side, side, (24, 1, 1), 26))
        d_rec = rasterize_tiles_backward(*c_args)
        yield ("d64_nht", binned(d_rec, v.binning, nmodel.capacity),
               index_add(d_rec, v.binning.pair_particle.long(),
                         nmodel.capacity))
        del v, c_args, nmodel, d_rec
    torch.cuda.empty_cache()
    n_blocks = cs.TRACE_SIDE * cs.TRACE_SIDE // 256
    rng = np.random.default_rng(31)
    tup = [torch.tensor(rng.normal(size=(16 * n_blocks, 16, c)).astype(
        np.float32), device=dev) for c in (3, 1, 1)]
    for label, n in (("kernel7", 8192), ("grid", 100_000)):
        cloud = bench_cloud(n, seed=0, device=dev)
        ro, rd = cs.trace_rays(cloud)
        with torch.enable_grad():
            inp = prepare_trace(cloud, ro, rd)
        with torch.no_grad():
            args = inp.args()
            out = rasterize_tiles_forward(*args)
            d1 = rasterize_tiles_backward(*(args[:6] + (
                out[0], out[2], out[4], *tup, inp.cfg, inp.ray_o,
                inp.shared)))
            fm, cap = inp.fold, inp.table.shape[0]
            # each row's particle: the pair's (grid), or the segment
            # slot's (kernel 7: row t P + j holds slot j)
            pid = inp.pair_particle.long()
            if label == "kernel7":
                pid = pid.repeat(n_blocks)
            keep = pid < cap - 1            # the dead row is the last
            lib = index_add(d1[keep], pid[keep], cap)
            if label == "grid":
                yield "d16_grid", lambda: fmod.fold_pairs(
                    d1, fm.perm, fm.order, fm.excl, fm.counts, fm.limit,
                    cap, *((fm.inv_perm,) if redesigned else ())), lib
            elif redesigned:
                yield "d16_kernel7", lambda: fmod.fold_shared_segment(
                    d1, n_blocks, fm.order, fm.excl, fm.counts, fm.limit,
                    cap), lib
            else:
                def parent_kernel7():
                    g = repeat_fold(fm, n_blocks)
                    return fmod.fold_pairs(d1, g.perm, g.order, g.excl,
                                           g.counts, g.limit, cap)
                yield "d16_kernel7", parent_kernel7, lib
            del inp, args, out, d1, pid, keep, lib
        torch.cuda.empty_cache()


def binning_fold_group(cs, dev, res, out_dir):
    """Kernels A and D: times, hashes, and the outputs kept for the
    comparison across trees (A with the sort's tile_start)."""
    from threedgrut_tpu_torch.ops import binning

    for label, fn, lib in binning_fold_calls(cs, dev):
        with torch.no_grad():
            outs = fn()
            if label == "a":
                outs = binning.sort_pairs(*outs, (cs.SIDE // 16) ** 2)[:3]
            outs = outs if isinstance(outs, tuple) else (outs,)
            torch.save([o.cpu() for o in outs], os.path.join(
                out_dir, f"{res['tree']}_binning_fold_{label}.pt"))
            r = dict(sha256=sha256(*outs), ms=cs.cuda_ms(fn, 20),
                     device_ms=cs.device_ms(fn, 20))
            if lib is not None:
                r.update(index_add_ms=cs.cuda_ms(lib, 20),
                         index_add_device_ms=cs.device_ms(lib, 20))
            res[f"binning_fold_{label}"] = r
            del outs


def layout_inputs(cs, dev):
    """{label: (wrapper, arguments)} of kernel G's and H's four calls on
    chip_smoke.py phases 39 and 40's inputs."""
    from threedgrut_tpu_torch.ops import binning
    from threedgrut_tpu_torch.ops.cuda.expand import expand_sorted_rows
    from threedgrut_tpu_torch.ops.cuda.fill import (forward_fill,
                                                    segmented_fill_rows)
    from threedgrut_tpu_torch.ops.ut import UTConfig

    _, v, _ = bench_view(cs, dev)
    with torch.no_grad():
        s = binning.pair_slots(v.proj, (cs.SIDE // 16, cs.SIDE // 16),
                               UTConfig().alpha_threshold)
    g = cs.expand_inputs(v, s)
    ff, rows = cs.fill_inputs(dev)
    return {"g_pairs": (expand_sorted_rows, g["pair"]),
            "g_tiles": (expand_sorted_rows, g["tile"]),
            "h_forward": (forward_fill, ff),
            "h_segmented": (segmented_fill_rows, rows)}


def layout_group(cs, dev, res):
    """Kernels G and H: times (in all and by kernel) and hashes."""
    with torch.no_grad():
        for label, (fn, args) in layout_inputs(cs, dev).items():
            def call():
                return fn(*args)

            total, by_kernel = cs.device_ms(call, 20, by_kernel=True)
            res[f"layout_{label}"] = dict(
                sha256=sha256(call()), ms=cs.cuda_ms(call, 20),
                device_ms=total, device_by_kernel=by_kernel)


def cross_tree(runs, out_dir):
    """Per rgb_c mode, this tree's output against the other's: relative
    L2 per field group; per nht_b degree, the features' max |d|; per
    binning_fold call, each output's max |d| and the other's max |x|."""
    labels = {k for r in runs for k in r
              if k.startswith(("rgb_c_", "nht_b_", "binning_fold_"))}
    out = {}
    for k in sorted(labels):
        this, other = (torch.load(os.path.join(out_dir, f"{t}_{k}.pt"))
                       for t in ("this", "other"))
        if k.startswith("binning_fold_"):
            out[k] = dict(max_abs_diff=[
                float((x.double() - y.double()).abs().max())
                for x, y in zip(this, other)], other_max_abs=[
                float(y.double().abs().max()) for y in other])
            continue
        if k.startswith("nht_b_"):
            out[k] = dict(features_max_abs_diff=float(
                (this - other).abs().max()))
            continue
        rel = {}
        for g, sl in FIELD_GROUPS.items():
            x, y = this[:, sl].double(), other[:, sl].double()
            rel[g] = float((x - y).norm() / y.norm().clamp(min=1e-300))
        out[k] = dict(rel_l2=rel)
    return out


GROUP_FNS = {"trace": trace_group, "playground": playground_group,
             "guard800": guard800_group, "nht_c": nht_c_group,
             "f": f_group, "nht_step": nht_step_group,
             "table_route": table_route_group, "rgb_c": rgb_c_group,
             "nht_b": nht_b_group, "gs_steps": gs_steps_group,
             "rgb_b": rgb_b_group, "binning_fold": binning_fold_group,
             "layout": layout_group}
# the groups that keep their outputs in --out
OUT_GROUPS = ("rgb_c", "nht_b", "binning_fold")


def child(label, groups, out_dir):
    """One tree's measurements (this process imports that tree)."""
    import threedgrut_tpu_torch

    print(f"measuring {os.path.dirname(threedgrut_tpu_torch.__file__)}",
          flush=True)
    from threedgrut_tpu_torch.ops.cuda import build

    cs = smoke()
    dev = torch.device("cuda:0")
    build.load_all(["bin_decode", "raster_fwd", "raster_bwd", "fold",
                    "scatter_rows", "wmax", "expand_rows", "fill"])
    res = {"tree": label}
    for g in groups:
        if g in OUT_GROUPS:
            GROUP_FNS[g](cs, dev, res, out_dir)
        else:
            GROUP_FNS[g](cs, dev, res)
    print("TREE " + json.dumps(res), flush=True)


def summary(res):
    """One line of a tree's measurements."""
    parts = []
    for k in ("trace_kernel7", "trace_grid"):
        if k in res:
            r = res[k]
            parts.append(
                f"{k}: B {r['b_ms']:.4f} ms (device {r['b_device_ms']:.4f}), "
                f"C {r['c_ms']:.4f} (device {r['c_device_ms']:.4f}), "
                f"differentiated trace {r['trace_grad_host_ms']:.3f} ms host"
                f" / {r['trace_grad_device_ms']:.3f} device, B sha256 "
                f"{r['b_sha256'][:16]}")
    for k in ("guard800_3dgut", "guard800_3dgrt"):
        if k in res:
            r = res[k]
            parts.append(f"{k}: B {r['b_ms']:.4f} ms, C {r['c_ms']:.4f} ms, "
                         f"D {r['d_ms']:.4f} ms, E {r['e_ms']:.4f} ms, "
                         f"sha256 B {r['b_sha256'][:16]} C "
                         f"{r['c_sha256'][:16]} D {r['d_sha256'][:16]} E "
                         f"{r['e_sha256'][:16]}")
    if "nht_c_deg2_ms" in res:
        parts.append(f"NHT C {res['nht_c_deg2_ms']:.4f} / "
                     f"{res['nht_c_deg4_ms']:.4f} ms (degree 2 / 4)")
    if "f_ms" in res:
        parts.append(f"F {res['f_ms']:.4f} ms (set-up {res['f_setup_ms']:.4f},"
                     f" kernel {res['f_kernel_ms']:.4f}; device "
                     f"{res['f_device_ms']:.4f}), index_add_ "
                     f"{res['index_add_ms']:.4f} ms (device "
                     f"{res['index_add_device_ms']:.4f})")
    for k in sorted(res):
        if k.startswith("rgb_b_"):
            r = res[k]
            parts.append(f"{k} B {r['b_ms']:.4f} ms (device "
                         f"{r['b_device_ms']:.4f}) sha256 "
                         f"{r['b_sha256'][:16]}, E {r['e_ms']:.4f} ms "
                         f"(device {r['e_device_ms']:.4f}) sha256 "
                         f"{r['e_sha256'][:16]}")
    for k in sorted(res):
        if k.startswith(("rgb_c_", "nht_b_")):
            parts.append(f"{k} {res[k]['ms']:.4f} ms sha256 "
                         f"{res[k]['sha256'][:16]}")
        elif k.startswith("binning_fold_"):
            r = res[k]
            parts.append(f"{k} {r['ms']:.4f} ms (device "
                         f"{r['device_ms']:.4f}) sha256 {r['sha256'][:16]}"
                         + (f", index_add_ {r['index_add_ms']:.4f} ms "
                            f"(device {r['index_add_device_ms']:.4f})"
                            if "index_add_ms" in r else ""))
    for k in sorted(res):
        if k.startswith("layout_"):
            r = res[k]
            parts.append(f"{k} {r['ms']:.4f} ms (device {r['device_ms']:.4f}"
                         f": " + ", ".join(f"{n[:40]} {t:.4f}" for n, t in
                                           r["device_by_kernel"].items())
                         + f") sha256 {r['sha256'][:16]}")
    for k in NHT_CONFIGS + ("table_route", "playground", "step_3dgut",
                            "step_3dgrt", "step_rolling_3dgut"):
        if k in res:
            r = res[k]
            parts.append(f"{k.split('/')[-1]} {r['ms']:.3f} ms busy "
                         f"{r['busy_us']:.1f} us idle {r['idle']:.3f}"
                         + (f" kernels {r['kernels']:.1f}" if "kernels" in r
                            else ""))
    return "; ".join(parts)


def run_tree(tree, label, groups, out_dir):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [tree, os.path.join(tree, "scripts")]))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        label, "--groups", ",".join(groups), "--out",
                        out_dir], cwd=tree,
                       env=env, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{label} tree failed:\n{r.stderr[-4000:]}")
    lines = r.stdout.splitlines()
    for ln in lines:
        if ln.startswith("measuring"):
            print(f"[{label}] {ln}", flush=True)
    return json.loads([ln for ln in lines if ln.startswith("TREE ")][-1][5:])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma-separated measurement groups")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "compare"),
                    help="where rgb_c and nht_b keep each tree's outputs")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    groups = [g for g in args.groups.split(",") if g]
    unknown = set(groups) - set(GROUPS)
    if unknown:
        ap.error(f"unknown groups {sorted(unknown)}; known: {GROUPS}")
    if not torch.cuda.is_available():
        raise SystemExit("compare_tree_torch.py: needs a CUDA device")
    if args.child:
        # the tree in the working directory, not this file's, is measured
        tree = os.getcwd()
        sys.path[:] = [tree, os.path.join(tree, "scripts")] + [
            x for x in sys.path if os.path.abspath(x or ".") != HERE]
        child(args.child, groups, args.out)
        return
    if not args.other:
        ap.error("--other is required")
    other = os.path.abspath(args.other)
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    print(smoke().nvidia_smi_line(), flush=True)
    runs = []
    for _ in range(args.rounds):
        for tree, label in ((other, "other"), (REPO, "this"), (REPO, "this"),
                            (other, "other")):
            res = run_tree(tree, label, groups, out_dir)
            runs.append(res)
            print(f"[{label}] {summary(res)}", flush=True)
    across = cross_tree(runs, out_dir)
    for k, v in across.items():
        print(f"[this vs other] {k}: {v}", flush=True)
    print(json.dumps({"runs": runs, "across": across,
                      "card": smoke().nvidia_smi_line()}))


if __name__ == "__main__":
    main()
