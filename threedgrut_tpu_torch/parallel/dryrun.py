"""The multi-device dry run (port of __graft_entry__.py:64-399,
``dryrun_multichip``): every parallel step of ``dp.py`` and
``particle.py`` on a tiny scene, each held against the same step on one
rank.

    python -m threedgrut_tpu_torch.parallel.dryrun --world-size 2
    python -m threedgrut_tpu_torch.parallel.dryrun --world-size 4 \\
        --device cpu --backend gloo

In JAX's order, with its asserts: the band-sharded step (max |dParams|
against one rank < 1e-4); the depth-sliced step (its loss against one
rank within JAX's 3e-3); a GS densify and an opacity prune on the
replicated state, a checkpoint round trip and a step on the restored
state; dp x mp on a (D/2, 2) mesh (D >= 4 and even) or (1, D) (L1
against one rank within 3e-3); then under dp, 3DGRT sorted compositing
(W 16), an OpenCV fisheye and NHT features (L1 on every ray feature,
SSIM off; 48 features, the card's NHT width), each max |dParams| < 1e-4.
JAX's pair-budget recalibration is left out: the port sizes its pair
buffer per view.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..convert import save_checkpoint
from ..models.gaussians import (GaussianModel, GaussianModelConfig,
                                param_names)
from ..ops.cameras import make_fisheye, make_pinhole
from ..ops.sh import SH_C0
from ..ops.ut import UTConfig
from ..optimizers.adam import init_adam_state
from ..render.common import RasterConfig
from ..strategy import gs as gs_strategy
from . import comm
from .dp import make_dp_train_step, replicate_to_mesh, shard_image_rows
from .launch import run_ranks
from .particle import (make_dp_sliced_train_step, make_sliced_render,
                       make_sliced_train_step, mesh_groups)

DELTA_TOL = 1e-4       # max |dParams| against one rank (JAX's dryrun)
LOSS_RTOL = 3e-3       # sliced and dp x mp losses (tests/test_parallel.py)
NHT_DIM = 48


def scene_arrays(n=2048, cap=2048, seed=0):
    """The raw parameters of __graft_entry__.py:_build_scene, from the
    same numpy draws."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((cap, 3), np.float32)
    pos[:n, 0:2] = rng.uniform(-1.5, 1.5, (n, 2))
    pos[:n, 2] = rng.uniform(2.0, 7.0, n)
    pos[n:, 2] = 1e6
    quat = rng.normal(size=(cap, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    scales = np.log(rng.uniform(0.02, 0.08, (cap, 3)).astype(np.float32))
    dens = (rng.normal(size=(cap, 1)) * 0.5).astype(np.float32)
    rgb = rng.uniform(0, 1, (cap, 3)).astype(np.float32)
    albedo = (rgb - np.float32(0.5)) / np.float32(SH_C0)
    spec = (rng.normal(size=(cap, 45)) * 0.02).astype(np.float32)
    return dict(positions=pos, rotation=quat, scale=scales, density=dens,
                features_albedo=albedo, features_specular=spec)


def build_scene(n=2048, cap=2048, res=(128, 128), seed=0, device="cpu"):
    """(camera, model): _build_scene's SH-3 cloud of ``n`` active rows of
    ``cap`` and its pinhole camera (focal 1.1 W, centred)."""
    model = GaussianModel.from_numpy(scene_arrays(n, cap, seed), n, 3,
                                     GaussianModelConfig(), device)
    w, h = res
    cam = make_pinhole(res, (1.1 * w, 1.1 * w), (w / 2, h / 2),
                       device=device)
    return cam, model


def params_of(model) -> dict:
    """Detached copies of the model's raw parameters."""
    return {k: v.detach().clone() for k, v in model.params().items()}


def max_delta(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _check(ok, msg):
    """The dry run's asserts, kept under ``python -O``."""
    if not ok:
        raise AssertionError(msg)


def _run(step, params, lrs, gt, n_active, cam):
    """One step from ``params`` (copied) and a fresh Adam state."""
    p = {k: v.clone() for k, v in params.items()}
    p, _, metrics = step(p, init_adam_state(p), lrs, gt, n_active, cam)
    return p, {k: float(v) for k, v in metrics.items()}


def dryrun_rank(rank: int, world_size: int, device) -> List[str]:
    """Every case of the dry run on this rank (see the module docstring);
    returns the lines rank 0 prints. Run by ``run_ranks``."""
    n_dev = world_size
    singles = [dist.new_group([r]) for r in range(world_size)]
    one = singles[rank]
    lines = []

    def say(msg):
        lines.append(f"dryrun_multichip({n_dev}): {msg}")

    ut = UTConfig()
    rc = RasterConfig()
    res = (32, 16 * n_dev)
    cam, model = build_scene(n=256, cap=256, res=res, device=device)
    params = replicate_to_mesh(params_of(model))
    lrs = {k: 1e-3 for k in params}
    rng = np.random.default_rng(0)
    gt = torch.from_numpy(rng.uniform(0, 1, (res[1], res[0], 3)).astype(
        np.float32)).to(device)

    # 1. the band-sharded step against one rank
    p_dp, m_dp = _run(make_dp_train_step(None, cam, ut, rc, model, 1),
                      params, lrs, shard_image_rows(gt), model.n_active, cam)
    p_1, m_1 = _run(make_dp_train_step(one, cam, ut, rc, model, 1),
                    params, lrs, gt, model.n_active, cam)
    delta = max_delta(p_dp, p_1)
    _check(np.isfinite(m_dp["total"]), f"dp train step loss {m_dp}")
    _check(delta < DELTA_TOL, f"dp vs single-device params diverge: {delta}")
    say(f"dp loss={m_dp['total']:.4f} (one rank {m_1['total']:.4f}) "
        f"max|dParams| vs 1-dev={delta:.2e} OK")

    # 2. the depth-sliced step
    gt2 = torch.from_numpy(rng.uniform(0, 1, (res[1], res[0], 3)).astype(
        np.float32)).to(device)
    _, m_s = _run(make_sliced_train_step(None, ut, rc, model, 1), params,
                  lrs, gt2, model.n_active, cam)
    _, m_s1 = _run(make_sliced_train_step(one, ut, rc, model, 1), params,
                   lrs, gt2, model.n_active, cam)
    _check(np.isfinite(m_s["total"]), f"sliced train step loss {m_s}")
    _check(abs(m_s["total"] - m_s1["total"]) <= LOSS_RTOL * abs(
        m_s1["total"]) + 1e-4, f"sliced {m_s} against one rank {m_s1}")
    say(f"depth-sliced loss={m_s['total']:.4f} (one rank "
        f"{m_s1['total']:.4f}) OK")

    # 3. GS events on the replicated state, a checkpoint round trip
    _, ev_model = build_scene(n=200, cap=256, res=res, seed=1,
                              device=device)
    with torch.no_grad():
        ev_model.density[:10] = -10.0   # sigmoid ~5e-5 < the 0.005 prune
    replicate_to_mesh(list(ev_model.params().values()))
    opt = init_adam_state(ev_model.params())
    cap = ev_model.capacity
    accum = torch.where(torch.arange(cap, device=device) % 7 == 0, 1.0, 0.0)
    buffers = gs_strategy.GSBuffers(
        accum * 4e-4, torch.ones(cap, dtype=torch.int32, device=device))
    n_before = ev_model.n_active
    gen = torch.Generator(device=device).manual_seed(0)
    buffers, stats = gs_strategy.densify(ev_model, opt, buffers, 1.0,
                                         n_split=2, generator=gen)
    n_after = ev_model.n_active
    _check(stats["n_cloned"] + stats["n_split"] > 0, f"densify {stats}")
    buffers, n_pruned = gs_strategy.prune_opacity(ev_model, opt, buffers,
                                                  0.005)
    _check(n_pruned > 0, "the opacity prune dropped nothing")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        save_checkpoint(ev_model, path)
        restored = GaussianModel.from_checkpoint(path, model.config,
                                                 device=device)
    _check(restored.n_active == ev_model.n_active,
           f"restored n_active {restored.n_active}")
    p_r = replicate_to_mesh(params_of(restored))
    _, m_r = _run(make_dp_train_step(None, cam, ut, rc, restored, 1), p_r,
                  lrs, shard_image_rows(gt), restored.n_active, cam)
    _check(np.isfinite(m_r["total"]), f"restored state's step {m_r}")
    say(f"dp densify(n {n_before}->{n_after})+prune({n_pruned})+ckpt "
        f"loss={m_r['total']:.4f} OK")

    # 4. data x particle parallelism on a 2D mesh
    shape = (n_dev // 2, 2) if n_dev % 2 == 0 and n_dev >= 4 else (1, n_dev)
    groups = mesh_groups(shape)
    res2 = (32, 16 * shape[0])
    cam2, model2 = build_scene(n=256, cap=256, res=res2, device=device)
    p5 = replicate_to_mesh(params_of(model2))
    gt5 = torch.from_numpy(rng.uniform(0, 1, (res2[1], res2[0], 3)).astype(
        np.float32)).to(device)
    _, m6 = _run(make_dp_sliced_train_step(groups, cam2, ut, rc, model2, 1),
                 p5, lrs, shard_image_rows(gt5, groups[0]), model2.n_active,
                 cam2)
    _, m6_1 = _run(make_dp_sliced_train_step((one, one), cam2, ut, rc,
                                             model2, 1),
                   p5, lrs, gt5, model2.n_active, cam2)
    _check(np.isfinite(m6["total"]) and abs(m6["total"] - m6_1["total"])
           <= LOSS_RTOL * abs(m6_1["total"]) + 1e-4,
           f"dp x mp {m6} against one rank {m6_1}")
    say(f"dp x mp {shape[0]}x{shape[1]} loss={m6['total']:.4f} (one rank "
        f"{m6_1['total']:.4f}) OK")

    # 5. other modes under dp against one rank
    def dp_vs_one(tag, cam_t, rc_t, mdl, gt_img, sh_degree, **kw):
        pd = replicate_to_mesh(params_of(mdl))
        lr = {k: 1e-3 for k in pd}
        got, m = _run(make_dp_train_step(None, cam_t, ut, rc_t, mdl,
                                         sh_degree, **kw),
                      pd, lr, shard_image_rows(gt_img), mdl.n_active, cam_t)
        ref, _ = _run(make_dp_train_step(one, cam_t, ut, rc_t, mdl,
                                         sh_degree, **kw),
                      pd, lr, gt_img, mdl.n_active, cam_t)
        d = max_delta(got, ref)
        _check(np.isfinite(m["total"]), f"{tag}: loss={m['total']}")
        _check(d < DELTA_TOL, f"{tag}: dp vs 1-dev diverge: {d}")
        say(f"{tag} loss={m['total']:.4f} max|dParams| vs 1-dev={d:.2e} OK")

    dp_vs_one("3dgrt-sorted", cam, rc.replace(sorted_compositing=True,
                                              sort_window=16), model, gt, 1)
    cam_fe = make_fisheye(res, (0.6 * res[0], 0.6 * res[0]),
                          (res[0] / 2, res[1] / 2), (0.02, -0.01, 0.0, 0.0),
                          1.2, device=device)
    dp_vs_one("fisheye", cam_fe, rc, model, gt, 1)
    arrays = {k: v.detach().cpu().numpy() for k, v in model.params().items()
              if k in param_names("nht")}
    arrays["features"] = np.random.default_rng(3).uniform(
        -1.5, 1.5, (model.capacity, NHT_DIM)).astype(np.float32)
    nht = GaussianModel.from_numpy(
        arrays, model.n_active, 0,
        GaussianModelConfig(feature_type="nht", nht_feature_dim=NHT_DIM),
        device)
    gt_nht = torch.from_numpy(rng.uniform(
        0, 1, (res[1], res[0], (NHT_DIM // 4) * 2)).astype(np.float32)).to(
        device)
    dp_vs_one("nht", cam, rc, nht, gt_nht, 0, loss_lambda_ssim=0.0)
    return lines


# --- the cases tests/test_torch_parallel.py runs on spawned CPU ranks ---

def _case_model(c, device):
    return GaussianModel.from_numpy(c["arrays"], c["n_active"], c["sh_degree"],
                                    device=device)


def _case_camera(c, device):
    cam = dict(c["camera"])
    kind = cam.pop("kind", "pinhole")
    make = make_fisheye if kind == "fisheye" else make_pinhole
    return make(device=device, **cam)


def _numpy(tree):
    if isinstance(tree, torch.Tensor):   # a copy, also on the CPU
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def step_and_gt(kind, group, cam, rc, model, sh_degree, loss_kw, gt):
    """(the step of ``kind``, this rank's part of ``gt``): the depth-sliced
    step for "sliced_step..." (the full GT), dp x mp for "dp_x_mp" (its
    dp band; ``group`` the (dp, mp) pair), else the dp step (its band)."""
    ut = UTConfig()
    if kind.startswith("sliced_step"):
        return make_sliced_train_step(group, ut, rc, model, sh_degree,
                                      **loss_kw), gt
    if kind == "dp_x_mp":
        return (make_dp_sliced_train_step(group, cam, ut, rc, model,
                                          sh_degree, **loss_kw),
                shard_image_rows(gt, group[0]))
    return (make_dp_train_step(group, cam, ut, rc, model, sh_degree,
                               **loss_kw), shard_image_rows(gt, group))


def _step_case(c, group, device):
    """One step of ``c["kind"]`` ("dp", "sliced_step", "dp_x_mp") from
    the case's parameters and a fresh Adam state: its metrics, the
    gradients it applies and the parameters after it."""
    model, cam = _case_model(c, device), _case_camera(c, device)
    step, gt = step_and_gt(c["kind"], group, cam,
                           RasterConfig(**c.get("raster", {})), model,
                           c["sh_degree"], c.get("loss", {}),
                           torch.from_numpy(c["gt"]).to(device))
    params = params_of(model)
    *_, grads = step.grads(params, gt, model.n_active, cam)
    new, metrics = _run(step, params, {k: 1e-3 for k in params}, gt,
                        model.n_active, cam)
    return {"metrics": metrics, "grads": _numpy(grads),
            "params": _numpy(new)}


def _sliced_render_case(c, group, device):
    model = _case_model(c, device)
    render = make_sliced_render(group, UTConfig(),
                                RasterConfig(**c.get("raster", {})), model,
                                c["sh_degree"])
    return _numpy(render(params_of(model), model.n_active,
                         _case_camera(c, device)))


def comm_functions(group=None):
    """name -> f(x) of each differentiable collective of ``comm.py`` on a
    [12, ...] tensor; ``ppermute`` shifts one rank along the ring, and
    ``ppermute_first`` sends rank 0's value to rank 1 only."""
    n = comm.axis_size(group)
    return {
        "psum": lambda x: comm.psum(x, group),
        "pmean": lambda x: comm.pmean(x, group),
        "all_gather": lambda x: comm.all_gather(x, group),
        "ppermute": lambda x: comm.ppermute(
            x, [(i, (i + 1) % n) for i in range(n)], group),
        "ppermute_first": lambda x: comm.ppermute(x, [(0, 1)], group),
        "halo_rows": lambda x: comm.halo_rows(x, 5, group),
    }


def _comm_case(c, group, device):
    """Each collective on this rank's seeded x [12, 4, 3], and the
    gradient of sum(w * f(x)) for a seeded w: (x, w, f(x), grad) by
    name."""
    rank = comm.axis_index(group)
    x0 = np.random.default_rng(100 + rank).normal(size=(12, 4, 3))
    out = {}
    for name, fn in comm_functions(group).items():
        x = torch.tensor(x0, dtype=torch.float32, device=device,
                         requires_grad=True)
        y = fn(x)
        w = torch.tensor(np.random.default_rng(200 + rank).normal(
            size=tuple(y.shape)), dtype=torch.float32, device=device)
        (y * w).sum().backward()
        out[name] = _numpy({"x": x, "w": w, "y": y, "grad": x.grad})
    return out


_CASES = {"dp": _step_case, "sliced_step": _step_case,
          "dp_x_mp": _step_case, "sliced_render": _sliced_render_case,
          "comm": _comm_case}


def cases_rank(rank: int, world_size: int, device, cases: dict) -> dict:
    """Run ``cases`` {name: case} on this rank (``run_ranks``); returns
    {name: outputs as numpy}. A case names its group: "pair" (ranks 0
    and 1), "world", or "mesh" (a 2 x 2 (dp, mp) mesh of 4 ranks). A
    case holds numpy inputs: ``arrays`` (the raw parameters),
    ``n_active``, ``sh_degree``, ``camera`` (make_pinhole's or, with
    kind "fisheye", make_fisheye's arguments), ``gt``, optional
    ``raster`` and ``loss`` keyword arguments."""
    pair = dist.new_group([0, 1])
    mesh = mesh_groups((2, 2)) if world_size == 4 else None
    out = {}
    for name, c in cases.items():
        if c["group"] == "pair" and rank > 1:
            continue
        group = {"pair": pair, "world": None, "mesh": mesh}[c["group"]]
        out[name] = _CASES[c["kind"]](c, group, device)
    return out


# --- full width: the cases of chip_smoke.py phases 49 and 50 ---

FULL_SIDE, FULL_N = 800, 100_000
FULL_CASES = ("dp", "sliced_render", "sliced_step", "sliced_step_exact",
              "dp_x_mp", "grt", "nht")


def full_width_inputs(kind: str, device):
    """(model, camera, gt, raster config, sh_degree, loss keywords) of a
    full-width case: the bench cloud (100k Gaussians, SH 3; for "nht" its
    48 NHT features) at 800x800 with the apps/nerf_synthetic_3dgut loss
    (0.8 l1 + 0.2 DSSIM; NHT and dp x mp: L1 on every channel), 3DGRT's
    raster settings for "grt", no kill (min_transmittance 0) for
    "sliced_step_exact", and a GT drawn from a seeded generator on
    ``device``: the same tensors in every process on one device."""
    from ..render.grt import grt_raster_config
    from ..synthetic import bench_cloud, nht_cloud

    side = FULL_SIDE
    cam = make_pinhole((side, side), (1.1 * side, 1.1 * side),
                       (side / 2, side / 2), device=device)
    gen = torch.Generator(device=device).manual_seed(18)
    if kind == "nht":
        model = nht_cloud(FULL_N, seed=0, device=device)
        return (model, cam, torch.rand((side, side, NHT_DIM // 2),
                                       generator=gen, device=device),
                RasterConfig(), 0, {"loss_lambda_ssim": 0.0})
    model = bench_cloud(FULL_N, seed=0, device=device)
    rc = (grt_raster_config() if kind == "grt" else
          RasterConfig(min_transmittance=0.0)
          if kind == "sliced_step_exact" else RasterConfig())
    loss = {"lambda_l1": 1.0} if kind == "dp_x_mp" else {}
    return (model, cam, torch.rand((side, side, 3), generator=gen,
                                   device=device), rc, 3, loss)


def _events_ms(fn, reps, device):
    """Mean ms of fn() over ``reps`` calls by CUDA events; None off the
    card (no host clock stands in for a device time)."""
    if torch.device(device).type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def full_width_case(kind: str, device, group=None, steps: int = 5) -> dict:
    """One full-width case of FULL_CASES over ``group`` (dp x mp: a
    (dp, mp) pair of groups): after one step (or render) from the case's
    parameters, its outputs (on the CPU: the gradients the step applies,
    the parameters after it, its metrics; or the sliced render's images)
    and the launches of each kernel wrapper in it; then ``steps`` more
    steps timed by CUDA events (ms a step), and the ms of the step's
    gradient all-reduce alone."""
    from ..ops.cuda import launch_counts, reset_launch_counts

    model, cam, gt, rc, sh, loss = full_width_inputs(kind, device)
    params = params_of(model)
    if kind == "sliced_render":
        render = make_sliced_render(group, UTConfig(), rc, model, sh)
        reset_launch_counts()
        out = render(params, model.n_active, cam)
        launches = launch_counts()
        return {"outputs": _numpy(out), "launches": launches,
                "ms": _events_ms(lambda: render(params, model.n_active,
                                                cam), steps, device)}
    step, gt = step_and_gt(kind, group, cam, rc, model, sh, loss, gt)
    lrs = {k: 1e-3 for k in params}
    opt = init_adam_state(params)
    grads = step.grads(params, gt, model.n_active, cam)[-1]
    reset_launch_counts()
    params, opt, metrics = step(params, opt, lrs, gt, model.n_active, cam)
    launches = launch_counts()
    out = {"params": _numpy(params), "grads": _numpy(grads),
           "metrics": {k: float(v) for k, v in metrics.items()}}

    def one():
        nonlocal opt
        _, opt, _ = step(params, opt, lrs, gt, model.n_active, cam)

    ms = _events_ms(one, steps, device)
    grads = [torch.zeros_like(v) for v in params.values()]
    reduce_groups = [group] if kind != "dp_x_mp" else list(group)
    comm_ms = _events_ms(lambda: [comm.psum_tensors(grads, g)
                                  for g in reduce_groups], steps, device)
    return {"outputs": out, "launches": launches, "ms": ms,
            "comm_ms": comm_ms}


def probe_collectives(device, group=None) -> dict:
    """Which collectives the group's backend takes on tensors of
    ``device``: name -> "direct" or the error (a diagnostic for
    chip_smoke.py phase 50; ``comm.py`` uses all_reduce, all_gather and
    broadcast)."""
    x = torch.ones(4, device=device)
    n = comm.axis_size(group)
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x, group=group),
        "broadcast": lambda: dist.broadcast(
            x.clone(), dist.get_global_rank(group, 0) if group else 0,
            group=group),
    }
    got = {}
    for name, fn in ops.items():
        try:
            fn()
            got[name] = "direct"
        except (RuntimeError, ValueError) as e:   # the probe's finding
            got[name] = f"{type(e).__name__}: {str(e)[:200]}"
    return got


def full_width_rank(rank: int, world_size: int, device,
                    cases: Sequence[str], steps: int) -> dict:
    """``cases`` (of FULL_CASES, dp x mp on a (1, world) mesh) on this
    rank at full width; with the backend's collective probe. Run by
    ``run_ranks`` (chip_smoke.py phase 50: two ranks on one card over
    gloo). Rank 0 returns its outputs, every rank its times and
    launches."""
    res = {"probe": probe_collectives(device), "backend":
           str(dist.get_backend())}
    for kind in cases:
        group = mesh_groups((1, world_size)) if kind == "dp_x_mp" else None
        got = full_width_case(kind, device, group, steps)
        if rank:
            got.pop("outputs")
        res[kind] = got
    return res


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend=None) -> List[str]:
    """The dry run on ``n_devices`` ranks (``launch.run_ranks``); returns
    rank 0's lines. Raises where a case fails."""
    return run_ranks(dryrun_rank, n_devices, device=device,
                     backend=backend)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world-size", type=int, default=None,
                    help="ranks (default: the visible GPUs)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on the card, gloo on "
                         "the CPU)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu")
    n = args.world_size or max(torch.cuda.device_count(), 1)
    for line in dryrun_multichip(n, args.device, args.backend):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
