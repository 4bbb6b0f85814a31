#!/usr/bin/env python3
"""Time this checkout's port beside another checkout's on one NVIDIA GPU.

    python scripts/compare_tree_torch.py --other <dir> [--rounds 2]

``--other`` is another checkout of the repository, e.g. an earlier
commit unpacked with ``git archive <commit> | tar -x -C build/other``.
Each round runs the two trees in turns (other, this, this, other), each
in a process of its own that imports that tree's ``threedgrut_tpu_torch``
and builds its kernels into that tree's ``build/``, and measures on the
same card, with the inputs and timers of this checkout's chip_smoke.py:

- kernel C's NHT mode at 800x800 on the 100k NHT cloud (48 features),
  degree 2 and 4, on phase 27's inputs (CUDA events);
- kernel F with its set-up on the 800x800 bench view's 691,175 pair rows
  x 16 (phase 37's inputs): with its set-up, the set-up alone and the
  kernel alone (CUDA events), and with its set-up by device time
  (torch.profiler), beside ``index_add_`` by both, and a SHA-256 of its
  output;
- the NHT + MCMC train step of both NHT configs
  (scripts/bench_train_torch.py's step: host ms over 20 steps, then
  device busy and idle share over 5 traced steps);
- the table route's raster forward and backward at 800x800
  (``rasterize_tiles_table``: B, C, F; the same).

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


def smoke():
    """This checkout's chip_smoke.py as a module (its input builders and
    timers), whichever tree's package the process imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(label):
    """One tree's measurements (this process imports that tree)."""
    import threedgrut_tpu_torch

    print(f"measuring {os.path.dirname(threedgrut_tpu_torch.__file__)}",
          flush=True)
    import bench_train_torch as bt
    from threedgrut_tpu_torch.ops.cameras import make_pinhole
    from threedgrut_tpu_torch.ops.cuda import build
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles_backward, rasterize_tiles_table)
    from threedgrut_tpu_torch.ops.cuda.scatter import (
        id_runs, scatter_accumulate_rows, scatter_runs)
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.synthetic import bench_cloud, nht_cloud

    cs = smoke()
    dev = torch.device("cuda:0")
    build.load_all(["bin_decode", "raster_fwd", "raster_bwd", "fold",
                    "scatter_rows"])
    side = cs.SIDE
    cam = make_pinhole((side, side), (1.1 * side, 1.1 * side),
                       (side / 2, side / 2), device=dev)
    ut_cfg = UTConfig()
    res = {"tree": label}
    with torch.no_grad():
        model = nht_cloud(100_000, seed=0, device=dev)
        up = cs.seeded_upstream(dev, side, side, (24, 1, 1), 26)
        for rc in cs.nht_settings().values():
            c_args = cs.view_inputs(cam, ut_cfg, rc, model, 0, up)[3]
            res[f"nht_c_deg{rc.kernel_degree}_ms"] = cs.cuda_ms(
                lambda: rasterize_tiles_backward(*c_args), 10)
        del model, c_args
        rc = RasterConfig()
        v, _, _, c_args = cs.view_inputs(
            cam, ut_cfg, rc, bench_cloud(100_000, seed=0, device=dev), 3,
            cs.seeded_upstream(dev, side, side, (3, 1, 1), 7))
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
        res["f_sha256"] = hashlib.sha256(
            f().cpu().numpy().tobytes()).hexdigest()
    for name in NHT_CONFIGS:
        step = bt.config_step(name, dev)
        bt.time_steps(step, 3)
        ms, _ = bt.time_steps(step, 20)
        wall, busy, _ = bt.profile_steps(step, 5, top=0)
        res[name] = dict(ms=ms, busy_us=busy, idle=1.0 - busy / wall)
        del step
        torch.cuda.empty_cache()
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
    print("TREE " + json.dumps(res), flush=True)


def run_tree(tree, label):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [tree, os.path.join(tree, "scripts")]))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        label], cwd=tree, env=env, capture_output=True,
                       text=True)
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
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_tree_torch.py: needs a CUDA device")
    if args.child:
        # the tree in the working directory, not this file's, is measured
        tree = os.getcwd()
        sys.path[:] = [tree, os.path.join(tree, "scripts")] + [
            x for x in sys.path if os.path.abspath(x or ".") != HERE]
        child(args.child)
        return
    if not args.other:
        ap.error("--other is required")
    other = os.path.abspath(args.other)
    print(smoke().nvidia_smi_line(), flush=True)
    runs = []
    for _ in range(args.rounds):
        for tree, label in ((other, "other"), (REPO, "this"), (REPO, "this"),
                            (other, "other")):
            res = run_tree(tree, label)
            runs.append(res)
            nht = " ".join(
                f"{n.split('/')[-1]} {res[n]['ms']:.3f} ms busy "
                f"{res[n]['busy_us']:.1f} us idle {res[n]['idle']:.3f};"
                for n in NHT_CONFIGS)
            print(f"[{label}] NHT C {res['nht_c_deg2_ms']:.4f} / "
                  f"{res['nht_c_deg4_ms']:.4f} ms (degree 2 / 4); F "
                  f"{res['f_ms']:.4f} ms (set-up {res['f_setup_ms']:.4f}, "
                  f"kernel {res['f_kernel_ms']:.4f}; device "
                  f"{res['f_device_ms']:.4f}), index_add_ "
                  f"{res['index_add_ms']:.4f} ms (device "
                  f"{res['index_add_device_ms']:.4f}); {nht} table route "
                  f"{res['table_route']['ms']:.3f} ms busy "
                  f"{res['table_route']['busy_us']:.1f} us idle "
                  f"{res['table_route']['idle']:.3f}", flush=True)
    print(json.dumps({"runs": runs, "card": smoke().nvidia_smi_line()}))


if __name__ == "__main__":
    main()
