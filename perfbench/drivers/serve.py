"""One viewer in a closed loop: a request is one view of the serving
orbit through ``render/serve.py:make_serving_renderer``'s ``render``,
and ends when its frame is complete on the card.

The frames of a few views drawn from the seed are kept (each view's
last) and held to the reference's renders once the window has closed.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness, program, scene
from perfbench.reference import render as ref


def setup(ctx) -> dict:
    conf, dev, seed = ctx.cell.config, ctx.device, ctx.seed
    sw = harness.Stopwatch()
    tconf = program.trainer_config(conf, seed)
    sw.lap("config")
    poses = scene.views(conf, "serve")
    model = program.gaussian_model(
        scene.standin_cloud(conf["rows"], seed, dev), conf["sh_degree"])
    from threedgrut_tpu_torch.render.serve import make_serving_renderer

    bg = {"black": 0.0, "white": 1.0}[conf["train"]["background"]]
    render = make_serving_renderer(
        model, tconf.raster, conf["sh_degree"], tconf.ut,
        background=torch.full((3,), bg, device=dev))
    cams = [program.camera(p, dev) for p in poses]
    rng = np.random.default_rng(seed)
    keep = sorted(int(i) for i in rng.choice(
        len(poses), ctx.cell.traffic["checked_frames"], replace=False))
    st = {"render": render, "cams": cams, "poses": poses, "keep": keep,
          "frames": {}, "next": int(rng.integers(len(poses))),
          "conf": conf, "seed": seed, "device": dev, "bg": bg,
          "model": model}
    sw.lap("cloud and cameras")
    for cam in cams:             # every view's shapes, once
        render([cam])
    _sync(dev)
    sw.lap("a frame of every view")
    sw.report("set-up")
    return st


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _request(st):
    i = st["next"]
    st["next"] = (i + 1) % len(st["cams"])
    img = st["render"]([st["cams"][i]])
    _sync(st["device"])
    if i in st["keep"]:
        st["frames"][i] = img[0]
    return img


def window(st, seconds: float) -> dict:
    times: List[float] = []
    _sync(st["device"])
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        _request(st)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if t1 - t_start >= seconds:
            break
    elapsed = time.perf_counter() - t_start
    return {"unit_s": times, "attempted": len(times),
            "failed": 0, "elapsed_s": elapsed,
            "unit_mean_s": elapsed / len(times)}


def end_to_end(w: dict) -> Dict[str, float]:
    return {"serve_frames_per_s": w["attempted"] / w["elapsed_s"]}


def trace(st, n: int) -> dict:
    first = (st["next"] + 1) % len(st["cams"])      # after the pad frame
    st["profiled_views"] = [(first + k) % len(st["cams"]) for k in range(n)]
    return harness.profile_units(lambda: _request(st), n)


def release(st):
    st.pop("render", None)
    st.pop("model", None)
    st.pop("cams", None)


def counts(st) -> List[dict]:
    conf, dev = st["conf"], st["device"]
    params = scene.standin_cloud(conf["rows"], st["seed"], dev)
    s = ref.settings_from(conf)
    out = []
    for v in st["profiled_views"]:
        cam = st["poses"][v].reference_camera(dev)
        c = {"evals": 0, "particles": torch.zeros(
            conf["rows"], dtype=torch.bool, device=dev)}
        ref.render(params, cam, s, conf["sh_degree"], counts=c)
        out.append({"evals": c["evals"],
                    "particles": int(c["particles"].sum()),
                    "pixels": cam.width * cam.height, "rows": conf["rows"]})
    return out


def reference_frames(st, precision: str = "fp32") -> Dict[int, torch.Tensor]:
    """The reference's frame of each kept view, on the background."""
    conf, dev = st["conf"], st["device"]
    params = scene.standin_cloud(conf["rows"], st["seed"], dev)
    s = ref.settings_from(conf)
    out = {}
    for v in st["keep"]:
        color, opac, _ = ref.render(
            params, st["poses"][v].reference_camera(dev), s,
            conf["sh_degree"], precision)
        out[v] = color + st["bg"] * (1.0 - opac)
    return out


def compare(got: Dict[int, torch.Tensor],
            want: Dict[int, torch.Tensor]) -> Dict[str, float]:
    """Over the kept views: the largest share of a frame's pixels whose
    worst channel differs by more than half an 8-bit step (a flipped
    accept decision somewhere along the ray), and the largest RMS
    difference over a frame's other pixels. A view never served counts
    as wholly wrong."""
    flip, bulk = 0.0, 0.0
    for v, w in want.items():
        g = got.get(v)
        if g is None:
            flip = 1.0
            continue
        err = torch.nan_to_num((g.float() - w).abs().amax(-1), nan=1.0)
        bad = err > 0.5 / 255.0
        flip = max(flip, float(bad.float().mean()))
        rest = err[~bad]
        if rest.numel():
            bulk = max(bulk, float(torch.sqrt((rest * rest).mean())))
    return {"flip_share": flip, "bulk_rmse": bulk}


def check(st) -> Dict[str, float]:
    return compare(st["frames"], reference_frames(st))
