"""Closed-loop training: ``Trainer.train_iteration`` over the capture's
views in the trainer's own shuffled order, from a resumed step.

Set-up builds the trainer over the seed's stand-in cloud and the views'
images (rendered by the reference from the teacher), then drives it
through its first steps, which the reference follows; the same trainer
runs the window. A step is one call of ``train_iteration``, which ends
in a host synchronisation (it returns its metrics as floats).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness, program, scene
from perfbench.reference import render as ref
from perfbench.reference import train as ref_train


class Feed:
    """``Trainer.run_training``'s order: each epoch a permutation of the
    views from ``default_rng(seed + global step)``, taken from its end."""

    def __init__(self, n_views: int, seed: int, step: int):
        self.n, self.seed, self.step, self.order = n_views, seed, step, []

    def next(self) -> int:
        if not self.order:
            self.order = list(np.random.default_rng(
                self.seed + self.step).permutation(self.n))
        self.step += 1
        return int(self.order.pop())


def reference_views(conf: dict, poses, device, seed: int):
    """(Camera, image) of each view: the teacher rendered by the
    reference on the configuration's background, cut to 8 bits."""
    s = ref.settings_from(conf)
    teacher = scene.teacher_cloud(seed, device)
    bg = {"black": 0.0, "white": 1.0}[conf["train"]["background"]]
    out = []
    for p in poses:
        cam = p.reference_camera(device)
        color, opac, _ = ref.render(teacher, cam, s, conf["sh_degree"])
        img = torch.clamp(color + bg * (1.0 - opac), 0.0, 1.0)
        out.append((cam, torch.round(img * 255.0) / 255.0))
    return out


def setup(ctx) -> dict:
    conf, dev, seed = ctx.cell.config, ctx.device, ctx.seed
    sw = harness.Stopwatch()
    tconf = program.trainer_config(conf, seed)
    sw.lap("config")
    poses = scene.views(conf, "train")
    ref_views = reference_views(conf, poses, dev, seed)
    sw.lap("views' images")
    capture = program.Capture([
        program.View(p.c2w, p.intrinsics, img)
        for p, (_, img) in zip(poses, ref_views)])
    model = program.gaussian_model(
        scene.standin_cloud(conf["rows"], seed, dev), conf["sh_degree"])
    from threedgrut_tpu_torch.train.trainer import Trainer

    trainer = Trainer(tconf, capture, model)
    trainer.global_step = conf["start_step"]
    trainer.n_active_features = conf["sh_degree"]
    feed = Feed(len(capture), seed, conf["start_step"])
    sw.lap("cloud and trainer")
    program.warm_strategy(tconf, dev)
    sw.lap("strategy warm-up")
    st = {"trainer": trainer, "capture": capture, "feed": feed,
          "ref_views": ref_views, "frames": [], "losses": [], "pairs": [],
          "conf": conf, "seed": seed, "device": dev}
    # the checked steps: the trainer from the seed's state, read after
    # its first step (the gradient, from Adam's first moment) and after
    # the last (each group's change, kept on the host, and the rows that
    # relocate moved or drew: their optimizer moments start again at 0)
    params = trainer.params()
    init = {k: p.detach().clone() for k, p in params.items()}
    b1 = conf["train"]["betas"][0]
    for i in range(ctx.cell.traffic["checked_steps"]):
        idx = feed.next()
        m = trainer.train_iteration(capture[idx], frame_idx=idx)
        st["frames"].append(idx)
        st["losses"].append(m["total"])
        st["pairs"].append(m["pairs"])
        if i == 0:
            st["grad_norms"] = {
                k: float(torch.linalg.vector_norm(
                    trainer.opt_state.exp_avg[k]) / (1.0 - b1))
                for k in params}
    st["change"] = {k: (params[k].detach() - init.pop(k)).cpu()
                    for k in params}
    st["touched"] = (trainer.opt_state.exp_avg["density"] == 0).all(1).cpu()
    st["relocated"] = sum(int(e[2]["n_relocated"])
                          for e in trainer.event_stats if e[1] == "relocate")
    st["rows"] = ref_train.row_summary(params)
    sw.lap("checked steps")
    for _ in range(ctx.cell.traffic["warmup_steps"]):
        idx = feed.next()
        trainer.train_iteration(capture[idx], frame_idx=idx)
    torch.cuda.synchronize() if dev.type == "cuda" else None
    sw.lap("warm-up steps")
    sw.report("set-up")
    return st


def _step(st) -> Dict[str, float]:
    idx = st["feed"].next()
    return st["trainer"].train_iteration(st["capture"][idx], frame_idx=idx)


def window(st, seconds: float) -> dict:
    times: List[float] = []
    pairs: List[int] = []
    failed = 0
    sync = torch.cuda.synchronize if st["device"].type == "cuda" else (
        lambda: None)
    sync()
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        m = _step(st)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        pairs.append(m["pairs"])
        failed += not math.isfinite(m["total"])
        if t1 - t_start >= seconds:
            break
    sync()
    elapsed = time.perf_counter() - t_start
    tenth = max(len(pairs) // 10, 1)
    harness.log(f"pairs a step: first tenth {np.mean(pairs[:tenth]):.0f}, "
                f"last tenth {np.mean(pairs[-tenth:]):.0f}")
    return {"unit_s": times, "pairs": pairs,
            "attempted": len(times), "failed": failed, "elapsed_s": elapsed,
            "unit_mean_s": elapsed / len(times)}


def end_to_end(w: dict) -> Dict[str, float]:
    return {"train_steps_per_s": w["attempted"] / w["elapsed_s"]}


def trace(st, n: int) -> dict:
    """Profile ``n`` steps; keep their views and the parameters they
    started from (on the host) for the counts."""
    feed = st["feed"]
    # the pad step inside the session comes first
    peek = Feed(feed.n, feed.seed, feed.step)
    peek.order = list(feed.order)
    peek.next()
    st["profiled_frames"] = [peek.next() for _ in range(n)]
    tr = st["trainer"]
    st["profiled_params"] = {k: v.detach().to("cpu", copy=True)
                             for k, v in tr.model.params().items()}
    return harness.profile_units(lambda: _step(st), n)


def release(st):
    """Free the program's state before the reference runs."""
    st.pop("trainer", None)
    st.pop("capture", None)


def counts(st) -> List[dict]:
    """The reference's count of the contributing evaluations of each
    profiled step's view."""
    conf, dev = st["conf"], st["device"]
    params = {k: v.to(dev) for k, v in st.pop("profiled_params").items()}
    s = ref.settings_from(conf)
    out = []
    for f in st["profiled_frames"]:
        cam, _ = st["ref_views"][f]
        c = {"evals": 0, "particles": torch.zeros(
            params["positions"].shape[0], dtype=torch.bool, device=dev)}
        ref.render(params, cam, s, conf["sh_degree"], counts=c)
        out.append({"evals": c["evals"], "particles": int(c["particles"].sum()),
                    "pixels": cam.width * cam.height,
                    "rows": params["positions"].shape[0],
                    "isp": conf["train"]["post_processing"] == "ppisp"})
    return out


def program_readings(st) -> ref_train.StepReadings:
    return ref_train.StepReadings(st["losses"], st["pairs"],
                                  st["grad_norms"], st["change"],
                                  st["touched"], st["relocated"], st["rows"])


def reference_readings(st, precision: str = "fp32",
                       drop_half: bool = False) -> ref_train.StepReadings:
    """The reference's steps from the seed's state on the checked steps'
    views."""
    conf, dev = st["conf"], st["device"]
    params = scene.standin_cloud(conf["rows"], st["seed"], dev)
    extent = ref_train.scene_extent([p.c2w for p in
                                     scene.views(conf, "train")])
    return ref_train.train_steps(
        params, st["ref_views"], st["frames"], ref_train.spec_from(conf),
        conf["start_step"], conf["sh_degree"], extent, st["seed"], precision,
        drop_half)


def compare(got: ref_train.StepReadings,
            want: ref_train.StepReadings) -> Dict[str, float]:
    """Each step's loss; the worst leaf's first gradient; the worst leaf's
    change over the rows that relocate left alone on both sides, and over
    the leaves the reference's gradient moves (at least a thousandth of
    the median leaf's); the share of the reference's dead rows at which
    relocate's invariants break (``reference/train.py:relocate_check``)."""
    med = float(np.median(list(want.grad_norms.values())))
    moved = [k for k, g in want.grad_norms.items() if g >= 1e-3 * med]
    keep = ~(got.touched | want.touched)
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got.losses, want.losses)),
        "grad_gap": ref_train.leaf_gap(got.grad_norms, want.grad_norms),
        "change_gap": ref_train.leaf_gap(
            ref_train.change_norms(got, keep),
            ref_train.change_norms(want, keep), moved),
        "relocate_gap": ref_train.relocate_check(got, want)["gap"],
    }


def check(st) -> Dict[str, float]:
    got, want = program_readings(st), reference_readings(st)
    keep = ~(got.touched | want.touched)
    g_ch, w_ch = (ref_train.change_norms(r, keep) for r in (got, want))
    for k in want.grad_norms:
        harness.log(f"leaf {k}: first gradient {got.grad_norms[k]:.6g} "
                    f"(reference {want.grad_norms[k]:.6g}), change "
                    f"{g_ch[k]:.6g} (reference {w_ch[k]:.6g})")
    # the pair counts are logged, not judged: a tighter cull that renders
    # the same image is no fault
    harness.log(f"pairs {got.pairs} (reference {want.pairs}); relocated "
                f"{got.relocated} (reference {want.relocated}); relocate's "
                f"invariants: {ref_train.relocate_check(got, want)}")
    return compare(got, want)
