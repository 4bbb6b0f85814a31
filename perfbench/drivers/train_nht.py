"""Closed-loop training of an NHT model (3DGUT with Neural Harmonic
Textures): ``drivers/train.py``'s loop, views, window and check, over a
model whose particles carry control features and whose rays are decoded
by the trainer's MLP.

Set-up checks the configuration file against the published app as the
port composes it and against the decoder the port builds; builds the
trainer over the seed's stand-in cloud with control features drawn
uniformly in [init_min, init_max] (``nht_cloud``), keeps the decoder's
first weights for the reference, and drives the checked steps. The
check holds the steps to ``reference/nht.py``: ``train.py``'s loss,
gradient, change and relocate numbers, the decoder's 4 weights among
the leaves, the EMA shadow's change (``ema_gap``) and the first view's
decoded image before the steps (``rgb_gap``). A traced run
also reduces its capture by span (``perfbench/spans.py``), which the
decoder's roofline reads.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import harness, program, scene, spans
from perfbench.drivers import train as base
from perfbench.reference import nht as ref_nht
from perfbench.reference import render as ref
from perfbench.reference import train as ref_train

Feed = base.Feed
reference_views = base.reference_views
window = base.window
end_to_end = base.end_to_end
release = base.release
_step = base._step
# perfbench.spans steps a driver named "train" by _step, others by _request
_request = _step


def trainer_config(conf: dict, seed: int):
    """``program.trainer_config``, and the file's ``nht`` and render half
    flags against the app's composed configuration and against the
    decoder the port builds; raises where any differs."""
    tc = program.trainer_config(conf, seed)
    from threedgrut_tpu_torch.config.loader import load_config
    from threedgrut_tpu_torch.models import nht_decoder
    from threedgrut_tpu_torch.train import trainer as trainer_mod
    from train_torch import nht_features

    app = load_config(conf["app"], overrides=[
        "path=none", *conf.get("app_overrides", [])])
    feats = nht_features(app)
    nf, nd = app.model.nht_features, app.model.nht_decoder
    got = {
        "feature_type": feats.feature_type.value, "dim": feats.nht_dim,
        "activation": feats.activation.name.lower(),
        "num_frequencies": feats.num_frequencies,
        "interpolation": nf.interpolation_type,
        "init_min": nf.init_min, "init_max": nf.init_max,
        "features_lr": tc.optimizer.lr_features,
        "features_decay_final": tc.optimizer.features_decay_final,
        "features_max_steps": tc.optimizer.features_max_steps,
        "color_refine_steps": tc.nht_color_refine_steps,
        "warmup_steps": tc.nht_warmup_steps,
        "decoder": {
            "hidden_dim": nd.hidden_dim, "num_layers": nd.num_layers,
            "dir_encoding": nd.dir_encoding,
            "dir_encoding_degree": nd.dir_encoding_degree,
            "sh_scale": nd.sh_scale,
            "output_activation": nd.output_activation,
            "learning_rate": nd.learning_rate,
            "decay_final": nd.scheduler.decay_final,
            "max_steps": nd.scheduler.max_steps,
            "ema_decay": nd.ema_decay, "ema_start_step": nd.ema_start_step}}
    # the port's decoder is built at fixed sizes and rates
    port = {"hidden_dim": nht_decoder.HIDDEN_DIM,
            "num_layers": nht_decoder.NUM_LAYERS,
            "dir_encoding_degree": nht_decoder.DIR_ENCODING_DEGREE,
            "sh_scale": nht_decoder.SH_SCALE,
            "learning_rate": trainer_mod.DECODER_LR,
            "decay_final": 0.1, "max_steps": tc.optimizer.features_max_steps,
            "ema_decay": nht_decoder.EMA_DECAY, "ema_start_step": 0}
    n, dec = conf["nht"], conf["nht"]["decoder"]
    diffs = [f"nht.{k}: app {got[k]} != file {n[k]}" for k in got
             if k != "decoder" and not program._same(got[k], n[k])]
    diffs += [f"nht.decoder.{k}: app {v} != file {dec[k]}"
              for k, v in got["decoder"].items()
              if not program._same(v, dec[k])]
    diffs += [f"nht.decoder.{k}: the port's {v} != file {dec[k]}"
              for k, v in port.items() if not program._same(v, dec[k])]
    diffs += [f"render.{k}: app {app.render.get(k)} != file "
              f"{conf['render'][k]}"
              for k in ("particle_feature_half", "feature_output_half")
              if app.render.get(k) != conf["render"][k]]
    if diffs:
        raise SystemExit(f"{conf['app']} differs from {conf['name']}'s "
                         "file: " + "; ".join(diffs))
    return tc


def nht_cloud(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The stand-in cloud's geometry (``scene.standin_cloud``) with control
    features in place of SH: ``nht.dim`` a row, uniform in [init_min,
    init_max] as the NHT initialisation draws them, from the seed."""
    params = scene.standin_cloud(conf["rows"], seed, device)
    del params["features_albedo"], params["features_specular"]
    n = conf["nht"]
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    params["features"] = n["init_min"] + (n["init_max"] - n["init_min"]) \
        * torch.rand((conf["rows"], n["dim"]), generator=gen, device=device)
    return params


def nht_model(params: Dict[str, torch.Tensor], dim: int):
    """The port's NHT model over raw parameters (every row active)."""
    from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                       GaussianModelConfig)

    return GaussianModel(params, n_active=params["positions"].shape[0],
                         n_active_features=0, config=GaussianModelConfig(
                             feature_type="nht", nht_feature_dim=dim))


def setup(ctx) -> dict:
    conf, dev, seed = ctx.cell.config, ctx.device, ctx.seed
    sw = harness.Stopwatch()
    tconf = trainer_config(conf, seed)
    sw.lap("config")
    poses = scene.views(conf, "train")
    ref_views = reference_views(conf, poses, dev, seed)
    sw.lap("views' images")
    capture = program.Capture([
        program.View(p.c2w, p.intrinsics, img)
        for p, (_, img) in zip(poses, ref_views)])
    model = nht_model(nht_cloud(conf, seed, dev), conf["nht"]["dim"])
    from threedgrut_tpu_torch.train.trainer import Trainer

    trainer = Trainer(tconf, capture, model)
    trainer.global_step = conf["start_step"]
    feed = Feed(len(capture), seed, conf["start_step"])
    sw.lap("cloud and trainer")
    program.warm_strategy(tconf, dev)
    sw.lap("strategy warm-up")
    st = {"trainer": trainer, "capture": capture, "feed": feed,
          "ref_views": ref_views, "frames": [], "losses": [], "pairs": [],
          "conf": conf, "seed": seed, "device": dev,
          "decoder_init": [w.detach().to("cpu", copy=True)
                           for w in trainer.decoder.weights()]}
    # the checked steps, read as drivers/train.py reads them; the EMA
    # shadow's change too
    params = trainer.params()
    init = {k: p.detach().clone() for k, p in params.items()}
    shadow0 = [s.clone() for s in trainer.decoder.ema_shadow]
    b1 = conf["train"]["betas"][0]
    for i in range(ctx.cell.traffic["checked_steps"]):
        idx = feed.next()
        if i == 0:
            st["rgb"] = decoded_image(trainer, capture[idx])
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
    st["ema_change"] = {ref_nht.decoder_key(i): (s - s0).cpu() for i, (s, s0)
                        in enumerate(zip(trainer.decoder.ema_shadow,
                                         shadow0))}
    st["touched"] = (trainer.opt_state.exp_avg["density"] == 0).all(1).cpu()
    st["relocated"] = sum(int(e[2]["n_relocated"])
                          for e in trainer.event_stats if e[1] == "relocate")
    st["rows"] = ref_nht.row_summary(trainer.model.params())
    sw.lap("checked steps")
    for _ in range(ctx.cell.traffic["warmup_steps"]):
        idx = feed.next()
        trainer.train_iteration(capture[idx], frame_idx=idx)
    torch.cuda.synchronize() if dev.type == "cuda" else None
    sw.lap("warm-up steps")
    sw.report("set-up")
    return st


@torch.no_grad()
def decoded_image(trainer, view) -> torch.Tensor:
    """The trainer's decoded colour [H, W, 3] of ``view`` in its present
    state (its render and ``Trainer.decode``, as its loss takes them), on
    the host."""
    from threedgrut_tpu_torch.render.gut import render_gut
    from threedgrut_tpu_torch.train.trainer import camera_from_batch

    out = render_gut(camera_from_batch(view, trainer.device),
                     trainer.conf.ut, trainer.conf.raster, trainer.model,
                     trainer.sh_degree())
    return trainer.decode(out).cpu()


def _nht_counters() -> Dict[str, int]:
    """The port's NHT counters: the raster's NHT launches and the rows the
    decoder decoded (absent where the port has no such counter)."""
    from threedgrut_tpu_torch.models import nht_decoder
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles, rasterize_tiles_backward)

    out = {"raster_fwd_nht": rasterize_tiles.launches_nht,
           "raster_bwd_nht": rasterize_tiles_backward.launches_nht}
    rows = getattr(getattr(nht_decoder, "mlp", None), "rows", None)
    if rows is not None:
        out["decoded_rows"] = rows
    return out


def trace(st, n: int) -> dict:
    """Profile ``n`` steps (after one pad step) in one capture, reduced by
    kernel (``harness.reduce_trace``) and by span (``spans.reduce_spans``,
    under ``spans``); keep their views and starting parameters for the
    counts, and log the NHT counters a step."""
    feed = st["feed"]
    peek = Feed(feed.n, feed.seed, feed.step)
    peek.order = list(feed.order)
    peek.next()
    st["profiled_frames"] = [peek.next() for _ in range(n)]
    st["profiled_params"] = {k: v.detach().to("cpu", copy=True)
                             for k, v in st["trainer"].model.params().items()}
    before = _nht_counters()
    events = spans.profile_events(lambda: _step(st), n)
    after = _nht_counters()
    harness.log("NHT counters a step (the pad step included): " + ", ".join(
        f"{k} {(after[k] - before[k]) / (n + 1):.6g}" for k in after))
    records = harness.reduce_trace(events, n)
    records["spans"] = spans.reduce_spans(events, n)
    return records


def counts(st) -> List[dict]:
    """The reference's count of the contributing evaluations of each
    profiled step's view, with the decoded pixels and the rows."""
    conf, dev = st["conf"], st["device"]
    params = {k: v.to(dev) for k, v in st.pop("profiled_params").items()}
    s = ref.settings_from(conf)
    out = []
    for f in st["profiled_frames"]:
        cam, _ = st["ref_views"][f]
        c = ref_nht.count_view(params, cam, s)
        out.append({"evals": c["evals"],
                    "particles": int(c["particles"].sum()),
                    "pixels": cam.width * cam.height,
                    "rows": params["positions"].shape[0],
                    "features": params["features"].shape[1]})
    return out


def program_readings(st) -> ref_nht.Readings:
    return ref_nht.Readings(
        ref_train.StepReadings(st["losses"], st["pairs"], st["grad_norms"],
                               st["change"], st["touched"], st["relocated"],
                               st["rows"]), st["ema_change"], st["rgb"])


def reference_readings(st, precision: str = "fp32",
                       fault=None) -> ref_nht.Readings:
    """The reference's steps from the seed's state and the decoder's first
    weights on the checked steps' views."""
    conf, dev = st["conf"], st["device"]
    extent = ref_train.scene_extent([p.c2w for p in
                                     scene.views(conf, "train")])
    return ref_nht.train_steps(
        nht_cloud(conf, st["seed"], dev),
        [w.to(dev) for w in st["decoder_init"]], st["ref_views"],
        st["frames"], ref_train.spec_from(conf), ref_nht.nht_spec_from(conf),
        conf["start_step"], extent, st["seed"], precision, fault)


def compare(got: ref_nht.Readings, want: ref_nht.Readings
            ) -> Dict[str, float]:
    """``drivers/train.py``'s numbers over every leaf, the decoder's
    included; the worst decoder layer's EMA-shadow change norm against
    the reference's (``train.leaf_gap``); and the first view's decoded
    image before any step, its distance from the reference's over the
    reference's norm (``rgb_gap``: the decoder's precision, which the
    numbers after Adam's first, sign-like step do not part from bf16's)."""
    out = base.compare(got.steps, want.steps)
    out["rgb_gap"] = float(torch.linalg.vector_norm(got.rgb - want.rgb)
                           / torch.linalg.vector_norm(want.rgb))
    norm = {k: float(torch.linalg.vector_norm(v)) for k, v in
            want.ema_change.items()}
    out["ema_gap"] = ref_train.leaf_gap(
        {k: float(torch.linalg.vector_norm(v))
         for k, v in got.ema_change.items()}, norm)
    return out


def check(st) -> Dict[str, float]:
    got, want = program_readings(st), reference_readings(st)
    keep = ~(got.steps.touched | want.steps.touched)
    g_ch, w_ch = (ref_train.change_norms(r.steps, keep) for r in (got, want))
    for k in want.steps.grad_norms:
        harness.log(f"leaf {k}: first gradient {got.steps.grad_norms[k]:.6g} "
                    f"(reference {want.steps.grad_norms[k]:.6g}), change "
                    f"{g_ch[k]:.6g} (reference {w_ch[k]:.6g})")
    harness.log(f"losses {got.steps.losses} (reference {want.steps.losses}); "
                f"pairs {got.steps.pairs} (reference {want.steps.pairs}); "
                f"relocated {got.steps.relocated} (reference "
                f"{want.steps.relocated})")
    return compare(got, want)
