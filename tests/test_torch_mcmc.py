"""The port's MCMC strategy and NHT trainer against the JAX package's, on
the CPU, and the training CLI for the NHT configs.

MCMC draws its targets with torch.multinomial, which cannot give JAX's
categorical draws; relocate and add are held to JAX given the same
targets (JAX's _sample_targets and the port's are replaced by one that
returns them), perturb given the same normal noise, and the sampler
alone by its frequencies. Tolerances, with reasons:
  * compute_relocation 1e-5 relative: the same fp32 power series in
    another library;
  * relocate / add / perturb: parameters and moments within 1e-5
    (relative to 1) of JAX's, counts equal;
  * the NHT trainer's loss over 3 steps within 1e-3 relative: the render
    agrees to ~1e-6, the decoder's bf16 products to ~1e-3 (the decoder
    test's 1e-2 bound is per pixel; a mean loss averages it down);
  * sampling frequencies within 5 standard deviations of a binomial.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_trainer as ttr
from threedgrut_tpu.config.loader import load_config, to_trainer_config
from threedgrut_tpu.models import background as j_bg
from threedgrut_tpu.models.gaussians import GaussianModelConfig as JCfg
from threedgrut_tpu.models.gaussians import (initialize_from_points,
                                             state_from_checkpoint)
from threedgrut_tpu.optimizers.adam import AdamState as JAdamState
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu.strategy import mcmc as j_mcmc
from threedgrut_tpu.train import trainer as j_tr
from threedgrut_tpu_torch.convert import decoder_from_jax, model_from_state
from threedgrut_tpu_torch.models.background import BackgroundConfig
from threedgrut_tpu_torch.models.gaussians import NHT_PARAM_NAMES
from threedgrut_tpu_torch.optimizers.adam import AdamState
from threedgrut_tpu_torch.strategy import mcmc as t_mcmc
from threedgrut_tpu_torch.train import trainer as t_tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_NAMES = {"3dgut": "apps/nerf_synthetic_3dgut_mcmc_nht",
                "3dgrt": "apps/nerf_synthetic_3dgrt_mcmc_nht"}


def test_compute_relocation_matches_jax():
    rng = np.random.default_rng(0)
    op = rng.uniform(0.006, 0.99, 500).astype(np.float32)
    scales = rng.uniform(0.01, 0.3, (500, 3)).astype(np.float32)
    ratios = rng.integers(1, 52, 500).astype(np.int32)
    ref = j_mcmc.compute_relocation(jnp.asarray(op), jnp.asarray(scales),
                                    jnp.asarray(ratios))
    got = t_mcmc.compute_relocation(torch.from_numpy(op),
                                    torch.from_numpy(scales),
                                    torch.from_numpy(ratios))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=0)


def _scene(seed=1):
    """An NHT model, 200 of 256 rows live, a quarter of them nearly
    transparent, and Adam moments of ones (so zeroed rows show)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (200, 3)).astype(np.float32)
    state = initialize_from_points(
        JCfg(feature_type="nht", nht_feature_dim=16), pts, capacity=256,
        seed=seed)
    dens = np.asarray(state.params.density).copy()
    dens[:200] = rng.normal(0.0, 1.0, (200, 1)).astype(np.float32)
    dens[:50] = -8.0                                  # opacity ~3e-4: dead
    state = state.replace(params=state.params.replace(
        density=jnp.asarray(dens)))
    names = NHT_PARAM_NAMES
    j_opt = JAdamState(
        step=jnp.asarray(3, jnp.int32),
        exp_avg={k: jnp.ones_like(getattr(state.params, k)) for k in names},
        exp_avg_sq={k: 2 * jnp.ones_like(getattr(state.params, k))
                    for k in names})
    t_opt = AdamState(
        step=3, exp_avg={k: torch.ones(np.asarray(getattr(
            state.params, k)).shape) for k in names},
        exp_avg_sq={k: 2 * torch.ones(np.asarray(getattr(
            state.params, k)).shape) for k in names})
    return state, j_opt, model_from_state(state), t_opt


def _use_targets(monkeypatch, targets):
    """Both packages' samplers return ``targets``."""
    monkeypatch.setattr(j_mcmc, "_sample_targets",
                        lambda key, probs, n: jnp.asarray(targets))
    monkeypatch.setattr(t_mcmc, "_sample_targets",
                        lambda gen, probs, n: torch.from_numpy(targets))


def _assert_same(state, j_opt, model, t_opt):
    assert model.n_active == int(state.n_active)
    for k in NHT_PARAM_NAMES:
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(getattr(state.params, k)),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
        for got, ref in ((t_opt.exp_avg, j_opt.exp_avg),
                         (t_opt.exp_avg_sq, j_opt.exp_avg_sq)):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(ref[k]), err_msg=k)


def test_relocate_matches_jax_given_targets(monkeypatch):
    state, j_opt, model, t_opt = _scene()
    rng = np.random.default_rng(2)
    # targets among the live rows, some taken several times
    targets = rng.choice(np.arange(50, 120), 256).astype(np.int64)
    _use_targets(monkeypatch, targets)
    j_state, j_opt, j_n = j_mcmc.relocate.__wrapped__(
        state, j_opt, jax.random.PRNGKey(0), opacity_threshold=0.005,
        n_max=51)
    n = t_mcmc.relocate(model, t_opt, torch.Generator(),
                        opacity_threshold=0.005, n_max=51)
    assert n == int(j_n) == 50
    _assert_same(j_state, j_opt, model, t_opt)
    # the moved rows copy their (rescaled) targets
    np.testing.assert_array_equal(model.features[:50].detach().numpy(),
                                  model.features[targets[:50]].detach()
                                  .numpy())


def test_add_gaussians_matches_jax_given_targets(monkeypatch):
    state, j_opt, model, t_opt = _scene(seed=3)
    rng = np.random.default_rng(4)
    targets = rng.choice(np.arange(200), 256).astype(np.int64)
    _use_targets(monkeypatch, targets)
    j_state, j_opt, j_n = j_mcmc.add_gaussians.__wrapped__(
        state, j_opt, jax.random.PRNGKey(0), max_n=1_000_000, n_max=51)
    n = t_mcmc.add_gaussians(model, t_opt, torch.Generator(),
                             max_n=1_000_000, n_max=51)
    # 1.05 * 200 in fp32 is 209.99998: 9 rows
    assert n == int(j_n) == 9 and model.n_active == 209
    _assert_same(j_state, j_opt, model, t_opt)


def test_add_gaussians_stops_at_max_n():
    _, _, model, t_opt = _scene()
    gen = torch.Generator().manual_seed(0)
    assert t_mcmc.add_gaussians(model, t_opt, gen, max_n=204) == 4
    assert model.n_active == 204
    assert t_mcmc.add_gaussians(model, t_opt, gen, max_n=204) == 0


def test_perturb_matches_jax_given_noise(monkeypatch):
    state, _, model, _ = _scene(seed=5)
    noise = np.random.default_rng(6).normal(size=(256, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(noise))
    j_state = j_mcmc.perturb.__wrapped__(state, jax.random.PRNGKey(0),
                                         jnp.float32(1.6e-4), 5e5)
    t_mcmc.perturb(model, torch.Generator(), 1.6e-4, 5e5,
                   noise=torch.from_numpy(noise))
    got = model.positions.detach().numpy()
    ref = np.asarray(j_state.params.positions)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    moved = np.abs(got - np.asarray(state.params.positions)).max(axis=1)
    assert moved[:50].max() > 0.0            # the dead rows move most
    assert moved[200:].max() == 0.0          # the capacity's rows never


def test_sampling_follows_probabilities():
    """_sample_targets draws rows in proportion to the probabilities
    (JAX's categorical over log-probabilities), never a zero one."""
    probs = torch.tensor([0.0, 0.1, 0.2, 0.0, 0.3, 0.4, 0.0])
    gen = torch.Generator().manual_seed(7)
    n = 200_000
    rows = t_mcmc._sample_targets(gen, probs, n)
    freq = torch.bincount(rows, minlength=7).double() / n
    p = probs.double() / probs.sum()
    sigma = torch.sqrt(p * (1 - p) / n)
    assert bool((freq[p == 0] == 0).all())
    assert bool(((freq - p).abs() <= 5 * sigma + 1e-12).all()), freq
    # no live row at all: row 0, as JAX's all -inf categorical
    assert bool((t_mcmc._sample_targets(gen, torch.zeros(4), 9) == 0).all())


def _fields_equal(got, ref, path="", skip=("max_pairs",)):
    """Every field of the port's config dataclass ``got`` that the JAX one
    has, recursively, equal; returns the fields compared."""
    seen = []
    for f in dataclasses.fields(got):
        if f.name in skip or not hasattr(ref, f.name):
            continue
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            seen += _fields_equal(a, b, f"{path}{f.name}.", skip)
        else:
            assert a == b, f"{path}{f.name}: {a} != {b}"
            seen.append(path + f.name)
    return seen


@pytest.mark.parametrize("mode", sorted(CONFIG_NAMES))
def test_trainer_config_matches_jax_loader(mode, capsys):
    """train_torch.trainer_config of both NHT configs against
    config/loader.py's mapping, every field the port has. exact_kill and
    records_bf16 are TPU knobs the port leaves out: it says so where the
    JAX loader would round records to bf16. The NHT configs set
    particle_feature_half, which that loader reads as records_bf16 only
    where records_bf16 is unset, and the render YAMLs set it false."""
    sys.path.insert(0, REPO)
    import train_torch

    conf = load_config(CONFIG_NAMES[mode], overrides=["path=/none"])
    j = to_trainer_config(conf)
    t = train_torch.trainer_config(conf)
    assert conf.render.particle_feature_half is True
    assert j.raster.records_bf16 is False
    assert "bf16" not in capsys.readouterr().err
    seen = _fields_equal(t, j)
    for k in ("strategy", "mcmc.noise_lr", "mcmc.max_n_gaussians",
              "optimizer.lr_features", "optimizer.features_max_steps",
              "nht_warmup_steps", "nht_color_refine_steps",
              "loss.lambda_opacity", "raster.max_alpha", "ut.alpha"):
        assert k in seen, k
    assert t.strategy == "mcmc"
    assert t.nht_warmup_steps == (1000 if mode == "3dgut" else 0)
    bf16 = load_config(CONFIG_NAMES[mode], overrides=[
        "path=/none", "render.records_bf16=true"])
    assert to_trainer_config(bf16).raster.records_bf16 is True
    train_torch.trainer_config(bf16)
    assert "keeps fp32 records" in capsys.readouterr().err


def _nht_trainers(views):
    """A JAX and a port Trainer from the same NHT initialisation, the
    JAX decoder's weights carried to the port; MCMC with no perturb noise
    and its events past the steps run; a 2-step warmup."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.2, 1.2, (96, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(3.0, 5.5, 96)
    state = initialize_from_points(JCfg(feature_type="nht",
                                        nht_feature_dim=16), pts,
                                   capacity=256)
    j_conf = j_tr.TrainerConfig(
        strategy="mcmc", nht_warmup_steps=2,
        raster=JRasterConfig(max_pairs=1 << 13, exact_kill=True,
                             records_bf16=False),
        auto_max_pairs=False, background=j_bg.BackgroundConfig(color="white"))
    j_conf.mcmc = j_conf.mcmc.replace(noise_lr=0.0)
    t_conf = t_tr.TrainerConfig(strategy="mcmc", nht_warmup_steps=2,
                                background=BackgroundConfig(color="white"))
    t_conf.mcmc = t_conf.mcmc.replace(noise_lr=0.0)
    jt = j_tr.Trainer(j_conf, views, state)
    tt = t_tr.Trainer(t_conf, views, model_from_state(state))
    carried = decoder_from_jax(jt.decoder)
    with torch.no_grad():
        for w, src in zip(tt.decoder.weights(), carried.weights()):
            w.copy_(src)
        for s, src in zip(tt.decoder.ema_shadow, carried.ema_shadow):
            s.copy_(src)
    return jt, tt


def test_nht_trainer_three_steps_match_jax():
    views = ttr.Views()
    jt, tt = _nht_trainers(views)
    p0 = tt.model.positions.detach().clone()
    for step in range(3):
        batch = views[step]
        jm = jt.train_iteration(batch)
        tm = tt.train_iteration(batch)
        np.testing.assert_allclose(tm["total"], float(jm["total"]),
                                   rtol=1e-3, err_msg=f"step {step}")
        if step == 1:
            # the warmup froze the geometry, and the features moved
            assert torch.equal(tt.model.positions.detach(), p0)
    assert not torch.equal(tt.model.positions.detach(), p0)
    assert tt.global_step == jt.global_step == 3
    assert tt.opt_state.step == int(jt.opt_state.step)
    lrs, ref = tt.current_lrs(1), jt.current_lrs(1)
    assert set(lrs) == set(ref) and lrs["positions"] == 0.0
    for k in lrs:
        assert lrs[k] == pytest.approx(ref[k], rel=1e-12), k
    # the EMA shadow moved toward the trained weights
    assert not torch.equal(tt.decoder.ema_shadow[0],
                           decoder_from_jax(jt.decoder).ema_shadow[0])
    assert np.isfinite(tt.validate(ttr.Views(n_views=1))["psnr"])


def test_train_cli_refuses_without_gpu(tmp_path, monkeypatch, capsys):
    """No card and no --device: train_torch.py stops, naming the flag,
    before it loads anything."""
    sys.path.insert(0, REPO)
    import train_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [
        "train_torch.py", "--config-name",
        "apps/nerf_synthetic_3dgut_mcmc_nht", f"path={tmp_path}"])
    with pytest.raises(SystemExit, match="--device cpu"):
        train_torch.main()
    assert capsys.readouterr().out == ""


def test_train_cli_nht_mcmc_runs_and_jax_loads_it(tmp_path):
    """apps/nerf_synthetic_3dgut_mcmc_nht trains 4 steps on the CPU and
    its checkpoint, decoder included, loads into the JAX trainer."""
    data = str(tmp_path / "lego_mini")
    ttr._write_nerf_dataset(data)
    out = str(tmp_path / "out")
    res = subprocess.run(
        [sys.executable, "train_torch.py", "--config-name",
         "apps/nerf_synthetic_3dgut_mcmc_nht", "--device", "cpu",
         f"path={data}", "n_iterations=4", "initialization.num_gaussians=300",
         "strategy.add.max_n_gaussians=2000", f"out_dir={out}",
         "experiment_name=nht", "log_frequency=0.04"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "step 4:" in res.stdout
    ckpt = os.path.join(out, "nht", "ckpt_last.npz")
    state = state_from_checkpoint(ckpt, JCfg(feature_type="nht",
                                             nht_feature_dim=48))
    assert int(state.n_active) == 300
    conf = j_tr.TrainerConfig(strategy="mcmc")
    jt = j_tr.Trainer(conf, ttr.Views(n_views=1), state)
    jt.load_checkpoint(ckpt)
    assert jt.global_step == 4
    with np.load(ckpt) as f:
        for i in range(4):
            key = f"params/nht_decoder//params/Dense_{i}/kernel"
            np.testing.assert_array_equal(
                np.asarray(jt.decoder.params["params"][f"Dense_{i}"]
                           ["kernel"]), f[key])
    with open(os.path.join(out, "nht", "final_metrics.json")) as f:
        assert np.isfinite(json.load(f)["psnr"])
