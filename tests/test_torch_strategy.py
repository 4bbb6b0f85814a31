"""GS strategy and model initialisation of the PyTorch port against the
JAX package.

CPU. Each strategy event runs on the same state in both packages; the
split samples take JAX's own normals (``jax.random.normal`` under the
keys ``densify`` splits its key into), fed to the port's ``densify``.
Tolerance: ``n_active`` equal, every capacity row of the parameters, the
Adam moments and the gradient buffers within 1e-6 (the same fp32
formulas; the split offsets are a 3x3 rotation of the normals, summed in
another order). Initialisation draws the same numpy arrays: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu.models import gaussians as j_gauss
from threedgrut_tpu.optimizers.adam import AdamState as JAdamState
from threedgrut_tpu.strategy import base as j_base
from threedgrut_tpu.strategy import gs as j_gs
from threedgrut_tpu_torch.convert import model_from_state
from threedgrut_tpu_torch.models import gaussians as t_gauss
from threedgrut_tpu_torch.models.gaussians import PARAM_NAMES
from threedgrut_tpu_torch.optimizers.adam import AdamState
from threedgrut_tpu_torch.strategy import base as t_base
from threedgrut_tpu_torch.strategy import gs as t_gs

CAP, N = 512, 300
EXTENT = 2.0


def _jax_state(seed=0):
    """A GS state with a mix of small and big, dense and faint particles,
    random moments and accumulated gradient norms."""
    rng = np.random.default_rng(seed)
    cfg = j_gauss.GaussianModelConfig()
    state = j_gauss.random_initialization(cfg, N, extent=EXTENT, seed=seed,
                                          capacity=CAP)
    p = state.params
    scale = np.asarray(p.scale).copy()
    scale[:N] = np.log(rng.uniform(0.005, 0.05, (N, 3))).astype(np.float32)
    dens = np.asarray(p.density).copy()
    dens[:N] = rng.normal(-2.0, 2.5, (N, 1)).astype(np.float32)
    rot = rng.normal(size=(CAP, 4)).astype(np.float32)
    state = state.replace(params=p.replace(
        scale=jnp.asarray(scale), density=jnp.asarray(dens),
        rotation=jnp.asarray(rot)))
    names = [k for k in PARAM_NAMES]
    params = {k: np.asarray(getattr(state.params, k)) for k in names}
    m = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-3
         for k, v in params.items()}
    v = {k: rng.uniform(size=v.shape).astype(np.float32) * 1e-6
         for k, v in params.items()}
    accum = np.zeros(CAP, np.float32)
    denom = np.zeros(CAP, np.int32)
    accum[:N] = rng.uniform(0, 8e-4, N)
    denom[:N] = rng.integers(0, 4, N)
    return state, (m, v, 7), (accum, denom)


def _both(seed=0):
    state, (m, v, step), (accum, denom) = _jax_state(seed)
    j_opt = JAdamState(step=jnp.asarray(step, jnp.int32),
                       exp_avg={k: jnp.asarray(a) for k, a in m.items()},
                       exp_avg_sq={k: jnp.asarray(a) for k, a in v.items()})
    j_buf = j_gs.GSBuffers(jnp.asarray(accum), jnp.asarray(denom))
    model = model_from_state(state)
    t_opt = AdamState(step=step,
                      exp_avg={k: torch.tensor(a) for k, a in m.items()},
                      exp_avg_sq={k: torch.tensor(a) for k, a in v.items()})
    t_buf = t_gs.GSBuffers(torch.tensor(accum), torch.tensor(denom))
    return (state, j_opt, j_buf), (model, t_opt, t_buf)


def assert_same(j_state, j_opt, model, t_opt, j_buf=None, t_buf=None):
    assert model.n_active == int(j_state.n_active)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(getattr(j_state.params, k)),
                                   atol=1e-6, rtol=0, err_msg=k)
        np.testing.assert_allclose(t_opt.exp_avg[k].numpy(),
                                   np.asarray(j_opt.exp_avg[k]), atol=1e-6)
        np.testing.assert_allclose(t_opt.exp_avg_sq[k].numpy(),
                                   np.asarray(j_opt.exp_avg_sq[k]),
                                   atol=1e-6)
    if j_buf is not None:
        np.testing.assert_allclose(t_buf.grad_norm_accum.numpy(),
                                   np.asarray(j_buf.grad_norm_accum),
                                   atol=1e-6)
        np.testing.assert_array_equal(t_buf.grad_norm_denom.numpy(),
                                      np.asarray(j_buf.grad_norm_denom))


def test_densify_matches_jax():
    (js, jo, jb), (model, to, tb) = _both(0)
    key = jax.random.PRNGKey(3)
    js, jo, jb, j_stats = j_gs.densify(js, jo, jb, EXTENT, key, n_split=2)
    noise = torch.tensor(np.stack([
        np.asarray(jax.random.normal(k, (CAP, 3)))
        for k in jax.random.split(key, 2)]))
    tb, t_stats = t_gs.densify(model, to, tb, EXTENT, n_split=2,
                               noise=noise)
    assert t_stats == {k: int(v) for k, v in j_stats.items()}
    assert t_stats["n_cloned"] > 0 and t_stats["n_split"] > 0
    assert_same(js, jo, model, to, jb, tb)


def test_densify_drops_past_capacity():
    (js, jo, jb), (model, to, tb) = _both(1)
    accum = np.full(CAP, 1e-2, np.float32)
    denom = np.ones(CAP, np.int32)
    jb = j_gs.GSBuffers(jnp.asarray(accum), jnp.asarray(denom))
    tb = t_gs.GSBuffers(torch.tensor(accum), torch.tensor(denom))
    key = jax.random.PRNGKey(0)
    js, jo, jb, j_stats = j_gs.densify(js, jo, jb, EXTENT, key, n_split=2)
    noise = torch.tensor(np.stack([
        np.asarray(jax.random.normal(k, (CAP, 3)))
        for k in jax.random.split(key, 2)]))
    tb, t_stats = t_gs.densify(model, to, tb, EXTENT, n_split=2,
                               noise=noise)
    assert t_stats["n_dropped"] == int(j_stats["n_dropped"]) > 0
    assert model.n_active == CAP
    assert_same(js, jo, model, to, jb, tb)


def test_prune_opacity_matches_jax():
    (js, jo, jb), (model, to, tb) = _both(2)
    js, jo, jb, j_n = j_gs.prune_opacity(js, jo, jb, 0.005)
    tb, t_n = t_gs.prune_opacity(model, to, tb, 0.005)
    assert t_n == int(j_n) > 0
    assert_same(js, jo, model, to, jb, tb)


def test_prune_scale_matches_jax():
    (js, jo, jb), (model, to, tb) = _both(3)
    normals = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    js, jo, jb, j_n = j_gs.prune_scale(js, jo, jb, jnp.asarray(normals),
                                       400.0, 1.0)
    tb, t_n = t_gs.prune_scale(model, to, tb, torch.tensor(normals), 400.0,
                               1.0)
    assert t_n == int(j_n)
    assert_same(js, jo, model, to, jb, tb)


def test_reset_and_decay_density_match_jax():
    (js, jo, _), (model, to, _) = _both(4)
    js, jo = j_gs.reset_density(js, jo, 0.01)
    t_gs.reset_density(model, to, 0.01)
    assert_same(js, jo, model, to)
    dens = model.get_density().detach()[:model.n_active]
    assert float(dens.max()) <= 0.01 + 1e-7
    js = j_gs.decay_density(js, 0.99)
    t_gs.decay_density(model, 0.99)
    assert_same(js, jo, model, to)


def test_gradient_buffer_matches_jax():
    rng = np.random.default_rng(5)
    grad = rng.normal(size=(CAP, 3)).astype(np.float32) * 1e-4
    grad[::3] = 0.0
    pos = rng.normal(size=(CAP, 3)).astype(np.float32)
    sensor = np.asarray([0.1, -0.2, -4.0], np.float32)
    jb = j_gs.update_gradient_buffer(j_gs.init_buffers(CAP),
                                     jnp.asarray(grad), jnp.asarray(pos),
                                     jnp.asarray(sensor))
    tb = t_gs.update_gradient_buffer(t_gs.init_buffers(CAP),
                                     torch.tensor(grad), torch.tensor(pos),
                                     torch.tensor(sensor))
    np.testing.assert_allclose(tb.grad_norm_accum.numpy(),
                               np.asarray(jb.grad_norm_accum), atol=1e-9)
    np.testing.assert_array_equal(tb.grad_norm_denom.numpy(),
                                  np.asarray(jb.grad_norm_denom))


def test_append_rows_and_compact_match_jax():
    (js, jo, _), (model, to, _) = _both(6)
    mask = np.zeros(CAP, bool)
    mask[[3, 40, 77, 150]] = True
    new_pos = np.random.default_rng(1).normal(size=(CAP, 3)).astype(
        np.float32)
    js, jo, j_drop = j_base.append_rows(
        js, jo, {"positions": jnp.asarray(new_pos)}, jnp.asarray(mask))
    t_drop = t_base.append_rows(model, to,
                                {"positions": torch.tensor(new_pos)},
                                torch.tensor(mask))
    assert t_drop == int(j_drop) == 0
    assert_same(js, jo, model, to)
    keep = (np.arange(CAP) < model.n_active) & (np.arange(CAP) % 3 != 0)
    js, jo = j_base.compact(js, jo, jnp.asarray(keep))
    t_base.compact(model, to, torch.tensor(keep))
    assert_same(js, jo, model, to)


@pytest.mark.parametrize("step,start,end,freq", [
    (0, 0, 10, 1), (5, 0, 10, 5), (10, 0, 10, 5), (300, 500, 15000, 300),
    (600, 500, 15000, 300), (600, -1, -1, 100), (250, 240, 260, 250),
    (7, 0, -1, 7), (7, 0, -1, 0)])
def test_check_step_condition_matches_jax(step, start, end, freq):
    assert t_base.check_step_condition(step, start, end, freq) == \
        j_base.check_step_condition(step, start, end, freq)


def test_prune_weight_matches_jax():
    """prune_weight, ported with the blend-weight telemetry kernel, keeps
    the rows, moments and gradient buffers JAX gs.prune_weight keeps."""
    (js, jo, jb), (model, to, tb) = _both(7)
    wmax = np.random.default_rng(7).uniform(0.0, 0.03, CAP).astype(
        np.float32)
    js, jo, jb, j_n = j_gs.prune_weight(js, jo, jb, jnp.asarray(wmax), 0.01)
    tb, t_n = t_gs.prune_weight(model, to, tb, torch.tensor(wmax), 0.01)
    assert t_n == int(j_n) > 0
    assert_same(js, jo, model, to, jb, tb)


@pytest.mark.parametrize("n,headroom", [(1, 1.0), (1000, 1.0), (100_000, 4.0),
                                        (30_000, 2.5)])
def test_default_capacity_matches_jax(n, headroom):
    assert t_gauss.default_capacity_for(n, headroom) == \
        j_gauss.default_capacity_for(n, headroom)


def test_random_initialization_equals_jax():
    cfg = j_gauss.GaussianModelConfig()
    js = j_gauss.random_initialization(cfg, 1000, extent=3.7, seed=42,
                                       capacity=4096)
    model = t_gauss.random_initialization(t_gauss.GaussianModelConfig(),
                                          1000, extent=3.7, seed=42,
                                          capacity=4096)
    assert model.n_active == int(js.n_active) == 1000
    assert model.n_active_features == int(js.n_active_features) == 0
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(),
                                      np.asarray(getattr(js.params, k)),
                                      err_msg=k)


def test_initialize_from_points_equals_jax():
    """kNN scales (scipy) and integer colors in 0..255. Equal, except
    that the log-scales of arbitrary kNN distances may differ in the last
    bit: XLA's and PyTorch's fp32 log round differently (1 ulp)."""
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (200, 3)).astype(np.float32)
    cfg = j_gauss.GaussianModelConfig(max_sh_degree=2)
    js = j_gauss.initialize_from_points(cfg, pts, cols, capacity=512,
                                        seed=5)
    model = t_gauss.initialize_from_points(
        t_gauss.GaussianModelConfig(max_sh_degree=2), pts, cols,
        capacity=512, seed=5)
    for k in PARAM_NAMES:
        got = getattr(model, k).detach().numpy()
        ref = np.asarray(getattr(js.params, k))
        if k == "scale":
            np.testing.assert_allclose(got, ref, rtol=2.4e-7, atol=0)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)
