"""Losses and the optimizer of the PyTorch port against the JAX package.

CPU, numpy-seeded inputs given to both sides. Tolerances, with reasons:
  * SSIM gradient cosine >= 0.9999 with max-normalised atol 1e-4, value
    1e-5: the JAX blur is a band-matrix einsum at precision "high"
    (bf16x3, ~1e-6 relative on the moment maps), the port's two fp32
    depthwise convolutions. Near convergence (pred = gt + 1e-3 noise)
    sigma = E[x^2] - mu^2 cancels, the case where rounding once cost the
    JAX package its gradient direction: there the JAX value is ~5e-6
    off the float64 one, and the port's fp32 value is held to its own
    float64 evaluation at 1e-6;
  * PSNR 1e-4 dB (a log of the same fp32 mean);
  * Adam: parameters and moments after 5 masked steps, atol 1e-6 (the
    same fp32 formulas; the bias corrections are fp32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu.models import background as j_bg
from threedgrut_tpu.ops import ssim as j_ssim
from threedgrut_tpu.optimizers import adam as j_adam
from threedgrut_tpu_torch.models import background as t_bg
from threedgrut_tpu_torch.ops import ssim as t_ssim
from threedgrut_tpu_torch.optimizers import adam as t_adam
from torch_port_utils import np32

H, W = 48, 64


def _images(kind, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (1, 3, H, W)).astype(np.float32)
    if kind == "random":
        pred = rng.uniform(0, 1, (1, 3, H, W)).astype(np.float32)
    else:   # near convergence
        pred = np.clip(gt + rng.normal(0, 1e-3, gt.shape), 0, 1).astype(
            np.float32)
    return pred, gt


@pytest.mark.parametrize("kind", ["random", "converged"])
def test_ssim_value_and_grad_match_jax(kind):
    pred, gt = _images(kind)
    j_val, j_grad = jax.value_and_grad(
        lambda p: j_ssim.ssim(p, jnp.asarray(gt)))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    t_val = t_ssim.ssim(p, torch.tensor(gt))
    t_val.backward()
    np.testing.assert_allclose(float(t_val.detach()), float(j_val),
                               atol=1e-5)
    f64 = t_ssim.ssim(torch.tensor(pred, dtype=torch.float64),
                      torch.tensor(gt, dtype=torch.float64))
    np.testing.assert_allclose(float(t_val.detach()), float(f64), atol=1e-6)
    a = p.grad.numpy().astype(np.float64).ravel()
    b = np.asarray(j_grad, np.float64).ravel()
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999
    scale = np.abs(b).max()
    np.testing.assert_allclose(a / scale, b / scale, atol=1e-4, rtol=0)


def test_ssim_map_and_psnr_match_jax():
    pred, gt = _images("random", seed=1)
    np.testing.assert_allclose(
        np32(t_ssim.ssim_map(torch.tensor(pred), torch.tensor(gt))),
        np.asarray(j_ssim.ssim_map(jnp.asarray(pred), jnp.asarray(gt))),
        atol=1e-5)
    assert t_ssim.ssim_map(torch.tensor(pred), torch.tensor(gt)).shape == (
        1, 3, H - 10, W - 10)
    np.testing.assert_allclose(
        float(t_ssim.psnr(torch.tensor(pred), torch.tensor(gt))),
        float(j_ssim.psnr(jnp.asarray(pred), jnp.asarray(gt))), atol=1e-4)


def _adam_inputs(seed=0, cap=64):
    rng = np.random.default_rng(seed)
    shapes = {"positions": (cap, 3), "density": (cap, 1),
              "features_specular": (cap, 45)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 1e-2
              for k, s in shapes.items()} for _ in range(5)]
    vis = [rng.uniform(size=cap) > 0.3 for _ in range(5)]
    active = np.arange(cap) < 50
    lrs = {"positions": 1.6e-4, "density": 0.05, "features_specular": 1.25e-4}
    return params, grads, vis, active, lrs


@pytest.mark.parametrize("selective", [False, True])
def test_adam_five_steps_match_jax(selective):
    params, grads, vis, active, lrs = _adam_inputs()
    j_p = {k: jnp.asarray(v) for k, v in params.items()}
    j_s = j_adam.init_adam_state(j_p)
    t_p = {k: torch.tensor(v) for k, v in params.items()}
    t_s = t_adam.init_adam_state(t_p)
    for i in range(5):
        j_p, j_s = j_adam.adam_step(
            j_p, {k: jnp.asarray(v) for k, v in grads[i].items()}, j_s,
            {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()},
            visibility=jnp.asarray(vis[i]) if selective else None,
            update_mask=jnp.asarray(active))
        t_s = t_adam.adam_step(
            t_p, {k: torch.tensor(v) for k, v in grads[i].items()}, t_s,
            lrs, visibility=torch.tensor(vis[i]) if selective else None,
            update_mask=torch.tensor(active))
    assert t_s.step == int(j_s.step) == 5
    for k in params:
        np.testing.assert_allclose(t_p[k].numpy(), np.asarray(j_p[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
        np.testing.assert_allclose(t_s.exp_avg[k].numpy(),
                                   np.asarray(j_s.exp_avg[k]), atol=1e-6)
        np.testing.assert_allclose(t_s.exp_avg_sq[k].numpy(),
                                   np.asarray(j_s.exp_avg_sq[k]), atol=1e-6)
        # the capacity's dead rows never move
        np.testing.assert_array_equal(t_p[k].numpy()[50:], params[k][50:])


@pytest.mark.parametrize("step", [0, 1, 999, 15000, 30000, 40000])
def test_schedulers_match_jax(step):
    for name, args in (("exp_scheduler", (1.6e-4, 1.6e-6, 30000)),
                       ("cosine_scheduler", (0.015, 0.0015, 30000)),
                       ("constant_scheduler", (0.05,))):
        assert getattr(t_adam, name)(*args)(step) == pytest.approx(
            getattr(j_adam, name)(*args)(step), rel=1e-12)


def test_random_background_is_drawn_in_training():
    cfg = t_bg.BackgroundConfig(color="random")
    g = torch.Generator().manual_seed(0)
    a = t_bg.background_color(cfg, g, train=True)
    b = t_bg.background_color(cfg, g, train=True)
    assert a.shape == (3,) and not torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    # eval (and a call without a generator) is mid-grey, as in JAX
    ref = np.asarray(j_bg.background_color(
        j_bg.BackgroundConfig(color="random"), train=False))
    np.testing.assert_array_equal(t_bg.background_color(cfg).numpy(), ref)
    np.testing.assert_array_equal(
        t_bg.background_color(cfg, None, train=True).numpy(), ref)
