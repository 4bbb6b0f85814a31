"""The port's PPISP (models/ppisp.py and the
trainer's PPISP parts) against the JAX package's.

CPU. Inputs come from a numpy seed. Tolerances, with reasons:
  * the ISP forward within 1e-5 and its gradients within 1e-5 of the
    largest, max-normalised: both are fp32 chains of elementwise
    operations whose sums run in another order (~1e-6 seen). Where the
    function itself is ill-conditioned in fp32 (a pre-CRF value of
    0.9991 under a shoulder of 0.63: 1 - x loses ~7e-5 of its relative
    precision, and the slope of (1 - x)^0.63 grows without bound), both
    packages' gradients lie 2-7e-5 from the float64 value (the same
    chain in float64). So an element where JAX's gradient is itself more
    than 1e-5 (max-normalised) off the float64 one holds the port to the
    float64 value within 1e-4 instead; a few elements of a view;
  * the controller within 1e-5 on JAX's initial weights, carried across
    by ``convert.controller_from_flax`` (the port cannot draw flax's
    random weights): fp32 products of widths 3 to 1601;
  * five distillation Adam steps: each step's loss, and the controller's
    predictions after them, within 1e-5. Not the weights one by one:
    Adam moves a weight by ~lr = 1e-3 whatever its gradient's size, so
    a gradient of ~1e-9 (a ReLU's dead input; fp32 sums of other orders
    differ there by up to 6% of it) moves its weight by another ~1e-4;
    those weights barely touch the outputs;
  * the trainer: PPISP tables after three steps within 1e-5 (Adam at
    1e-3 from the render's ~1e-5 relative gradient differences), the
    controller after a short distillation within 1e-4 (the renders it
    fits differ by ~1e-5), validation PSNR within 1e-3 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainer import STEPS, Views, _trainers
from threedgrut_tpu.train import trainer as j_tr
from threedgrut_tpu.models import ppisp as j_ppisp
from threedgrut_tpu_torch.convert import (controller_from_flax,
                                          controller_to_flax)
from threedgrut_tpu_torch.models import ppisp as t_ppisp
from threedgrut_tpu_torch.train import trainer as t_tr

TOL = 1e-5


def _isp_params(rng, n_frames=3):
    """Non-identity ISP tables: exposures of -1, +1 and 0.3 stops,
    colour latents, responsivity, off-centre vignetting that darkens,
    and a CRF away from its zero start."""
    return {
        "exposure": np.array([-1.0, 1.0, 0.3], np.float32)[:n_frames],
        "color_latents": (rng.normal(size=(n_frames, 8)) * 0.5).astype(
            np.float32),
        "responsivity": np.array([0.2], np.float32),
        "vig_center": (rng.normal(size=(1, 3, 2)) * 0.1).astype(np.float32),
        "vig_alpha": (rng.normal(size=(1, 3, 3)) * 0.3 - 0.3).astype(
            np.float32),
        "crf": (rng.normal(size=(1, 3, 4)) * 0.5).astype(np.float32),
    }


def _max_norm_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


ILL_TOL = 1e-4


def _grad_close(got, ref, f64):
    """``got`` within TOL of JAX's ``ref`` (max-normalised), except where
    ``ref`` itself is over TOL off the float64 ``f64``: there within
    ILL_TOL of ``f64``. Returns (ok, count of such elements)."""
    got, ref, f64 = (np.asarray(a, np.float64) for a in (got, ref, f64))
    scale = max(np.abs(ref).max(), 1e-30)
    ill = np.abs(ref - f64) > TOL * scale
    ok = (np.all(np.abs(got - ref)[~ill] <= TOL * scale)
          and np.all(np.abs(got - f64)[ill] <= ILL_TOL * scale))
    return ok, int(ill.sum())


def _grads_jax(fn, *args):
    return jax.jit(jax.grad(fn, argnums=tuple(range(len(args)))))(*args)


@pytest.fixture(scope="module")
def jax_controller():
    """JAX's controller at the trainer's seed (42); flax's init takes
    ~6 s on the CPU, so the tests share it."""
    return j_ppisp.PPISPControllerCNN(seed=42)


def test_homography_matches_jax():
    rng = np.random.default_rng(0)
    lat = np.concatenate([np.zeros((1, 8)), rng.normal(size=(6, 8)) * 0.4,
                          rng.normal(size=(1, 8)) * 2.0]).astype(np.float32)
    ref = np.asarray(j_ppisp.compute_homography(jnp.asarray(lat)))
    got = t_ppisp.compute_homography(torch.tensor(lat)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got[0], np.eye(3), atol=1e-6)
    w = np.linspace(0.5, 1.5, 9, dtype=np.float32).reshape(3, 3)
    g_ref, = _grads_jax(
        lambda x: jnp.sum(j_ppisp.compute_homography(x) * w),
        jnp.asarray(lat))
    x = torch.tensor(lat, requires_grad=True)
    (t_ppisp.compute_homography(x) * torch.tensor(w)).sum().backward()
    assert np.isfinite(x.grad.numpy()).all()
    assert _max_norm_err(x.grad.numpy(), g_ref) <= TOL


def test_crf_matches_jax():
    """Below and above the centre, on the clamps (0 and 1) and beyond
    them: forward and the gradients of the input and the raw parameters,
    finite where both branches are computed."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-0.5, 1.5, (40, 3)),
                        [[0.0, 1.0, 0.5], [1e-9, 1 - 1e-7, 2.0]]]).astype(
        np.float32)
    crf = (rng.normal(size=(3, 4)) * 0.7).astype(np.float32)
    ref = np.asarray(j_ppisp.apply_crf(jnp.asarray(x), jnp.asarray(crf)))
    xt = torch.tensor(x, requires_grad=True)
    ct = torch.tensor(crf, requires_grad=True)
    got = t_ppisp.apply_crf(xt, ct)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=TOL, rtol=0)
    g_x, g_c = _grads_jax(lambda a, b: jnp.sum(j_ppisp.apply_crf(a, b)),
                          jnp.asarray(x), jnp.asarray(crf))
    got.sum().backward()
    for name, g, r in (("x", xt.grad, g_x), ("crf", ct.grad, g_c)):
        assert np.isfinite(g.numpy()).all(), name
        assert _max_norm_err(g.numpy(), r) <= TOL, name


@jax.jit
def _jax_isp(params, rgb, kw, frame, weight):
    """JAX's ISP image and the gradients of sum(image * weight) by the
    tables, the image and the overrides; one compile for the frames."""
    def loss(p, x, k):
        return jnp.sum(j_ppisp.apply_ppisp_full(p, x, 0, frame, **k) * weight)

    return (j_ppisp.apply_ppisp_full(params, rgb, 0, frame, **kw),
            jax.grad(loss, argnums=(0, 1, 2))(params, rgb, kw))


@pytest.mark.parametrize("frame", [0, 1, 2, "controller"])
def test_isp_matches_jax(frame):
    """apply_ppisp_full on an odd 13x17 image with HDR values up to 2.5,
    per frame (exposure -1, +1, 0.3 stops) and with the controller's
    overrides: the image within 1e-5, and the gradients of the image and
    of every table within 1e-5 max-normalised, all finite."""
    rng = np.random.default_rng(2)
    params = _isp_params(rng)
    rgb = rng.uniform(0.0, 2.5, (13, 17, 3)).astype(np.float32)
    weight = np.linspace(0.2, 1.0, 3, dtype=np.float32)
    kw_np = {}
    idx = frame
    if frame == "controller":
        idx = 0
        kw_np = dict(exposure=np.float32(0.7),
                     color_latents=(rng.normal(size=8) * 0.3).astype(
                         np.float32))
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_kw = {k: jnp.asarray(v) for k, v in kw_np.items()}
    ref, (g_p, g_x, g_kw) = _jax_isp(j_params, jnp.asarray(rgb), j_kw,
                                     jnp.asarray(idx, jnp.int32),
                                     jnp.asarray(weight))
    ref = np.asarray(ref)

    t_params = {k: torch.tensor(v, requires_grad=True)
                for k, v in params.items()}
    t_kw = {k: torch.tensor(v, requires_grad=True) for k, v in kw_np.items()}
    x = torch.tensor(rgb, requires_grad=True)
    got = t_ppisp.apply_ppisp_full(t_params, x, 0, idx, **t_kw)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=TOL, rtol=0)
    (got * torch.tensor(weight)).sum().backward()
    # the same chain in float64: the gradients without fp32 rounding
    leaves64 = [torch.tensor(np.asarray(v, np.float64), requires_grad=True)
                for v in (*params.values(), *kw_np.values(), rgb)]
    p64 = dict(zip(params, leaves64))
    kw64 = dict(zip(kw_np, leaves64[len(params):]))
    (t_ppisp.apply_ppisp_full(p64, leaves64[-1], 0, idx, **kw64)
     * torch.tensor(np.float64(weight))).sum().backward()
    f64 = dict(zip([*params, *kw_np, "rgb"], (v.grad for v in leaves64)))
    grads = {**{k: (t_params[k].grad, g_p[k]) for k in params},
             **{k: (t_kw[k].grad, g_kw[k]) for k in kw_np},
             "rgb": (x.grad, g_x)}
    for k, (g, r) in grads.items():
        g = np.zeros(np.shape(r), np.float32) if g is None else g.numpy()
        assert np.isfinite(g).all(), k
        if np.abs(np.asarray(r)).max() == 0.0:
            assert np.abs(g).max() == 0.0, k
        else:
            ok, n_ill = _grad_close(g, r, f64[k].numpy())
            assert ok and n_ill <= 6, (k, n_ill, _max_norm_err(g, r),
                                       _max_norm_err(g, f64[k].numpy()),
                                       _max_norm_err(r, f64[k].numpy()))


def test_controller_matches_jax(jax_controller):
    """On JAX's initial weights, carried across: exposure and latents at
    two image sizes whose max pool and 5x5 average pool do not divide
    evenly; the export layout equal element for element, and the flax
    tree back equal."""
    ctrl_j = jax_controller
    ctrl = controller_from_flax(ctrl_j.params)
    rng = np.random.default_rng(3)
    for hw in ((40, 56), (29, 35)):
        img = rng.uniform(0.0, 2.0, hw + (3,)).astype(np.float32)
        e_ref, c_ref = ctrl_j.predict(ctrl_j.params, jnp.asarray(img), 0.25)
        with torch.no_grad():
            e, c = ctrl.predict(torch.tensor(img), 0.25)
        assert abs(float(e) - float(e_ref)) <= TOL, hw
        np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=TOL,
                                   rtol=0)
    flat = t_ppisp.flatten_controller_weights(ctrl)
    ref = j_ppisp.flatten_controller_weights(ctrl_j.params)
    assert flat.size == ref.size == 241961
    np.testing.assert_array_equal(flat, ref)
    back = controller_to_flax(ctrl)["params"]
    for name, layer in ctrl_j.params["params"].items():
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][k],
                                          np.asarray(layer[k]))


def test_distillation_adam_matches_jax(jax_controller):
    """Five distillation steps on fixed images: the trainer's loss
    (e - te)^2 + mean((c - tl)^2) over frames, optax.adam(1e-3) against
    torch.optim.Adam(lr=1e-3); each loss, and the predictions after, on
    the images and on a held-out one, within 1e-5."""
    import optax

    rng = np.random.default_rng(4)
    imgs = rng.uniform(0.0, 1.5, (3, 20, 31, 3)).astype(np.float32)
    t_exp = rng.normal(size=3).astype(np.float32)
    t_lat = (rng.normal(size=(3, 8)) * 0.2).astype(np.float32)
    ctrl_j = jax_controller
    ctrl = controller_from_flax(ctrl_j.params)

    def j_loss(pr):
        def one(img, te, tl):
            e, c = ctrl_j.module.apply(pr, img, jnp.zeros(()))
            return (e - te) ** 2 + jnp.mean((c - tl) ** 2)
        return jnp.mean(jax.vmap(one)(jnp.asarray(imgs), jnp.asarray(t_exp),
                                      jnp.asarray(t_lat)))

    tx = optax.adam(1e-3)
    params, opt = ctrl_j.params, tx.init(ctrl_j.params)

    @jax.jit
    def update(pr, op):
        loss, g = jax.value_and_grad(j_loss)(pr)
        updates, op = tx.update(g, op)
        return loss, optax.apply_updates(pr, updates), op

    opt_t = torch.optim.Adam(ctrl.parameters(), lr=1e-3)
    x, te, tl = (torch.tensor(a) for a in (imgs, t_exp, t_lat))
    for step in range(5):
        l_ref, params, opt = update(params, opt)
        opt_t.zero_grad()
        e, c = ctrl(x, torch.zeros(3))
        loss = torch.mean((e - te) ** 2 + torch.mean((c - tl) ** 2, dim=-1))
        loss.backward()
        opt_t.step()
        assert float(loss.detach()) == pytest.approx(float(l_ref),
                                                     abs=TOL), step
    held_out = rng.uniform(0.0, 1.5, (1, 23, 26, 3)).astype(np.float32)
    predict = jax.jit(jax.vmap(lambda pr, im: ctrl_j.module.apply(
        pr, im, jnp.zeros(())), in_axes=(None, 0)))
    for batch in (imgs, held_out):
        e_ref, c_ref = predict(params, jnp.asarray(batch))
        with torch.no_grad():
            e, c = ctrl(torch.tensor(batch), torch.zeros(len(batch)))
        np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=TOL,
                                   rtol=0)


@pytest.fixture(scope="module")
def ppisp_run(jax_controller):
    """One JAX trainer run with post_processing=ppisp beside the port's:
    three steps, each on its own frame, at SH degree 0 throughout (one
    JAX compile), then a 6-step distillation on one rendered frame. Both
    controllers start from ``jax_controller``'s weights: the JAX trainer
    draws the same ones at its seed, here taken from the fixture rather
    than drawn again, and the port's are carried across. JAX's trainer
    renders its distillation and validation views eagerly, ~15 s of
    interpret-mode dispatch on the CPU; the fixture jits that render."""
    from threedgrut_tpu.models import post_processing as j_post
    from threedgrut_tpu.render.gut import render_gut as j_render_gut

    views = Views()
    jt, tt = _trainers(views, post_processing="ppisp")
    for tr in (jt, tt):
        tr.conf.increase_frequency = 100
    for step in range(STEPS):
        jt.train_iteration(views[step], frame_idx=step)
        tt.train_iteration(views[step], frame_idx=step)
    params_after = ({k: np.asarray(v) for k, v in jt.ppisp_params.items()},
                    {k: v.detach().numpy().copy()
                     for k, v in tt.ppisp_params.items()})
    assert tt.conf.seed == jt.conf.seed == 42

    cls = j_post.PPISPController

    def j_controller(n_cameras=1, seed=0):
        ctrl = object.__new__(cls)
        ctrl._cnn, ctrl.module = jax_controller, jax_controller.module
        ctrl.n_cameras, ctrl.params = n_cameras, jax_controller.params
        return ctrl

    originals = (j_post.PPISPController, t_tr.PPISPControllerCNN)
    j_tr.render_gut = jax.jit(j_render_gut, static_argnums=(1, 2, 4))
    j_post.PPISPController = j_controller
    t_tr.PPISPControllerCNN = (lambda seed=0, device="cpu":
                               controller_from_flax(jax_controller.params,
                                                    device))
    try:
        losses = (jt.distill_ppisp_controller(steps=6, max_frames=1),
                  tt.distill_ppisp_controller(steps=6, max_frames=1))
    finally:
        j_post.PPISPController, t_tr.PPISPControllerCNN = originals
    yield views, jt, tt, params_after, losses
    j_tr.render_gut = j_render_gut


def test_trainer_ppisp_matches_jax(ppisp_run):
    """Three steps with the ISP in the loss: every table within 1e-5 of
    JAX's, every frame's row moved by its moments (JAX's Adam masks no
    PPISP table), and the optimizer groups named as JAX's."""
    _, jt, tt, (ref, got), _ = ppisp_run
    assert set(got) == set(ref) == set(t_ppisp.PARAM_NAMES)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=0,
                                   err_msg=k)
    assert np.abs(got["exposure"]).min() > 0.0      # every frame moved
    assert tt.current_lrs()["ppisp"] == jt.current_lrs()["ppisp"] == 1e-3
    assert {k for k in tt.params() if k.startswith("ppisp/")} == {
        f"ppisp/{k}" for k in ref}


def test_distillation_and_validation_match_jax(ppisp_run):
    """The controller after the trainer's distillation within 1e-4 of
    JAX's on a view's composited render, its last loss likewise, and
    validation (the controller's prediction through the ISP) within
    1e-3 dB."""
    views, jt, tt, _, (l_ref, l_got) = ppisp_run
    assert l_got == pytest.approx(l_ref, abs=1e-4)
    assert tt.ppisp_distill_first_loss > l_got
    img = np.asarray(views[1].rgb_gt, np.float32)[::4, ::4]
    e_ref, c_ref = jt.ppisp_controller.predict(
        jt.ppisp_controller.params, jnp.asarray(img), 0.0)
    with torch.no_grad():
        e, c = tt.ppisp_controller.predict(torch.tensor(img), 0.0)
    assert abs(float(e) - float(e_ref)) <= 1e-4
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-4,
                               rtol=0)
    one = Views.__new__(Views)
    one.batches = views.batches[1:2]
    got, ref = tt.validate(one), jt.validate(one)
    assert got["psnr"] == pytest.approx(ref["psnr"], abs=1e-3)
    controller = tt.ppisp_controller
    tt.ppisp_controller = None
    neutral = tt.validate(one)["psnr"]
    tt.ppisp_controller = controller
    assert neutral != got["psnr"]            # the controller is applied


def test_ppisp_checkpoint_loads_across_packages(ppisp_run, tmp_path):
    """The port's PPISP checkpoint holds JAX's keys
    (params/ppisp//<name>, its moments) and loads into JAX's Trainer; a
    port trainer over another number of frames takes the file's tables,
    as JAX's does."""
    views, jt, tt, _, _ = ppisp_run
    path = str(tmp_path / "port.npz")
    tt.save_checkpoint(path)
    back = str(tmp_path / "jax.npz")
    jt.save_checkpoint(back)
    with np.load(path) as a, np.load(back) as b:
        assert set(a.files) == set(b.files)
        assert {f"params/ppisp//{k}" for k in t_ppisp.PARAM_NAMES} <= set(
            a.files)
    fresh_j = _trainers(views, post_processing="ppisp")[0]
    fresh_j.load_checkpoint(path)
    for k, v in tt.ppisp_params.items():
        np.testing.assert_array_equal(np.asarray(fresh_j.ppisp_params[k]),
                                      v.detach().numpy())
        np.testing.assert_array_equal(
            np.asarray(fresh_j.opt_state.exp_avg["ppisp"][k]),
            tt.opt_state.exp_avg[f"ppisp/{k}"].numpy())
    two = Views.__new__(Views)
    two.batches = views.batches[:2]
    other = t_tr.Trainer(tt.conf, two, _trainers(two, "ppisp")[1].model)
    assert other.ppisp_params["exposure"].shape == (2,)
    other.load_checkpoint(back)
    assert other.ppisp_params["exposure"].shape == (STEPS,)
    np.testing.assert_array_equal(
        other.ppisp_params["color_latents"].detach().numpy(),
        np.asarray(jt.ppisp_params["color_latents"]))
