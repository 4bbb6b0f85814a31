"""The port's NHT training step against the benchmark's plain reference
(``perfbench/reference/nht.py``), on the CPU at a small size: 2,048 rows
of the benchmark's stand-in cloud with seeded control features and the
port's seeded decoder, one 64x48 view of the NHT configuration
(``perfbench/configs/colmap_3dgut_mcmc_nht.json``) from step 9,997. No
JAX.

On the CPU the port's raster runs its plain version, which composites in
float64 from fp32 records, and its decoder multiplies in fp32; the
reference hits in fp32 and composites in float64. The two differ by
fp32 rounding alone, so the tolerances below sit a few hundred fp32
roundoffs (2^-24 ~ 6e-8) above what the two reach, each at the scale of
what it compares. ``-m gpu`` holds the card's decoder (fp16 with a loss
scale) to the fp32 reference beside a bf16 decoder.
"""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import program, scene
from perfbench.drivers import train_nht
from perfbench.reference import nht as ref_nht
from perfbench.reference import render as ref
from perfbench.reference import train as ref_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SEED = 2 ** 31 + 5


@pytest.fixture(scope="module")
def conf():
    with open(os.path.join(REPO, "perfbench", "configs",
                           "colmap_3dgut_mcmc_nht.json")) as f:
        c = json.load(f)
    c.update(rows=2048, max_n_gaussians=2048, views=4)
    c["app_overrides"] = ["strategy.add.max_n_gaussians=2048"]
    c["camera"].update(resolution=[64, 48])
    return c


@pytest.fixture(scope="module")
def setup(conf):
    """The trainer one step in, its inputs, and the view's reference
    camera and image."""
    torch.manual_seed(0)
    tconf = train_nht.trainer_config(conf, SEED)
    poses = scene.views(conf, "train")
    views = train_nht.reference_views(conf, poses, CPU, SEED)
    capture = program.Capture([program.View(p.c2w, p.intrinsics, img)
                               for p, (_, img) in zip(poses, views)])
    params = train_nht.nht_cloud(conf, SEED, CPU)
    from threedgrut_tpu_torch.train.trainer import Trainer

    tr = Trainer(tconf, capture, train_nht.nht_model(
        {k: v.clone() for k, v in params.items()}, conf["nht"]["dim"]))
    tr.global_step = conf["start_step"]
    w0 = [w.detach().clone() for w in tr.decoder.weights()]
    from threedgrut_tpu_torch.render.gut import render_gut

    with torch.no_grad():
        out = render_gut(program.camera(poses[1], CPU), tconf.ut,
                         tconf.raster, tr.model, 0)
    m = tr.train_iteration(capture[1], frame_idx=1)
    return dict(conf=conf, tr=tr, params=params, w0=w0, out=out, loss=m,
                view=views[1], pose=poses[1])


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def test_ray_features_and_opacity_match_reference(setup):
    """The port's render of the NHT model: its 24 ray features and its
    opacity against the reference's hit features and compositing, within
    5e-5 and 1e-5 (the port's plain raster blends at a float64 hit point,
    the reference at an fp32 one: ~1e-5 on features of size 1; a hit
    accepted on one side alone would read ~1e-3)."""
    s = ref.settings_from(setup["conf"])
    cam, _ = setup["view"]
    params = setup["params"]
    pairs, rays = ref.prepare(params, cam, s)
    terms = ref_nht.geometry_terms(params, rays.origin)
    n_t = pairs.tile_start.numel() - 1
    feat = torch.zeros((n_t, ref.TILE_PIXELS, 24))
    opac = torch.zeros((n_t, ref.TILE_PIXELS, 1))
    with torch.no_grad():
        for blk in ref.blocks(pairs):
            f, o = ref_nht.composite_block(blk, pairs, terms, rays, s)
            feat[blk.t0:blk.t1], opac[blk.t0:blk.t1] = f, o
    out = setup["out"]
    assert out["pred_features"].shape == (48, 64, 24)
    want_f = ref.untile(feat, cam, pairs.grid)
    want_o = ref.untile(opac, cam, pairs.grid)
    assert float(want_o.max()) > 0.5
    np.testing.assert_allclose(out["pred_features"].numpy(), want_f.numpy(),
                               atol=5e-5, rtol=0)
    np.testing.assert_allclose(out["pred_opacity"].numpy(), want_o.numpy(),
                               atol=1e-5, rtol=0)


def test_decoded_rgb_matches_reference(setup):
    """The port's decoder (encoding, MLP, sigmoid) against the
    reference's on the render's features along its rays, within 1e-5
    (fp32 products on both sides: ~1e-7)."""
    from threedgrut_tpu_torch.models.nht_decoder import FeatureDecoder

    out = setup["out"]
    dec = FeatureDecoder(24, seed=SEED)   # the trainer's, before its step
    for w, w0 in zip(dec.weights(), setup["w0"]):
        assert torch.equal(w, w0)
    with torch.no_grad():
        got = dec(out["pred_features"].reshape(-1, 24),
                  out["ray_d"].reshape(-1, 3))
        want = ref_nht.decode(out["pred_features"], out["ray_d"],
                              setup["w0"])
    np.testing.assert_allclose(got.reshape(48, 64, 3).numpy(), want.numpy(),
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def reference_step(setup):
    """The reference's loss and the gradient of every leaf on the step's
    view, from the same state."""
    conf = setup["conf"]
    spec = ref_train.spec_from(conf)
    params = {k: v.clone().requires_grad_() for k, v in
              setup["params"].items()}
    weights = [w.clone().requires_grad_() for w in setup["w0"]]
    cam, gt = setup["view"]

    def image_loss(rgb, opac):
        pred = rgb + spec.background * (1.0 - opac)
        return (spec.lambda_l1 * torch.mean(torch.abs(pred - gt))
                + spec.lambda_ssim * (1.0 - ref_train.ssim(pred, gt))
                + spec.lambda_opacity * torch.mean(
                    torch.sigmoid(params["density"]))
                + spec.lambda_scale * torch.mean(torch.exp(params["scale"])))

    loss, _, _ = ref_nht.render_backward(params, weights, cam,
                                         spec.settings, image_loss)
    grads = {k: v.grad for k, v in params.items()}
    grads.update({ref_nht.decoder_key(i): w.grad
                  for i, w in enumerate(weights)})
    return loss, grads


def test_loss_and_every_gradient_match_reference(setup, reference_step):
    """The step's loss within 1e-5 relative; each leaf's gradient (Adam's
    first moment over 1 - beta1), the decoder's 4 weights included, within
    1e-4 of its norm (sums over the image's pixels of fp32 terms)."""
    loss, grads = reference_step
    assert abs(setup["loss"]["total"] - loss) <= 1e-5 * abs(loss)
    tr = setup["tr"]
    b1 = setup["conf"]["train"]["betas"][0]
    assert set(grads) == set(tr.params())
    for k, g in grads.items():
        got = tr.opt_state.exp_avg[k] / (1.0 - b1)
        assert float(torch.linalg.vector_norm(g)) > 0, k
        assert _rel(got, g) < 1e-4, k


def test_adam_step_and_ema_match_reference(setup):
    """From the port's own gradient, the reference's Adam (the features'
    and the decoder's cosine rates), MCMC's perturbation of the positions
    and the EMA shadow give the port's state after the step, within 1e-6
    of each leaf's norm (the same fp32 formulas on both sides)."""
    conf, tr = setup["conf"], setup["tr"]
    spec, nht = ref_train.spec_from(conf), ref_nht.nht_spec_from(conf)
    b1 = conf["train"]["betas"][0]
    step = conf["start_step"]
    leaves = {k: v.clone() for k, v in setup["params"].items()}
    leaves.update({ref_nht.decoder_key(i): w.clone()
                   for i, w in enumerate(setup["w0"])})
    grads = {k: tr.opt_state.exp_avg[k] / (1.0 - b1) for k in leaves}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v = {k: torch.zeros_like(x) for k, x in leaves.items()}
    extent = ref_train.scene_extent([p.c2w for p in scene.views(conf,
                                                                "train")])
    lrs = ref_train.learning_rates(spec, step, extent)
    lrs["features"] = ref_nht.cosine(nht.features_lr,
                                     nht.features_decay_final,
                                     nht.features_max_steps, step)
    lrs.update({ref_nht.decoder_key(i): ref_nht.cosine(
        nht.decoder_lr, nht.decoder_decay_final, nht.decoder_max_steps,
        step) for i in range(4)})
    ref_train.adam(leaves, grads, m, v, lrs, 1, spec)
    gen = torch.Generator().manual_seed(SEED)
    ref_train.perturb(leaves, gen, ref_train.positions_lr(spec, step + 1,
                                                          extent),
                      spec.noise_lr)
    for k, p in tr.params().items():
        assert _rel(p.detach(), leaves[k]) < 1e-6, k
    for i, s in enumerate(tr.decoder.ema_shadow):
        want = nht.ema_decay * setup["w0"][i] + (1.0 - nht.ema_decay) * \
            leaves[ref_nht.decoder_key(i)]
        assert _rel(s, want) < 1e-6, i


@pytest.mark.gpu
def test_card_decoder_sits_closer_to_fp32_than_bf16():
    """On the card, at 65,536 rows of the published widths: the port's
    decoder (fp16 with a loss scale) against the fp32 reference, its
    output and every cotangent at most half of a bf16 decoder's distance
    (fp16 has 3 more mantissa bits: ~1/8); cotangents of size 1, far
    above a loss's, so the scale must follow them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from threedgrut_tpu_torch.models.nht_decoder import FeatureDecoder

    dev = torch.device("cuda", 0)
    dec = FeatureDecoder(24, seed=3, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.sin(6.0 * torch.rand((256, 256, 24), generator=g,
                                       device=dev))
    dirs = torch.nn.functional.normalize(
        torch.randn((256, 256, 3), generator=g, device=dev), dim=-1)
    cot = torch.randn((256, 256, 3), generator=g, device=dev)

    def run(fn):
        f = feats.clone().requires_grad_()
        ws = [w.detach().clone().requires_grad_() for w in dec.weights()]
        y = fn(f, ws)
        y.backward(cot)
        return [y.detach(), f.grad] + [w.grad for w in ws]

    want = run(lambda f, ws: ref_nht.decode(f, dirs, ws))
    bf16 = run(lambda f, ws: ref_nht.decode(f, dirs, ws, "bf16_decoder"))
    from threedgrut_tpu_torch.models.nht_decoder import mlp

    got = run(lambda f, ws: mlp(dec.encode_input(
        f.reshape(-1, 24), dirs.reshape(-1, 3)), ws).reshape(256, 256, 3))
    for i, (a, b, w) in enumerate(zip(got, bf16, want)):
        assert 0 < _rel(a, w) <= 0.5 * _rel(b, w), i
