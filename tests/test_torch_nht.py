"""The port's NHT path against the JAX package's, on the CPU: the
tetrahedron features at the hit, the decoder, the NHT render and its
gradients.

JAX runs its Pallas kernels in interpret mode with the exact kill and
fp32 records (``records_bf16=False``: the NHT configs' bf16 records are
a JAX fault the port does not copy, ROADMAP section 3). The scene is
tests/test_nht.py's at the published width: 32x32, 48 particles, 48 NHT
features (the width the card's kernels are built for; chip_smoke.py holds
them to the gradient fixture). One JAX gradient run serves the render,
the gradient and the fixture tests; the narrower 16 features go through
JAX and the port in tests/test_torch_mcmc.py's trainer.
Tolerances, with reasons:
  * barycentric weights and hit features 1e-6: the same fp32 expressions;
  * the render: features and opacity 1e-4, depth 1e-3, as the other
    render tests (the port's plain version is float64 at the canonical
    point, JAX's fp32; measured ~3e-6);
  * the decoder 1e-2 on RGB: both run bf16 products and activations,
    rounded at other places (measured ~4e-3); its SH encoding 1e-6 and
    one EMA update 1e-7 (fp32 arithmetic in the same order);
  * gradients of the five leaves 2e-3 max-normalised and cosine
    >= 0.9999 (the slice-2/3 tolerances), against JAX and against the
    fixture chip_smoke.py reads;
  * the plain backward against autograd of the plain forward: 1e-4
    max-normalised (the forward's alpha and hit distance are fp32).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_nht import make_nht_model
from threedgrut_tpu.models.nht_decoder import FeatureDecoder as JDecoder
from threedgrut_tpu.ops.pallas import raster as j_raster
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu.render.gut import render_gut as j_render_gut
from threedgrut_tpu_torch.convert import (decoder_from_jax, decoder_state_dict,
                                          decoder_to_flax)
from threedgrut_tpu_torch.ops import hit as t_hit
from threedgrut_tpu_torch.ops.cuda.fold import fold_pairs_plain
from threedgrut_tpu_torch.ops.cuda.raster import (
    rasterize_tiles_backward_plain, rasterize_tiles_plain)
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.render.gut import prepare_view, render_gut
from torch_port_utils import np32, torch_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures",
                       "torch_port_nht_grad_small.npz")
NAMES = ("positions", "rotation", "scale", "density", "features")
# the fixture's NHT features per particle: the published width
FIXTURE_DIM = 48
KEYS = ("pred_features", "pred_opacity", "pred_dist", "hits_count")


def j_rc():
    return JRasterConfig(max_pairs=1 << 13, exact_kill=True,
                         records_bf16=False, grad_fold=False)


def test_tetra_features_match_jax():
    """tetra_barycentric and nht_hit_features on the same points and
    control features as JAX's raster.py versions."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(3, 64, 5)).astype(np.float32) * 2.0
    d = 12
    cfg = j_raster.RasterKernelConfig(shared_origin=False, feature_mode="nht",
                                      feat_dim=2 * d, interp_pt_dim=d)
    feats = rng.uniform(-1.5, 1.5, (5, 4 * d)).astype(np.float32)
    rec = np.zeros((cfg.record_dim, 5), np.float32)
    rec[cfg.feat_offset:cfg.feat_offset + 4 * d] = feats.T
    jc = tuple(jnp.asarray(pts[i]) for i in range(3))
    tc = tuple(torch.from_numpy(pts[i]) for i in range(3))
    for a, b in zip(t_hit.tetra_barycentric(*tc),
                    j_raster.tetra_barycentric(*jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    ref = np.stack([np.asarray(f) for f in j_raster.nht_hit_features(
        jnp.asarray(rec), jc, cfg)], axis=-1)                # [64, 5, 24]
    got = t_hit.nht_hit_features(torch.from_numpy(feats)[None],
                                 torch.from_numpy(pts.transpose(1, 2, 0)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_density_hit_canonical_matches_jax():
    from threedgrut_tpu.ops.hit import density_hit as j_density_hit

    rng = np.random.default_rng(1)
    o = rng.normal(size=(40, 3)).astype(np.float32)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = (o + 3.0 * d + 0.2 * rng.normal(size=(40, 3))).astype(np.float32)
    quat = rng.normal(size=(40, 4)).astype(np.float32)
    scale = rng.uniform(0.1, 0.5, (40, 3)).astype(np.float32)
    dens = rng.uniform(0.2, 0.9, (40,)).astype(np.float32)
    ref = j_density_hit(*(jnp.asarray(x) for x in (o, d, pos, quat, scale,
                                                   dens)))
    got = t_hit.density_hit(*(torch.from_numpy(x) for x in (
        o, d, pos, quat, scale, dens)))
    np.testing.assert_allclose(got.canonical.numpy(),
                               np.asarray(ref.canonical), atol=1e-5, rtol=0)


def _decoder_inputs(n=512, f=24, seed=2):
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-1.0, 1.0, (n, f)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return feats, dirs


def test_decoder_matches_jax():
    """The port's decoder with the JAX decoder's carried weights: the SH
    input encoding, the bf16 MLP's RGB, the EMA decode."""
    jd = JDecoder(ray_feature_dim=24, seed=3)
    td = decoder_from_jax(jd)
    feats, dirs = _decoder_inputs()
    enc_ref = np.asarray(jd.encode_input(jnp.asarray(feats),
                                         jnp.asarray(dirs)))
    enc = td.encode_input(torch.from_numpy(feats), torch.from_numpy(dirs))
    assert enc.shape == (512, 33)
    np.testing.assert_allclose(enc.numpy(), enc_ref, atol=1e-6, rtol=0)
    ref = np.asarray(jd(jnp.asarray(feats), jnp.asarray(dirs)))
    with torch.no_grad():
        got = td(torch.from_numpy(feats), torch.from_numpy(dirs))
        got_ema = td(torch.from_numpy(feats), torch.from_numpy(dirs),
                     use_ema=True)
    assert got.dtype == torch.float32 and got.shape == (512, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-2, rtol=0)
    np.testing.assert_allclose(got_ema.numpy(), ref, atol=1e-2, rtol=0)


def test_decoder_ema_update_matches_jax():
    jd = JDecoder(ray_feature_dim=24, seed=4)
    rng = np.random.default_rng(5)
    jd.params = jax.tree.map(
        lambda p: p + jnp.asarray(rng.normal(size=p.shape) * 0.01,
                                  jnp.float32), jd.params)
    td = decoder_from_jax(jd)
    jd.ema_update(1)
    td.ema_update()
    _, ema = decoder_to_flax(td)
    for name, leaf in ema["params"].items():
        np.testing.assert_allclose(
            leaf["kernel"], np.asarray(jd.ema_shadow["params"][name]["kernel"]),
            atol=1e-7, rtol=0, err_msg=name)


def test_decoder_carries_both_ways():
    """JAX -> port -> JAX gives the same pytrees, and the port's state
    dict has the JAX FeatureDecoder.state_dict keys and arrays."""
    jd = JDecoder(ray_feature_dim=24, seed=6)
    jd.ema_shadow = jax.tree.map(lambda p: p * 0.5, jd.ema_shadow)
    td = decoder_from_jax(jd)
    params, ema = decoder_to_flax(td)
    for got, ref in ((params, jd.params), (ema, jd.ema_shadow)):
        for name, leaf in ref["params"].items():
            np.testing.assert_array_equal(got["params"][name]["kernel"],
                                          np.asarray(leaf["kernel"]))
    sd, ref_sd = decoder_state_dict(td), jd.state_dict()
    assert set(sd) == set(ref_sd)
    for k, v in ref_sd.items():
        np.testing.assert_array_equal(sd[k], v)


def test_decoder_from_jax_refuses_other_sizes():
    """The port's decoder has the published sizes only: a JAX decoder of
    another width or without its EMA is refused, not carried in part."""
    for kw in (dict(hidden_dim=64), dict(ema_decay=0.0)):
        with pytest.raises(ValueError, match="the port decodes with"):
            decoder_from_jax(JDecoder(ray_feature_dim=24, seed=7, **kw))


def test_nht_render_matches_jax(jax_nht):
    """render_gut of an NHT model (general mode, per-pixel origins on a
    pinhole, as JAX takes it) against JAX render_gut, on the plain
    versions of the NHT kernels; JAX's render is the forward of the
    fixture's gradient run."""
    _, ref = jax_nht
    cam, state = make_nht_model(nht_dim=FIXTURE_DIM)
    tcam, model = torch_scene(cam, state)
    with torch.no_grad():
        v = prepare_view(tcam, UTConfig(), RasterConfig(), model, 0)
        out = render_gut(tcam, UTConfig(), RasterConfig(), model, 0)
    assert v.ray_o is not None and v.table.shape == (64, 16 + FIXTURE_DIM)
    got = {k: np32(out[k]) for k in KEYS}
    assert got["pred_features"].shape == (32, 32, FIXTURE_DIM // 2)
    np.testing.assert_allclose(got["pred_features"], ref["pred_features"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["pred_opacity"], ref["pred_opacity"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["pred_dist"], ref["pred_dist"],
                               atol=1e-3, rtol=0)
    assert (got["hits_count"] != ref["hits_count"]).mean() < 0.01
    assert float(ref["pred_opacity"].mean()) > 0.05
    # the render's ray directions, which the trainer decodes along
    np.testing.assert_array_equal(np32(out["ray_d"]), np32(v.ray_d))


def test_nht_render_refuses_weight_telemetry():
    cam, state = make_nht_model()
    tcam, model = torch_scene(cam, state)
    with pytest.raises(NotImplementedError, match="telemetry"):
        render_gut(tcam, UTConfig(), RasterConfig(), model, 0,
                   weight_telemetry=True)


# ---------------------------------------------------------------------------
# gradients, and the fixture that chip_smoke.py reads
# ---------------------------------------------------------------------------

def _loss(feat, opacity, dist, mean):
    """tests/test_render_parity.py:49-61 with a zero target."""
    return mean(feat ** 2) + 0.1 * mean(opacity) + 0.01 * mean(dist)


def make_nht_fixture():
    """The scene, the camera and JAX's loss and gradients of the five
    leaves (tests/fixtures/torch_port_nht_grad_small.npz), and JAX's
    render of the scene as numpy arrays."""
    cam, state = make_nht_model(nht_dim=FIXTURE_DIM)
    rc = JRasterConfig(max_pairs=1 << 13, exact_kill=True, records_bf16=False,
                       grad_fold=True, fold_wide=True)

    def loss(params):
        out = j_render_gut(cam, JUTConfig(), rc, state.replace(params=params),
                           0, interpret=True)
        return _loss(out["pred_features"], out["pred_opacity"],
                     out["pred_dist"], jnp.mean), {k: out[k] for k in KEYS}

    (val, render), g = jax.value_and_grad(loss, has_aux=True)(state.params)
    data = {f"params/{k}": np.asarray(getattr(state.params, k))
            for k in NAMES}
    data.update({f"grad/{k}": np.asarray(getattr(g, k), np.float32)
                 for k in NAMES})
    data.update(
        loss=np.float32(val), n_active=np.int32(state.n_active),
        density_activation=state.config.density_activation,
        scale_activation=state.config.scale_activation,
        resolution=np.asarray(cam.resolution, np.int32),
        focal=np.asarray(cam.focal), principal=np.asarray(cam.principal),
        t=np.asarray(cam.t_start), q=np.asarray(cam.q_start))
    return data, {k: np.asarray(v) for k, v in render.items()}


@pytest.fixture(scope="module")
def jax_nht():
    """(fixture data, JAX render): one JAX gradient run at the published
    width serves the render, gradient and fixture tests."""
    return make_nht_fixture()


def test_nht_grads_match_jax(jax_nht):
    """render_gut's NHT backward (on the CPU: the float64 autograd plain
    version of kernel C, the plain fold, then autograd through the table)
    against JAX's gradients of all five leaves."""
    fresh, _ = jax_nht
    cam, state = make_nht_model(nht_dim=FIXTURE_DIM)
    tcam, model = torch_scene(cam, state)
    out = render_gut(tcam, UTConfig(), RasterConfig(), model, 0)
    loss = _loss(out["pred_features"], out["pred_opacity"],
                 out["pred_dist"], torch.mean)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(fresh["loss"]),
                               rtol=1e-5)
    for k in NAMES:
        a = getattr(model, k).grad.double().numpy()
        b = fresh[f"grad/{k}"].astype(np.float64)
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-3, rtol=0,
                                   err_msg=k)
        cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.9999, (k, cos)


def test_nht_fixture_is_current(jax_nht):
    """The saved JAX values agree with a fresh JAX run within 1e-6, so the
    fixture chip_smoke.py reads cannot drift."""
    fresh_fixture, _ = jax_nht
    with np.load(FIXTURE) as saved:
        assert set(saved.files) == set(fresh_fixture)
        for k, v in fresh_fixture.items():
            if saved[k].dtype.kind in "fi":
                scale = max(1.0, float(np.abs(v).max()))
                np.testing.assert_allclose(saved[k], v, atol=1e-6 * scale,
                                           rtol=0, err_msg=k)
            else:
                assert str(saved[k]) == str(v), k
    assert os.path.getsize(FIXTURE) < 100_000


def test_nht_plain_backward_matches_autograd_of_plain_forward():
    """The plain NHT backward (float64 autograd of the compositing, per
    pair), folded per particle, against torch autograd of the plain
    forward with respect to the table."""
    cam, state = make_nht_model(nht_dim=48)
    tcam, model = torch_scene(cam, state)
    rc = RasterConfig()
    with torch.no_grad():
        v = prepare_view(tcam, UTConfig(), rc, model, 0)
    b = v.binning
    rng = np.random.default_rng(9)
    up = [torch.from_numpy(rng.normal(size=(32, 32, c)).astype(np.float32))
          for c in (24, 1, 1)]
    table = v.table.detach().clone().requires_grad_(True)
    args = (b.pair_particle, b.tile_start, v.ray_d, v.tmin, v.tmax, rc,
            v.ray_o)
    feat, opacity, depth, _, t_final = rasterize_tiles_plain(table, *args)
    ((feat * up[0]).sum() + (opacity * up[1]).sum()
     + (depth * up[2]).sum()).backward()
    with torch.no_grad():
        d_rec = rasterize_tiles_backward_plain(
            table, *args[:5], feat, depth, t_final, *up, rc, v.ray_o)
        got = fold_pairs_plain(d_rec, b.perm, b.order, b.excl, b.counts,
                               b.limit, table.shape[0])
    ref = table.grad
    assert got.shape == ref.shape == (64, 64)
    scale = float(ref.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got / scale, ref / scale, atol=1e-4, rtol=0)
    assert float(got[:, 61:].abs().max()) == 0.0


if __name__ == "__main__":
    # regenerate the fixture:
    #   PYTHONPATH=. python tests/test_torch_nht.py
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (JAX on the CPU, highest precision)
    np.savez_compressed(FIXTURE, **make_nht_fixture()[0])
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
