"""Rolling-shutter and fisheye 3DGUT renders of the port against the JAX
package (CPU), and the general-geometry mode of the raster kernels
(kernel 5) that a rolling shutter and the ``rays=`` override take.

JAX runs its Pallas kernels in interpret mode, exact kill. The scene is
tests/scene_utils.py's at 48x32 (n = 64) behind a rolling shutter whose
end pose moves (0.08, -0.04, 0.05) and turns 0.015 rad, as
tests/test_cameras_shutter.py's render test has it. Two settings: 3DGUT
(degree 2, global-Z) and 3DGRT (degree 4, sorted windows of 16).
Tolerances, with reasons:
  * features and opacity 1e-4, depth 1e-3, hit counts flipping on < 1%
    of the pixels: tests/test_torch_render.py's; JAX's general hit math
    is elementwise fp32 (no split-bf16 dots), and the port's forms
    a = M (o - p) from the table's M where JAX rebuilds R from the
    quaternion per pair: ~1e-6 apart;
  * gradients of the six parameter leaves: 2e-3 max-normalised and
    cosine >= 0.9999 (the slice-2/3 tolerances);
  * the kernels' emulated fp32 walk against the float64 plain versions:
    tests/test_torch_grt.py's (1e-5 forward, 1e-6 weights, cosine
    0.99999 and relative L2 1e-4 on the record gradients).
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from test_torch_grt import _upstream, assert_grads_agree, walk_reference
from threedgrut_tpu.ops.cameras import (ShutterType, make_fisheye,
                                        make_pinhole)
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu.render.gut import render_gut as j_render_gut
from threedgrut_tpu.render.oracle import render_oracle as j_render_oracle
from threedgrut_tpu_torch.ops.cuda.raster import (
    rasterize_tiles_backward_plain, rasterize_tiles_plain)
from threedgrut_tpu_torch.ops.cuda.wmax import pair_weight_max_plain
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.render.gut import prepare_view, render_gut
from threedgrut_tpu_torch.render.oracle import render_oracle
from torch_port_utils import np32, torch_camera, torch_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures",
                       "torch_port_shutter_grad_small.npz")
RES = (48, 32)
MODES = {"3dgut": dict(kernel_degree=2),
         "grt": dict(kernel_degree=4, min_transmittance=1e-3,
                     sorted_compositing=True, sort_window=16)}
NAMES = ("positions", "rotation", "scale", "density", "features_albedo",
         "features_specular")
KEYS = ("pred_features", "pred_opacity", "pred_dist", "hits_count")
GRAD_SH = 1
CAMERA_FIELDS = ("focal", "principal", "t_start", "q_start", "t_end",
                 "q_end")


def rolling_scene(shutter=ShutterType.ROLLING_TOP_TO_BOTTOM):
    _, state = make_test_scene(n=64, seed=4, res=RES)
    w, h = RES
    ang = 0.015
    cam = make_pinhole(
        RES, (0.9 * w, 0.9 * w), (w / 2, h / 2),
        t=np.zeros(3, np.float32), q=np.array([1., 0, 0, 0], np.float32),
        t_end=np.array([0.08, -0.04, 0.05], np.float32),
        q_end=np.array([np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0],
                       np.float32),
        shutter_type=int(shutter))
    return cam, state


def j_rc(mode):
    return JRasterConfig(max_pairs=1 << 13, exact_kill=True, grad_fold=False,
                         **MODES[mode])


def jax_render(cam, state, mode, sh=3, **kw):
    out = j_render_gut(cam, JUTConfig(), j_rc(mode), state, sh,
                       interpret=True, **kw)
    return {k: np.asarray(out[k], np.float32) for k in KEYS}


def port_render(tcam, model, mode, sh=3, **kw):
    with torch.no_grad():
        out = render_gut(tcam, UTConfig(), RasterConfig(**MODES[mode]),
                         model, sh, **kw)
    return {k: np32(out[k]) for k in KEYS}


def assert_render_close(got, ref):
    """The render tolerances of this file (module docstring)."""
    np.testing.assert_allclose(got["pred_features"], ref["pred_features"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["pred_opacity"], ref["pred_opacity"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["pred_dist"], ref["pred_dist"],
                               atol=1e-3, rtol=0)
    assert (got["hits_count"] != ref["hits_count"]).mean() < 0.01
    assert ref["pred_opacity"].mean() > 0.05          # the view is covered


@pytest.mark.parametrize("mode", sorted(MODES))
def test_rolling_render_matches_jax(mode):
    """render_gut on a rolling-shutter camera (the general mode in both
    packages) against JAX render_gut."""
    cam, state = rolling_scene()
    tcam, model = torch_scene(cam, state)
    assert_render_close(port_render(tcam, model, mode),
                        jax_render(cam, state, mode))


def test_rolling_render_matches_oracles():
    """The port's render and its oracle (which inherits the shutter-aware
    UT and the mid-shutter rays) against the JAX oracle, global-Z."""
    cam, state = rolling_scene()
    tcam, model = torch_scene(cam, state)
    ref = j_render_oracle(cam, JUTConfig(), j_rc("3dgut"), state, 3)
    with torch.no_grad():
        oracle = render_oracle(tcam, UTConfig(), RasterConfig(), model, 3)
    got = port_render(tcam, model, "3dgut")
    for out in (got, {k: np32(oracle[k]) for k in KEYS}):
        assert_render_close(out, {k: np.asarray(ref[k], np.float32)
                                  for k in KEYS})


def test_fisheye_render_matches_jax():
    """A fisheye camera: fisheye rays, shared origin, in both packages."""
    _, state = make_test_scene(n=64, seed=5, res=RES)
    w, h = RES
    cam = make_fisheye(RES, (0.6 * w, 0.6 * w), (w / 2, h / 2),
                       (-0.03, -0.005, 0.001, -0.0002), math.pi / 2)
    tcam, model = torch_scene(cam, state)
    assert_render_close(port_render(tcam, model, "3dgut"),
                        jax_render(cam, state, "3dgut"))


def override_rays(cam):
    """The camera's rays with a distinct origin per pixel (seeded offsets
    of ~0.05) and directions of length 0.7-1.3: world-space rays as a
    ``rays=`` caller may pass them."""
    from threedgrut_tpu.render.common import camera_rays_world

    o, d = (np.asarray(x) for x in camera_rays_world(cam))
    rng = np.random.default_rng(11)
    o = o + rng.normal(0.0, 0.05, o.shape).astype(np.float32)
    d = d * rng.uniform(0.7, 1.3, d.shape[:2] + (1,)).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_rays_override_matches_jax(mode):
    """The ``rays=`` override with per-pixel origins and non-unit
    directions (JAX's general hit distance is |d| times the unit one, and
    the slab test's t-range is in the same units)."""
    cam, state = make_test_scene(n=64, seed=6, res=RES)
    tcam, model = torch_scene(cam, state)
    o, d = override_rays(cam)
    ref = jax_render(cam, state, mode, rays=(jnp.asarray(o), jnp.asarray(d)))
    got = port_render(tcam, model, mode,
                      rays=(torch.tensor(o), torch.tensor(d)))
    assert_render_close(got, ref)
    unit = port_render(tcam, model, mode, rays=(
        torch.tensor(o), torch.tensor(d / np.linalg.norm(d, axis=-1,
                                                         keepdims=True))))
    # the depth scales with |d|: the override is not normalised away
    assert np.abs(unit["pred_dist"] - got["pred_dist"]).max() > 1e-2


def test_rolling_and_global_renders_differ():
    """Rolling and global shutter renders differ (the pose motion is
    visible), as tests/test_cameras_shutter.py:343-358 checks for JAX."""
    cam, state = rolling_scene()
    tcam, model = torch_scene(cam, state)
    glob = torch_camera(cam.replace(shutter_type=int(ShutterType.GLOBAL)))
    r = port_render(tcam, model, "3dgut", sh=0)["pred_features"]
    g = port_render(glob, model, "3dgut", sh=0)["pred_features"]
    assert np.abs(r - g).max() > 1e-3


def test_rolling_weight_telemetry_matches_jax():
    """weight_telemetry=True takes the general mode too (kernel E's
    plain version here): the per-particle max blend weight."""
    cam, state = rolling_scene()
    tcam, model = torch_scene(cam, state)
    ref = j_render_gut(cam, JUTConfig(), j_rc("3dgut"), state, 3,
                       interpret=True, weight_telemetry=True)
    with torch.no_grad():
        got = render_gut(tcam, UTConfig(), RasterConfig(), model, 3,
                         weight_telemetry=True)
    np.testing.assert_allclose(np32(got["particle_wmax"]),
                               np.asarray(ref["particle_wmax"]), atol=1e-5,
                               rtol=0)
    assert float(got["particle_wmax"].max()) > 0.1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_general_kernel_walk_matches_plain(mode):
    """The kernels' sequential fp32 walk in the general mode (emulated:
    a = M (o - p) per pixel, the |d| hit distance, the pullback on to p
    and M) against the plain versions, whose float64 autograd backward
    derives the gradients independently; on override rays with distinct
    origins and non-unit directions."""
    cam, state = make_test_scene(n=64, seed=6, res=RES)
    tcam, model = torch_scene(cam, state)
    o, d = override_rays(cam)
    cfg = RasterConfig(**MODES[mode])
    with torch.no_grad():
        v = prepare_view(tcam, UTConfig(), cfg, model, 3,
                         rays=(torch.tensor(o), torch.tensor(d)))
    assert v.ray_o is not None
    b = v.binning
    up = _upstream(v)
    fwd, d_walk, w_walk = walk_reference(v, cfg, up)
    args = (v.table, b.pair_particle, b.tile_start, v.ray_d, v.tmin, v.tmax)
    ref = rasterize_tiles_plain(*args, cfg, v.ray_o)
    for got, r in zip(fwd, ref):
        np.testing.assert_allclose(np32(got), np32(r), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        np32(w_walk), np32(pair_weight_max_plain(*args, cfg, v.ray_o)),
        atol=1e-6, rtol=0)
    d_ref = rasterize_tiles_backward_plain(*args, ref[0], ref[2], ref[4],
                                           *up, cfg, v.ray_o)
    assert_grads_agree(d_walk, d_ref, 0.99999, 1e-4)


def test_serving_renders_rolling_and_fisheye_batches():
    """make_serving_renderer over rolling-shutter and fisheye views equals
    render_gut view by view; a batch that mixes camera models or shutters
    raises (JAX render/serve.py:49-50)."""
    from threedgrut_tpu_torch.models.background import apply_background
    from threedgrut_tpu_torch.render.serve import make_serving_renderer
    from threedgrut_tpu_torch.synthetic import bench_cloud, orbit_cameras

    model = bench_cloud(2000, seed=3)
    serve = make_serving_renderer(model, RasterConfig(), 3)
    for kind in ("rolling", "fisheye"):
        cams = orbit_cameras(model, 2, kind, resolution=(40, 32))
        for c in cams:
            c.focal = c.focal * (40.0 / c.focal[0])
        imgs = serve(cams)
        for img, cam in zip(imgs, cams):
            with torch.no_grad():
                out = render_gut(cam, UTConfig(), RasterConfig(), model, 3)
            ref = apply_background(out["pred_features"], out["pred_opacity"],
                                   torch.zeros(3))
            torch.testing.assert_close(img, ref, atol=0, rtol=0)
        assert float(imgs.amax()) > 0.05
    mixed = orbit_cameras(model, 1, "rolling", resolution=(64, 64)) \
        + orbit_cameras(model, 1, "pinhole", resolution=(64, 64))
    with pytest.raises(ValueError, match="camera model"):
        serve(mixed)


def test_general_mode_checks_ray_origins():
    """The wrappers check the general mode's per-pixel origins like the
    other inputs."""
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles_forward

    cam, state = rolling_scene()
    tcam, model = torch_scene(cam, state)
    with torch.no_grad():
        v = prepare_view(tcam, UTConfig(), RasterConfig(), model, 3)
    b = v.binning
    args = (v.table, b.pair_particle, b.tile_start, v.ray_d, v.tmin, v.tmax,
            RasterConfig())
    with pytest.raises(ValueError, match="ray_o"):
        rasterize_tiles_forward(*args, v.ray_o[:-1].contiguous())
    with pytest.raises(TypeError, match="ray_o"):
        rasterize_tiles_forward(*args, v.ray_o.double())


# ---------------------------------------------------------------------------
# gradients, and the fixture that chip_smoke.py reads
# ---------------------------------------------------------------------------

def _loss(feat, opacity, dist, mean):
    """tests/test_render_parity.py:49-61 with a zero target."""
    return mean(feat ** 2) + 0.1 * mean(opacity) + 0.01 * mean(dist)


def jax_grads(cam, state, mode):
    """(loss, {leaf: grad}) of JAX render_gut in the general mode."""
    rc = JRasterConfig(max_pairs=1 << 13, exact_kill=True, grad_fold=True,
                       fold_wide=True, **MODES[mode])

    def loss(params):
        out = j_render_gut(cam, JUTConfig(), rc, state.replace(params=params),
                           GRAD_SH, interpret=True)
        return _loss(out["pred_features"], out["pred_opacity"],
                     out["pred_dist"], jnp.mean)

    val, g = jax.value_and_grad(loss)(state.params)
    return float(val), {k: np.asarray(getattr(g, k)) for k in NAMES}


def make_shutter_fixture():
    """The scene, the rolling-shutter camera and JAX's loss and gradients
    in both settings (tests/fixtures/torch_port_shutter_grad_small.npz)."""
    cam, state = rolling_scene()
    data = {f"params/{k}": np.asarray(getattr(state.params, k))
            for k in NAMES}
    data.update(
        n_active=np.int32(state.n_active),
        n_active_features=np.int32(state.n_active_features),
        density_activation=state.config.density_activation,
        scale_activation=state.config.scale_activation,
        resolution=np.asarray(cam.resolution, np.int32),
        shutter_type=np.int32(cam.shutter_type),
        sh_degree=np.int32(GRAD_SH))
    data.update({f"camera/{k}": np.asarray(getattr(cam, k))
                 for k in CAMERA_FIELDS})
    for mode in sorted(MODES):
        loss, grads = jax_grads(cam, state, mode)
        data[f"{mode}/loss"] = np.float32(loss)
        data.update({f"{mode}/grad/{k}": np.asarray(v, np.float32)
                     for k, v in grads.items()})
        for k, v in MODES[mode].items():
            data[f"{mode}/raster/{k}"] = np.asarray(v)
    return data


@pytest.fixture(scope="module")
def fresh_fixture():
    return make_shutter_fixture()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_rolling_grads_match_jax(mode, fresh_fixture):
    """render_gut's backward through the general mode (on the CPU: the
    float64 autograd plain version of kernel C, then the plain fold, then
    autograd through the general table and the shutter-aware UT) against
    JAX's gradients of all six leaves."""
    cam, state = rolling_scene()
    tcam, model = torch_scene(cam, state)
    out = render_gut(tcam, UTConfig(), RasterConfig(**MODES[mode]), model,
                     GRAD_SH)
    loss = _loss(out["pred_features"], out["pred_opacity"],
                 out["pred_dist"], torch.mean)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               float(fresh_fixture[f"{mode}/loss"]),
                               rtol=1e-5)
    for k in NAMES:
        a = getattr(model, k).grad.double().numpy()
        b = fresh_fixture[f"{mode}/grad/{k}"].astype(np.float64)
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-3, rtol=0,
                                   err_msg=k)
        cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.9999, (k, cos)


def test_shutter_fixture_is_current(fresh_fixture):
    """The saved JAX values agree with a fresh JAX run within 1e-6, so the
    fixture chip_smoke.py reads cannot drift."""
    with np.load(FIXTURE) as saved:
        assert set(saved.files) == set(fresh_fixture)
        for k, v in fresh_fixture.items():
            if saved[k].dtype.kind in "fi":
                scale = max(1.0, float(np.abs(v).max()))
                np.testing.assert_allclose(saved[k], v, atol=1e-6 * scale,
                                           rtol=0, err_msg=k)
            else:
                assert str(saved[k]) == str(v), k
    assert os.path.getsize(FIXTURE) < 200_000


if __name__ == "__main__":
    # regenerate the fixture:
    #   PYTHONPATH=. python tests/test_torch_shutter_render.py
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (JAX on the CPU, highest precision)
    np.savez_compressed(FIXTURE, **make_shutter_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
