"""The port's cameras and rolling shutter against the JAX package (CPU).

Projection of the three camera models, the shutter time of the four
rolling shutters, the shutter solve, the fisheye rays, the mid-shutter
ray pose and the UT through each shutter. Tolerances, with reasons:
  * projections and rays: 2e-4 px and 1e-6 on unit directions: fp32
    with the same operation order, but XLA and PyTorch take atan2, sin,
    cos and the polynomial divisions to within an ulp of each other,
    which the focal length (tens to hundreds of px) scales;
  * the shutter solve floors the row of a pixel position
    (relative_shutter_time): a point within an ulp of a row boundary can
    take the other row in one package, which moves its shutter time by
    1/(H - 1) and its position by about the pose motion over one row. A
    flip is a point whose shutter time differs between the packages in
    any step of the solve (_shutter_flips). Flips are counted and
    bounded: at most 4 of 2000 points (0 measured in every camera and
    shutter of these tests), each within twice its shutter-time change
    times the point's start-to-end pose motion; every other point agrees
    within 2e-4 px with the same validity;
  * the UT on the particles none of whose sigma points flips (at most 1
    of 300 may; 0 measured): center 2e-4 px, conic, extent and opacity
    1e-4 relative.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cameras_shutter import (_ftheta_oracle_np, _make_ftheta_polys,
                                  _sample_points)
from threedgrut_tpu.ops import cameras as j_cam
from threedgrut_tpu.ops import quaternion as j_quat
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.ops.ut import unscented_projection as j_ut
from threedgrut_tpu.render.common import camera_rays_world as j_rays
from threedgrut_tpu_torch.ops import cameras as t_cam
from threedgrut_tpu_torch.ops.quaternion import (quat_normalize, quat_slerp,
                                                  quat_to_rotmat)
from threedgrut_tpu_torch.ops.ut import UTConfig, unscented_projection
from threedgrut_tpu_torch.render.common import camera_rays_world
from torch_port_utils import np32, torch_camera

RES = (64, 48)
RADIAL4 = (-0.03, -0.005, 0.001, -0.0002)
ROLLING = (j_cam.ShutterType.ROLLING_TOP_TO_BOTTOM,
           j_cam.ShutterType.ROLLING_LEFT_TO_RIGHT,
           j_cam.ShutterType.ROLLING_BOTTOM_TO_TOP,
           j_cam.ShutterType.ROLLING_RIGHT_TO_LEFT)


def _pose(yaw, t):
    """(t, q) of a world->camera pose turned ``yaw`` about y."""
    return (np.asarray(t, np.float32),
            np.asarray([math.cos(yaw / 2), 0.0, math.sin(yaw / 2), 0.0],
                       np.float32))


def jax_camera(kind, shutter=j_cam.ShutterType.GLOBAL, res=RES):
    """A JAX camera of ``kind`` (pinhole, fisheye, ftheta0, ftheta1) with
    the rolling shutter's start and end poses 0.1 and 0.03 rad apart."""
    w, h = res
    t, q = _pose(0.02, [0.05, -0.02, 0.1])
    t_end, q_end = _pose(0.05, [0.15, 0.02, 0.08])
    kw = dict(t=t, q=q, t_end=t_end, q_end=q_end, shutter_type=int(shutter))
    if kind == "pinhole":
        return j_cam.make_pinhole(
            res, (0.9 * w, 0.92 * w), (w / 2 + 0.3, h / 2 - 0.2),
            radial=[0.02, -0.004, 0.0005, 0.01, 0.0, 0.0],
            tangential=[0.001, -0.0005], thin_prism=[1e-4, 0, -1e-4, 0],
            **kw)
    if kind == "fisheye":
        return j_cam.make_fisheye(res, (0.45 * w, 0.45 * w),
                                  (w / 2, h / 2), RADIAL4, math.pi / 2, **kw)
    # the oracle's automotive lens scaled from 1920 px to this width
    fwd, inv = _make_ftheta_polys()
    s = w / 1920.0
    inv = inv / s ** np.arange(len(inv), dtype=np.float32)
    return j_cam.make_ftheta(res, (w / 2, h / 2), fwd * s, inv,
                             int(kind[-1]), (1.0, 0.001, -0.002), 1.6, **kw)


KINDS = ("pinhole", "fisheye", "ftheta0", "ftheta1")


def _world_points(n=2000, seed=0):
    """World points in front of the cameras, some far off-axis, a few
    behind."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-0.5, 6.0, n)
    p[:, :2] *= rng.uniform(0.2, 2.0, (n, 1)).astype(np.float32)
    return p


def test_quat_slerp_matches_jax():
    rng = np.random.default_rng(0)
    q0 = rng.normal(size=4).astype(np.float32)
    q0 /= np.linalg.norm(q0)
    for q1 in (q0.copy(), -q0, rng.normal(size=4).astype(np.float32)):
        q1 = q1 / np.linalg.norm(q1)
        t = rng.uniform(0, 1, (5, 7, 1)).astype(np.float32)
        got = quat_slerp(torch.tensor(q0), torch.tensor(q1), torch.tensor(t))
        ref = j_quat.quat_slerp(jnp.asarray(q0), jnp.asarray(q1),
                                jnp.asarray(t))
        np.testing.assert_allclose(np32(got), np.asarray(ref), atol=1e-6)
        np.testing.assert_allclose(
            np32(quat_slerp(torch.tensor(q0), torch.tensor(q1), 0.5)),
            np.asarray(j_quat.quat_slerp(jnp.asarray(q0), jnp.asarray(q1),
                                         0.5)), atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_projection_matches_jax(kind):
    jc = jax_camera(kind)
    tc = torch_camera(jc)
    p = _sample_points(512)
    p[:16, 2] = -p[:16, 2]            # behind the camera
    got, gv = t_cam.project_point(tc, torch.tensor(p), 0.1)
    ref, rv = j_cam.project_point(jc, jnp.asarray(p), 0.1)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    ok = np.asarray(rv)
    assert ok.sum() > 50
    np.testing.assert_allclose(np32(got)[ok], np.asarray(ref)[ok], atol=2e-4,
                               rtol=1e-6)


@pytest.mark.parametrize("reference_poly", [0, 1])
def test_ftheta_matches_numpy_oracle(reference_poly):
    """The port's FTheta against tests/test_cameras_shutter.py's literal
    numpy transcription of the reference (at the oracle's own lens)."""
    fwd, inv = _make_ftheta_polys()
    res = (1920, 1280)
    cde = (1.0, 0.001, -0.002)
    tc = t_cam.make_ftheta(res, (960.0, 640.0), fwd, inv, reference_poly,
                           cde, 1.6)
    p = _sample_points(512)
    got, gv = t_cam.project_point(tc, torch.tensor(p))
    ref, rv = _ftheta_oracle_np(p, fwd.astype(np.float64),
                                inv.astype(np.float64), cde, (960.0, 640.0),
                                1.6, reference_poly, res)
    ok = rv & gv.numpy()
    assert ok.sum() > 100
    assert (gv.numpy() != rv).mean() < 0.01
    np.testing.assert_allclose(np32(got)[ok], ref[ok], atol=5e-2)


def test_relative_shutter_time_matches_jax():
    uv = np.random.default_rng(1).uniform(-3, 70, (400, 2)).astype(
        np.float32)
    uv[:20] = np.round(uv[:20])       # exactly on row and column edges
    for shutter in (j_cam.ShutterType.GLOBAL,) + ROLLING:
        jc = jax_camera("pinhole", shutter)
        got = t_cam.relative_shutter_time(torch_camera(jc), torch.tensor(uv))
        ref = j_cam.relative_shutter_time(jc, jnp.asarray(uv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _shutter_flips(tc, jc, p, tolerance, n_iterations):
    """Per point, the largest difference between the two packages'
    shutter times over the ``n_iterations`` steps of the solve: the time
    each step takes from the previous step's projection (the seed's for
    the first). Non-zero marks a flip."""
    d_alpha = np.zeros(p.shape[:-1], np.float32)
    for k in range(n_iterations):
        got, _ = t_cam.project_point_with_shutter(tc, torch.tensor(p),
                                                  tolerance, k)
        ref, _ = j_cam.project_point_with_shutter(jc, jnp.asarray(p),
                                                  tolerance, k)
        d_alpha = np.maximum(d_alpha, np.abs(
            t_cam.relative_shutter_time(tc, got).numpy()
            - np.asarray(j_cam.relative_shutter_time(jc, ref))))
    return d_alpha


@pytest.mark.parametrize("kind", ["pinhole", "fisheye"])
@pytest.mark.parametrize("shutter", ROLLING)
def test_shutter_solve_matches_jax(kind, shutter):
    """project_point_with_shutter against JAX: flips (a point whose row
    or column floors the other way in one package: module docstring)
    are counted and bounded; the rest agree."""
    p = _world_points()
    jc = jax_camera(kind, shutter)
    tc = torch_camera(jc)
    got, gv = t_cam.project_point_with_shutter(tc, torch.tensor(p), 0.1, 5)
    ref, rv = j_cam.project_point_with_shutter(jc, jnp.asarray(p), 0.1, 5)
    got, gv, ref, rv = np32(got), gv.numpy(), np.asarray(ref), np.asarray(rv)
    d_alpha = _shutter_flips(tc, jc, p, 0.1, 5)
    flip = d_alpha > 0
    assert flip.sum() <= 4, flip.sum()
    assert rv.sum() > 200
    err = np.abs(got - ref).max(axis=-1)
    np.testing.assert_array_equal(gv[~flip], rv[~flip])
    np.testing.assert_allclose(got[~flip & rv], ref[~flip & rv], atol=2e-4,
                               rtol=0)
    # a flipped point moves by about its pose motion over one row
    start, sv = t_cam.project_point(tc, t_cam.world_to_camera(
        tc, torch.tensor(p)), 0.1)
    end, ev = t_cam.project_point(tc, t_cam.world_to_camera(
        tc, torch.tensor(p), tc.t_end, tc.q_end), 0.1)
    motion = np.abs(np32(end) - np32(start)).max(axis=-1)
    bounded = flip & gv & rv & sv.numpy() & ev.numpy()
    assert (err[bounded] <= 2.0 * d_alpha[bounded] * motion[bounded]
            + 2e-4).all()
    # the rolling pose moves the projection: not the global solve
    glob, _ = t_cam.project_point(
        torch_camera(jax_camera(kind)),
        t_cam.world_to_camera(torch_camera(jax_camera(kind)),
                              torch.tensor(p)), 0.1)
    assert np.abs(np32(glob) - got)[rv].max() > 0.1


def test_shutter_solve_invalid_when_both_seeds_fail():
    """A point invalid through both the start and the end pose stays
    invalid, even if an interpolated pose would see it (the reference's
    early out, cameraProjections.cuh:227-232)."""
    jc = jax_camera("pinhole", j_cam.ShutterType.ROLLING_TOP_TO_BOTTOM)
    tc = torch_camera(jc)
    p = np.array([[0.0, 0.0, -2.0], [40.0, 0.0, 1.0], [0.0, 0.3, 3.0]],
                 np.float32)
    got, gv = t_cam.project_point_with_shutter(tc, torch.tensor(p), 0.0, 5)
    ref, rv = j_cam.project_point_with_shutter(jc, jnp.asarray(p), 0.0, 5)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    assert gv.tolist() == [False, False, True]
    _, v0 = t_cam.project_point(tc, t_cam.world_to_camera(tc,
                                                          torch.tensor(p)))
    _, v1 = t_cam.project_point(tc, t_cam.world_to_camera(
        tc, torch.tensor(p), tc.t_end, tc.q_end))
    assert not bool(v0[0] | v1[0]) and not bool(v0[1] | v1[1])


def test_fisheye_rays_match_jax():
    """The fisheye ray solve, including pixels past the image circle: the
    Newton solve starts at theta = min(r, max_angle), and where r lies
    beyond the largest radius the lens polynomial reaches it diverges to
    NaN in both packages (a dead ray: it hits nothing)."""
    w, h = RES
    for max_angle, focal in ((0.8, 0.45), (math.pi / 2, 0.2)):
        args = (w, h, (focal * w, focal * w), (w / 2, h / 2), RADIAL4,
                max_angle)
        got = t_cam.fisheye_camera_rays(*args)
        ref = j_cam.fisheye_camera_rays(
            w, h, jnp.asarray(args[2]), jnp.asarray(args[3]),
            jnp.asarray(RADIAL4), max_angle)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.isnan(np32(g)),
                                          np.isnan(np.asarray(r)))
            np.testing.assert_allclose(np32(g), np.asarray(r), atol=1e-6)
        y, x = np.mgrid[0:h, 0:w] + 0.5
        radius = np.hypot(x - w / 2, y - h / 2) / (focal * w)
        assert (radius > max_angle).any()        # pixels past the circle
        dead = np.isnan(np32(got[1])).any(-1)
        assert dead.any() == (focal == 0.2)
        assert not dead[radius < 1.0].any()


@pytest.mark.parametrize("kind", ["pinhole", "fisheye"])
@pytest.mark.parametrize("shutter", [j_cam.ShutterType.GLOBAL,
                                     j_cam.ShutterType.ROLLING_TOP_TO_BOTTOM])
def test_camera_rays_world_matches_jax(kind, shutter):
    """World rays through the ray-generation pose: the start pose for a
    global shutter, the mid-shutter pose for a rolling one."""
    jc = jax_camera(kind, shutter)
    got = camera_rays_world(torch_camera(jc))
    ref = j_rays(jc)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np32(g), np.asarray(r), atol=2e-6)
    if shutter != j_cam.ShutterType.GLOBAL:
        start = camera_rays_world(torch_camera(jax_camera(kind)))
        assert float((start[0] - got[0]).abs().max()) > 1e-2


def test_camera_rays_world_refuses_ftheta():
    """The JAX function casts pinhole rays through FTheta's focal (1, 1),
    which is wrong (ROADMAP.md section 3); the port raises."""
    with pytest.raises(NotImplementedError, match="FTheta"):
        camera_rays_world(torch_camera(jax_camera("ftheta1")))


def _ut_inputs(n=300, seed=2):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    pos[:, :2] *= 0.8
    pos[:, 2] = rng.uniform(1.0, 6.0, n)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    scale = rng.uniform(0.02, 0.2, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    active = np.arange(n) < n - 10
    return pos, quat, scale, opac, active


@pytest.mark.parametrize("kind", ["pinhole", "fisheye"])
@pytest.mark.parametrize("shutter", (j_cam.ShutterType.GLOBAL,) + ROLLING)
def test_unscented_projection_matches_jax(kind, shutter):
    jc = jax_camera(kind, shutter)
    ins = _ut_inputs()
    got = unscented_projection(torch_camera(jc), UTConfig(),
                               *map(torch.tensor, ins))
    ref = j_ut(jc, JUTConfig(), *map(jnp.asarray, ins))
    valid = np.asarray(ref.valid)
    # particles with a shutter flip among their sigma points (module
    # docstring), on the sigma points of ops/ut.py:unscented_projection
    cfg = UTConfig()
    pos, quat, scale = map(torch.tensor, ins[:3])
    axes = quat_to_rotmat(quat_normalize(quat)) * scale[:, None, :]
    deltas = cfg.delta * axes.transpose(1, 2)
    sigma = torch.cat([pos[:, None], pos[:, None] + deltas,
                       pos[:, None] - deltas], dim=1).numpy()
    flip = (_shutter_flips(torch_camera(jc), jc, sigma,
                           cfg.image_margin_factor,
                           cfg.n_rolling_shutter_iterations) > 0).any(-1)
    assert flip.sum() <= 1, flip.sum()
    same = ~flip & valid
    assert same.sum() > 100
    np.testing.assert_array_equal(got.valid.numpy()[~flip], valid[~flip])
    np.testing.assert_allclose(np32(got.center)[same],
                               np.asarray(ref.center)[same], atol=2e-4,
                               rtol=0)
    for k in ("conic", "opacity", "extent"):
        g, r = np32(getattr(got, k))[same], np.asarray(getattr(ref, k))[same]
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("depth", "view_dir"):      # the start pose: no flips there
        np.testing.assert_allclose(np32(getattr(got, k))[valid],
                                   np.asarray(getattr(ref, k))[valid],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
