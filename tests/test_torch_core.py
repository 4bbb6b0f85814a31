"""Core math of the PyTorch port against the JAX package on the CPU:
quaternions, SH, the pinhole camera and the particle response.

Tolerance: atol 1e-6 on fp32 values of order 1. Both sides compute the
same formulas in fp32; the differences left are reassociations in
library reductions (a few ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu.ops import cameras as j_cam
from threedgrut_tpu.ops import hit as j_hit
from threedgrut_tpu.ops import quaternion as j_quat
from threedgrut_tpu.ops import sh as j_sh
from threedgrut_tpu_torch.ops import cameras as t_cam
from threedgrut_tpu_torch.ops import hit as t_hit
from threedgrut_tpu_torch.ops import quaternion as t_quat
from threedgrut_tpu_torch.ops import sh as t_sh
from torch_port_utils import np32, torch_camera

ATOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_quaternion():
    q = _rng(0).normal(size=(64, 4)).astype(np.float32)
    qn_j = np.asarray(j_quat.quat_normalize(jnp.asarray(q)))
    qn_t = np32(t_quat.quat_normalize(torch.from_numpy(q)))
    np.testing.assert_allclose(qn_t, qn_j, atol=ATOL, rtol=0)
    r_j = np.asarray(j_quat.quat_to_rotmat(jnp.asarray(qn_j)))
    r_t = np32(t_quat.quat_to_rotmat(torch.tensor(qn_j)))
    np.testing.assert_allclose(r_t, r_j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh(degree):
    rng = _rng(degree)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = j_sh.num_sh_coeffs(3)
    coeffs = (rng.normal(size=(128, k, 3)) * 0.3).astype(np.float32)
    assert t_sh.num_sh_coeffs(degree) == j_sh.num_sh_coeffs(degree)
    np.testing.assert_allclose(
        np32(t_sh.sh_basis(torch.from_numpy(d), degree)),
        np.asarray(j_sh.sh_basis(jnp.asarray(d), degree)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        np32(t_sh.eval_sh_radiance(torch.from_numpy(coeffs),
                                   torch.from_numpy(d), degree)),
        np.asarray(j_sh.eval_sh_radiance(jnp.asarray(coeffs), jnp.asarray(d),
                                         degree)), atol=ATOL, rtol=0)
    rgb = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np32(t_sh.rgb_to_sh0(torch.from_numpy(rgb))),
        np.asarray(j_sh.rgb_to_sh0(jnp.asarray(rgb))), atol=ATOL, rtol=0)


def _distorted_pinhole():
    rng = _rng(7)
    return j_cam.make_pinhole(
        resolution=(64, 48), focal=(58.0, 57.0), principal=(31.5, 24.5),
        radial=(0.02, -0.01, 0.001, 0.01, 0.0, 0.0),
        tangential=(0.001, -0.002), thin_prism=(0.001, 0.0, -0.001, 0.0),
        t=rng.normal(size=3).astype(np.float32) * 0.1,
        q=np.array([0.99, 0.05, -0.08, 0.03], np.float32)
        / np.linalg.norm([0.99, 0.05, -0.08, 0.03]))


def test_pinhole_projection():
    cam = _distorted_pinhole()
    tcam = torch_camera(cam)
    rng = _rng(1)
    p = np.concatenate([rng.uniform(-1.5, 1.5, (256, 2)),
                        rng.uniform(-0.5, 4.0, (256, 1))],
                       axis=1).astype(np.float32)
    for tol in (0.0, 0.1):
        uv_j, ok_j = j_cam.project_point(cam, jnp.asarray(p), tol)
        uv_t, ok_t = t_cam.project_point(tcam, torch.from_numpy(p), tol)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        # pixel units (values up to ~100 px): 1e-6 relative
        np.testing.assert_allclose(np32(uv_t), np.asarray(uv_j),
                                   atol=ATOL * 100, rtol=1e-6)
    w_j = j_cam.world_to_camera(cam, jnp.asarray(p), cam.t_start, cam.q_start)
    np.testing.assert_allclose(
        np32(t_cam.world_to_camera(tcam, torch.from_numpy(p))),
        np.asarray(w_j), atol=ATOL * 4, rtol=0)


def test_pinhole_rays():
    o_j, d_j = j_cam.pinhole_camera_rays(64, 48, 58.0, 57.0, 31.5, 24.5)
    o_t, d_t = t_cam.pinhole_camera_rays(64, 48, 58.0, 57.0, 31.5, 24.5)
    np.testing.assert_array_equal(np32(o_t), np.asarray(o_j))
    np.testing.assert_allclose(np32(d_t), np.asarray(d_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(np32(d_t), axis=-1), 1.0,
                               atol=1e-6)


def test_camera_rays_world():
    from threedgrut_tpu.render.common import camera_rays_world as j_rays
    from threedgrut_tpu_torch.render.common import camera_rays_world as t_rays

    cam = _distorted_pinhole()
    o_j, d_j = j_rays(cam)
    o_t, d_t = t_rays(torch_camera(cam))
    np.testing.assert_allclose(np32(o_t), np.asarray(o_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np32(d_t), np.asarray(d_j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4, 5, 8])
def test_particle_response(degree):
    sq = _rng(degree).uniform(0, 12, 512).astype(np.float32)
    np.testing.assert_allclose(
        np32(t_hit.particle_response(torch.from_numpy(sq), degree)),
        np.asarray(j_hit.particle_response(jnp.asarray(sq), degree)),
        atol=ATOL, rtol=0)
    assert t_hit._GG_SCALE == j_hit._GG_SCALE


def test_density_hit():
    rng = _rng(3)
    n = 256
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = (d * rng.uniform(2, 5, (n, 1))
           + rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    scale = rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)
    dens = rng.uniform(0.1, 0.99, n).astype(np.float32)
    hj = j_hit.density_hit(*(jnp.asarray(a) for a in
                             (o, d, pos, quat, scale, dens)))
    ht = t_hit.density_hit(*(torch.from_numpy(a) for a in
                             (o, d, pos, quat, scale, dens)))
    np.testing.assert_array_equal(ht.accept.numpy(), np.asarray(hj.accept))
    # the canonical transform divides by scales down to 0.05, which
    # amplifies fp32 rounding of the world-frame inputs ~20x: 1e-5
    np.testing.assert_allclose(np32(ht.alpha), np.asarray(hj.alpha),
                               atol=1e-5, rtol=0)
    # distances of a few world units
    np.testing.assert_allclose(np32(ht.hit_t), np.asarray(hj.hit_t),
                               atol=1e-5, rtol=1e-5)


def test_orbit_camera():
    from threedgrut_tpu.playground.web_gui import orbit_camera as j_orbit

    for az, el in ((0.0, 0.35), (2.1, -0.4), (4.0, 1.2)):
        cj = j_orbit(az, el, 5.0, center=(0.1, -0.2, 4.0),
                     resolution=(64, 48))
        ct = t_cam.orbit_camera(az, el, 5.0, center=(0.1, -0.2, 4.0),
                                resolution=(64, 48))
        for f in ("focal", "principal", "t_start", "q_start"):
            np.testing.assert_allclose(np32(getattr(ct, f)),
                                       np.asarray(getattr(cj, f)),
                                       atol=ATOL, rtol=0, err_msg=f)


@pytest.mark.parametrize("name,color", [("background-color", "black"),
                                        ("background-color", "white"),
                                        ("background-color", "random"),
                                        ("skip-background", "black")])
def test_background(name, color):
    from threedgrut_tpu.models import background as j_bg
    from threedgrut_tpu_torch.models import background as t_bg

    bj = j_bg.background_color(j_bg.BackgroundConfig(name=name, color=color))
    bt = t_bg.background_color(t_bg.BackgroundConfig(name=name, color=color))
    assert (bj is None) == (bt is None)
    rng = _rng(5)
    feat = rng.uniform(0, 1, (8, 6, 3)).astype(np.float32)
    opac = rng.uniform(0, 1, (8, 6, 1)).astype(np.float32)
    out_j = j_bg.apply_background(jnp.asarray(feat), jnp.asarray(opac), bj)
    out_t = t_bg.apply_background(torch.tensor(feat), torch.tensor(opac), bt)
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), atol=ATOL,
                               rtol=0)
