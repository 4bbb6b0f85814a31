"""UT projection of the PyTorch port against the JAX package on the CPU.

Every ``Projection`` field on ``make_test_scene`` scenes and on the
shared ``parity_cloud.ply``. ``valid`` must be equal. Floats: rtol 1e-5
(fp32 chains of ~30 operations through the sigma points and the 2x2
covariance, each side reassociating its small sums), with an absolute
floor of 1e-5 of each field's scale for values that cross zero.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from threedgrut_tpu.export.ply import import_model
from threedgrut_tpu.ops import ut as j_ut
from threedgrut_tpu.ops.cameras import make_pinhole
from threedgrut_tpu_torch.models.gaussians import GaussianModel
from threedgrut_tpu_torch.ops import ut as t_ut
from torch_port_utils import np32, torch_camera, torch_scene

PLY = os.path.join(os.path.dirname(__file__), "fixtures", "parity_cloud.ply")


def _project_both(cam, state, tmodel=None):
    jp = j_ut.unscented_projection(
        cam, j_ut.UTConfig(), state.params.positions, state.params.rotation,
        state.get_scale(), state.get_density()[:, 0], state.active_mask())
    tcam = torch_camera(cam)
    if tmodel is None:
        _, tmodel = torch_scene(cam, state)
    with torch.no_grad():
        tp = t_ut.unscented_projection(
            tcam, t_ut.UTConfig(), tmodel.positions, tmodel.rotation,
            tmodel.get_scale(), tmodel.get_density()[:, 0],
            tmodel.active_mask())
    return jp, tp


def _assert_projection_close(jp, tp):
    valid = np.asarray(jp.valid)
    np.testing.assert_array_equal(tp.valid.numpy(), valid)
    assert valid.any()
    for field in ("center", "conic", "opacity", "extent", "depth",
                  "view_dir"):
        a, b = np32(getattr(tp, field)), np.asarray(getattr(jp, field))
        if field == "depth":   # inf on invalid particles, on both sides
            np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
            a, b = a[valid], b[valid]
        scale = float(np.abs(b[np.isfinite(b)]).max())
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=field)


@pytest.mark.parametrize("seed", [0, 1])
def test_projection_test_scene(seed):
    cam, state = make_test_scene(n=96, capacity=128, n_active=80, seed=seed,
                                 res=(64, 48))
    jp, tp = _project_both(cam, state)
    _assert_projection_close(jp, tp)
    assert not tp.valid[80:].any()   # dead capacity rows never project


def test_projection_parity_cloud():
    state = import_model(PLY)
    cam = make_pinhole(resolution=(96, 64), focal=(80.0, 80.0),
                       principal=(48.0, 32.0), t=(0.0, 0.0, 2.5))
    tmodel = GaussianModel.from_ply(PLY, device="cpu")
    np.testing.assert_array_equal(tmodel.positions.detach().numpy(),
                                  np.asarray(state.params.positions))
    jp, tp = _project_both(cam, state, tmodel)
    _assert_projection_close(jp, tp)


def test_sensor_position_and_tile_helpers():
    cam, state = make_test_scene(n=64, seed=2, res=(64, 48))
    tcam = torch_camera(cam)
    np.testing.assert_allclose(np32(t_ut.sensor_position(tcam)),
                               np.asarray(j_ut.sensor_position(cam)),
                               atol=1e-6)
    jp, tp = _project_both(cam, state)
    grid = (4, 3)
    lo_j, hi_j = j_ut.tile_bbox(jp.center, jp.extent, grid)
    lo_t, hi_t = t_ut.tile_bbox(torch.tensor(np.asarray(jp.center)),
                                torch.tensor(np.asarray(jp.extent)), grid)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    # the per-tile cull power on every (tile, particle) pair: same fp32
    # operation order on both sides, so equal to the last bit
    ty, tx = np.meshgrid(np.arange(3), np.arange(4), indexing="ij")
    txy = np.stack([tx, ty], -1).reshape(-1, 1, 2).astype(np.float32)
    conic = np.asarray(jp.conic)[None]
    center = np.asarray(jp.center)[None]
    pj = np.asarray(j_ut.tile_min_power_response(
        jnp.asarray(txy), jnp.asarray(conic), None, jnp.asarray(center)))
    pt = t_ut.tile_min_power_response(torch.tensor(txy), torch.tensor(conic),
                                      torch.tensor(center)).numpy()
    valid = np.asarray(jp.valid)
    np.testing.assert_array_equal(pt[:, valid], pj[:, valid])
