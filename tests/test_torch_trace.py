"""``trace()`` of the PyTorch port against the JAX package's, on the CPU.

Arbitrary rays against the mixture in 256-ray blocks, in both regimes:
brute force (every block walks one shared segment of all slots: the
shared-segment mode of kernels B and C, the TPU's kernel 7) and the
uniform grid (``build_grid``, per-block candidate lists); sorted per ray
in windows of 128, or in rank order (``_sorted=False``). The JAX kernels
run in Pallas interpret mode; the port runs the plain versions of its
kernels (tests/test_torch_gpu.py holds the kernels to those on the
card). Normals (``enable_normals``) against JAX's pure-JAX oracle and
JAX's trace. Tolerances, with reasons:

  * features and opacity 1e-4, depth 1e-3 relative, hit counts equal
    (measured ~4e-6: float64 against fp32 compositing, the hit math in
    fp32 on both sides);
  * gradients 2e-3 max-normalised, as the raster slices' (measured
    ~6e-5);
  * ``build_grid``'s arrays: ids equal, floats 1e-6; ``accel_overflow``
    equal;
  * normals 2e-3 (measured ~5e-6).

One JAX run serves several asserts: the module fixtures run each JAX
configuration once.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu.render.grt import build_grid as j_build_grid
from threedgrut_tpu.render.grt import trace as j_trace
from threedgrut_tpu.render.oracle import render_oracle as j_render_oracle
from threedgrut_tpu_torch.convert import model_from_state
from threedgrut_tpu_torch.ops.cuda import raster as t_raster
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.render import grt as t_grt
from threedgrut_tpu_torch.render.grt import build_grid, trace
from threedgrut_tpu_torch.render.gut import render_gut
from threedgrut_tpu_torch.render.oracle import render_oracle
from torch_port_utils import np32, torch_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX's sorted trace gradients (windows of 128, the brute force), for the
# card's kernels too (chip_smoke.py phase 32)
FIXTURE = os.path.join(REPO, "tests", "fixtures",
                       "torch_port_trace_grad_small.npz")
NAMES = ("positions", "rotation", "scale", "density", "features_albedo",
         "features_specular")
# 300 rays: two 256-ray blocks, the second padded
N_RAYS = 300
# JAX's max_pairs for its camera renders (trace ignores it)
J_RC = JRasterConfig(max_pairs=1 << 12)
# a 4^3 grid with room for every cell list (no truncation), and one whose
# cell lists and global list overflow
GRID = dict(grid_dims=4, max_cells=64, cell_cap=64, global_cap=256)
GRID_SMALL = dict(grid_dims=4, max_cells=8, cell_cap=8, global_cap=16)
KEYS = ("pred_features", "pred_opacity", "pred_dist", "hits_count")


def _rays(seed=0, n=N_RAYS):
    """Rays from a small patch at z = -6 toward +z (test_grt.py's)."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    ro[:, 2] = -6.0
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 2] = np.abs(rd[:, 2]) + 2.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


@pytest.fixture(scope="module")
def scene():
    _, state = make_test_scene(n=200, capacity=256, seed=4, res=(32, 32))
    return state, _rays()


def _port_trace(state, ro, rd, **kw):
    with torch.no_grad():
        return trace(model_from_state(state), torch.tensor(ro),
                     torch.tensor(rd), sh_degree=1, **kw)


def _jax_value_and_grad(state, ro, rd, **kw):
    """JAX's trace outputs and the gradient of mean(features) + 0.1
    mean(opacity) in the parameters (rank order: the sorted vjp's
    interpret-mode compile takes minutes), from one JAX run."""
    def loss(params):
        out = j_trace(state.replace(params=params), jnp.asarray(ro),
                      jnp.asarray(rd), sh_degree=1, raster_cfg=J_RC,
                      _sorted=False, interpret=True, **kw)
        return (jnp.mean(out["pred_features"])
                + 0.1 * jnp.mean(out["pred_opacity"])), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(state.params)
    return out, grads


@pytest.fixture(scope="module")
def jax_brute(scene):
    """JAX's brute-force trace: sorted (with normals), and in rank order
    with its gradient."""
    state, (ro, rd) = scene
    rank, grads = _jax_value_and_grad(state, ro, rd, accelerate=False)
    return {True: j_trace(state, jnp.asarray(ro), jnp.asarray(rd),
                          sh_degree=1,
                          raster_cfg=J_RC.replace(enable_normals=True),
                          accelerate=False, interpret=True),
            False: rank, "grads": grads}


@pytest.fixture(scope="module")
def jax_grid_small(scene):
    """JAX's grid trace with cut cell lists, rank order, and its
    gradient."""
    state, (ro, rd) = scene
    return _jax_value_and_grad(state, ro, rd, accelerate=True,
                               **GRID_SMALL)


def _close(got, ref, keys=KEYS):
    for k in keys:
        g, r = np32(got[k]), np32(ref[k])
        assert g.shape == r.shape, k
        if k == "hits_count":
            np.testing.assert_array_equal(g, r)
        elif k == "pred_dist":
            np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-3)
        else:
            np.testing.assert_allclose(g, r, atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("srt", [True, False], ids=["sorted", "rank"])
def test_brute_forward_matches_jax(scene, jax_brute, srt):
    state, (ro, rd) = scene
    got = _port_trace(state, ro, rd, accelerate=False, _sorted=srt,
                      raster_cfg=RasterConfig(enable_normals=srt))
    assert float(got["pred_opacity"].max()) > 0.5
    _close(got, jax_brute[srt])
    if srt:   # trace's normals (sorted windows) against JAX's
        assert got["pred_normals"].shape == (N_RAYS, 3)
        np.testing.assert_allclose(np32(got["pred_normals"]),
                                   np32(jax_brute[True]["pred_normals"]),
                                   atol=2e-3, rtol=0)
        assert "pred_normals" not in _port_trace(state, ro, rd,
                                                 accelerate=False)


def _port_grads(state, ro, rd, **kw):
    model = model_from_state(state)
    out = trace(model, torch.tensor(ro), torch.tensor(rd), sh_degree=1,
                _sorted=False, **kw)
    (out["pred_features"].mean() + 0.1 * out["pred_opacity"].mean()
     ).backward()
    return {k: p.grad.numpy() for k, p in model.params().items()}


def _grads_close(got, ref):
    for k, g in got.items():
        r = np.asarray(getattr(ref, k))
        scale = np.abs(r).max() + 1e-12
        assert scale > 1e-10 and np.isfinite(g).all(), k
        np.testing.assert_allclose(g / scale, r / scale, atol=2e-3, rtol=0,
                                   err_msg=k)


def test_brute_gradients_accumulate_across_blocks(scene, jax_brute,
                                                  monkeypatch):
    """Gradients through the shared segment (two blocks reading every
    slot) against JAX's read-modify-write backward, rank order; and the
    same gradients when the blocks' rows fold in groups of one block."""
    state, (ro, rd) = scene
    got = _port_grads(state, ro, rd, accelerate=False)
    _grads_close(got, jax_brute["grads"])
    # one block of gradient rows per fold group
    monkeypatch.setattr(t_raster, "SHARED_BWD_BYTES", 256 * 16 * 4)
    grouped = _port_grads(state, ro, rd, accelerate=False)
    for k, g in got.items():
        np.testing.assert_allclose(grouped[k], g, atol=1e-6 * (
            np.abs(g).max() + 1e-12), rtol=0, err_msg=k)


def test_build_grid_matches_jax(scene):
    state, (ro, _) = scene
    origin = ro.mean(0)
    ref = j_build_grid(state, jnp.asarray(origin), grid_dims=4,
                       global_cap=16)
    got = build_grid(model_from_state(state), torch.tensor(origin),
                     grid_dims=4, global_cap=16)
    assert got.dims == ref.dims == 4
    for k in ("pair_particle", "seg_start", "global_particle", "overflow"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)
    assert int(got.overflow) > 0      # 16 is fewer than the large ones
    for k in ("lo", "cs", "pair_rank", "global_rank", "rank_origin"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_grid_forward_and_overflow_match_jax(scene, jax_grid_small):
    """The grid with caps small enough that cell lists are cut and large
    particles dropped: the same candidates as JAX's, so the same render
    and the same ``accel_overflow``."""
    state, (ro, rd) = scene
    ref, _ = jax_grid_small
    got = _port_trace(state, ro, rd, accelerate=True, _sorted=False,
                      **GRID_SMALL)
    assert int(got["accel_overflow"]) == int(ref["accel_overflow"]) > 0
    _close(got, ref)


def test_grid_matches_brute_and_reuses_accel(scene):
    """In the port: under rank order the grid (no truncation) composites
    the brute-force sequence; sorted, its windows fall on other
    boundaries, so the renders differ a little (test_grt.py's bounds for
    CHUNK 128); a prebuilt GridAccel gives the per-call build's render."""
    state, (ro, rd) = scene
    model = model_from_state(state)
    args = (torch.tensor(ro), torch.tensor(rd))
    with torch.no_grad():
        brute = trace(model, *args, sh_degree=1, accelerate=False,
                      _sorted=False)
        grid = trace(model, *args, sh_degree=1, accelerate=True,
                     _sorted=False, **GRID)
        assert int(grid["accel_overflow"]) == 0
        _close(grid, brute)
        brute_s = trace(model, *args, sh_degree=1, accelerate=False)
        grid_s = trace(model, *args, sh_degree=1, accelerate=True, **GRID)
        d = np.abs(np32(grid_s["pred_features"])
                   - np32(brute_s["pred_features"]))
        assert d.mean() < 2e-3 and d.max() < 0.15, (d.mean(), d.max())
        accel = build_grid(model, torch.tensor(ro).mean(0), grid_dims=4,
                           global_cap=GRID["global_cap"])
        kw = {k: v for k, v in GRID.items() if k != "grid_dims"}
        reused = trace(model, *args, sh_degree=1, accel=accel, **kw)
        _close(reused, grid_s)


def test_grid_gradients_match_jax(scene, jax_grid_small):
    """The grid's backward (per-block segments, the pairs folded by
    particle, the dead row's pairs by none) against JAX's, rank order,
    the small grid."""
    state, (ro, rd) = scene
    got = _port_grads(state, ro, rd, accelerate=True, **GRID_SMALL)
    _grads_close(got, jax_grid_small[1])


def _tie_scene():
    """Particles 0 and 1 tied in rank (mirror images in y about the rays'
    origin), both straddling the cell boundary x = 0 of a 4^3 grid inside
    the same y and z cells, so each is in the same two cell lists; four
    more set the grid's extent. One 256-ray block from the origin looks
    at both."""
    _, state = make_test_scene(n=6, capacity=256, seed=9)
    p = state.params
    pos = np.asarray(p.positions).copy()
    pos[:6] = [(0.0, 0.3, 4.0), (0.0, -0.3, 4.0), (-2.0, -2.0, 2.0),
               (2.0, 3.0, 8.0), (-2.0, 3.0, 8.0), (2.0, -2.0, 2.0)]
    quat = np.asarray(p.rotation).copy()
    quat[:6] = (1.0, 0.0, 0.0, 0.0)
    scale = np.asarray(p.scale).copy()
    scale[:6] = 0.05
    dens = np.asarray(p.density).copy()
    dens[:2] = 0.9
    state = state.replace(params=p.replace(
        positions=jnp.asarray(pos), rotation=jnp.asarray(quat),
        scale=jnp.asarray(scale), density=jnp.asarray(dens)))
    y, x = np.meshgrid(np.linspace(-0.45, 0.45, 16),
                       np.linspace(-0.1, 0.1, 16), indexing="ij")
    rd = np.stack([x, y, np.full_like(x, 4.0)], -1).reshape(-1, 3)
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return state, np.zeros_like(rd), rd


def test_grid_rank_tie_keeps_one_copy_where_jax_keeps_two():
    """Two particles tied in rank, each in two selected cells: JAX sorts
    the candidates by rank alone, so the copies interleave, its adjacent
    de-duplication misses one, and its grid composites a particle twice
    (opacity above its own brute force). The port breaks rank ties by
    particle id: one copy each, and its grid equals brute force, JAX's
    included."""
    state, ro, rd = _tie_scene()
    grid = dict(grid_dims=4, max_cells=64, cell_cap=4, global_cap=16)
    model = model_from_state(state)
    args = (torch.tensor(ro), torch.tensor(rd))
    with torch.no_grad():
        origin = args[0].mean(0)
        ranks = torch.linalg.norm(model.positions[:2] - origin, dim=1)
        assert float(ranks[0]) == float(ranks[1])
        accel = build_grid(model, origin, grid_dims=4, global_cap=16)
        listed = accel.pair_particle[:int(accel.seg_start[4 ** 3])]
        for pid in (0, 1):   # two cell lists each, no global list
            assert int((listed == pid).sum()) == 2
        inp = t_grt.prepare_trace(model, *args, accelerate=True,
                                  _sorted=False, **grid)
        for pid in (0, 1):
            assert int((inp.pair_particle == pid).sum()) == 1
    got = _port_trace(state, ro, rd, accelerate=True, _sorted=False, **grid)
    brute = _port_trace(state, ro, rd, accelerate=False, _sorted=False)
    assert int(got["accel_overflow"]) == 0
    assert float(brute["pred_opacity"].max()) > 0.5
    _close(got, brute)
    j = {acc: j_trace(state, jnp.asarray(ro), jnp.asarray(rd), sh_degree=1,
                      raster_cfg=J_RC, accelerate=acc, _sorted=False,
                      interpret=True, **(grid if acc else {}))
         for acc in (False, True)}
    _close(got, j[False])
    over = np32(j[True]["pred_opacity"]) - np32(j[False]["pred_opacity"])
    assert over.max() > 0.05, over.max()


def test_trace_ray_layouts_and_t_bounds(scene):
    """Rays in any leading shape; per-ray t_max; padded rays see nothing."""
    state, (ro, rd) = scene
    model = model_from_state(state)
    lead = (3, 5)
    o = torch.tensor(ro[:15]).reshape(*lead, 3)
    d = torch.tensor(rd[:15]).reshape(*lead, 3)
    with torch.no_grad():
        full = trace(model, o, d, sh_degree=1)
        cut = trace(model, o, d, sh_degree=1,
                    t_max=torch.full(lead, 1e-3))
    assert full["pred_features"].shape == (3, 5, 3)
    assert full["pred_opacity"].shape == (3, 5, 1)
    assert float(full["pred_opacity"].max()) > 0.1
    assert float(cut["pred_opacity"].abs().max()) == 0.0


def test_render_gut_normals_match_jax_oracle():
    """``render_gut``'s and the port oracle's normals against JAX's
    pure-JAX ``render_oracle``, both geometries' kernel math (the shared
    origin here; trace's general mode above)."""
    cam, state = make_test_scene(n=96, seed=0, res=(48, 32))
    tcam, model = torch_scene(cam, state)
    ref = j_render_oracle(cam, JUTConfig(), JRasterConfig(
        max_pairs=1 << 13, enable_normals=True), state, 2)
    rc = RasterConfig(enable_normals=True)
    with torch.no_grad():
        got = render_gut(tcam, UTConfig(), rc, model, 2)
        orc = render_oracle(tcam, UTConfig(), rc, model, 2)
        plain = render_gut(tcam, UTConfig(), RasterConfig(), model, 2)
    r = np32(ref["pred_normals"])
    assert np.abs(r).max() > 0.5
    for out in (got, orc):
        np.testing.assert_allclose(np32(out["pred_normals"]), r, atol=2e-3,
                                   rtol=0)
    # normals change nothing else, and are absent unless asked for
    assert "pred_normals" not in plain
    np.testing.assert_array_equal(np32(got["pred_features"]),
                                  np32(plain["pred_features"]))


def _fixture_scene():
    _, state = make_test_scene(n=48, capacity=64, seed=6)
    return state, _rays(seed=3)


def _fixture_loss(out, mean):
    """chip_smoke.py:fixture_loss: squared features, opacity, depth."""
    return (mean(out["pred_features"] ** 2) + 0.1 * mean(out["pred_opacity"])
            + 0.01 * mean(out["pred_dist"]))


def make_grad_fixture():
    """JAX's sorted brute-force trace (windows of 128) and its gradients
    in interpret mode: the sorted vjp compiles in about a minute."""
    state, (ro, rd) = _fixture_scene()

    def loss(params):
        out = j_trace(state.replace(params=params), jnp.asarray(ro),
                      jnp.asarray(rd), sh_degree=1, raster_cfg=J_RC,
                      accelerate=False, interpret=True)
        return _fixture_loss(out, jnp.mean), out["pred_features"]

    (val, feats), g = jax.value_and_grad(loss, has_aux=True)(state.params)
    data = {f"params/{k}": np.asarray(getattr(state.params, k))
            for k in NAMES}
    data.update({f"grad/{k}": np.asarray(getattr(g, k), np.float32)
                 for k in NAMES})
    data.update(n_active=np.int32(state.n_active),
                n_active_features=np.int32(state.n_active_features),
                density_activation=state.config.density_activation,
                scale_activation=state.config.scale_activation,
                ray_o=ro, ray_d=rd, sh_degree=np.int32(1),
                loss=np.float32(val), pred_features=np.asarray(feats))
    return data


def test_sorted_grads_match_jax_fixture():
    """The sorted brute-force trace's backward (on the CPU: the float64
    plain version of kernel C through the windows of 128 over the shared
    segment, then the fold) against JAX's sorted vjp: 2e-3 max-normalised,
    cosine >= 0.9999."""
    state, (ro, rd) = _fixture_scene()
    model = model_from_state(state)
    out = trace(model, torch.tensor(ro), torch.tensor(rd), sh_degree=1,
                accelerate=False)
    loss = _fixture_loss(out, torch.mean)
    loss.backward()
    with np.load(FIXTURE) as f:
        np.testing.assert_array_equal(f["ray_o"], ro)
        np.testing.assert_allclose(np32(out["pred_features"]),
                                   f["pred_features"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(float(loss.detach()), float(f["loss"]),
                                   rtol=1e-5)
        for k in NAMES:
            g = getattr(model, k).grad.double().numpy()
            r = f[f"grad/{k}"].astype(np.float64)
            scale = np.abs(r).max() + 1e-12
            np.testing.assert_allclose(g / scale, r / scale, atol=2e-3,
                                       rtol=0, err_msg=k)
            assert (g * r).sum() / max(np.linalg.norm(g) * np.linalg.norm(r),
                                       1e-300) >= 0.9999, k


if __name__ == "__main__":
    # regenerate the fixture: PYTHONPATH=. python tests/test_torch_trace.py
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (JAX on the CPU, highest precision)
    np.savez_compressed(FIXTURE, **make_grad_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
