"""3DGRT and sorted 3DGUT in the PyTorch port against the JAX package.

CPU. The sorted compositing mode (per-ray windows of W candidates,
aligned on the global pair index and cut to each tile, each window in
its own hit-distance order) in its two configurations: 3DGRT
(``render_grt``: degree 4, min_transmittance 1e-3, W = 16) and the
paper's sorted 3DGUT (degree 2, min_transmittance 1e-4, W = 16). The JAX
kernels run in Pallas
interpret mode with the exact kill. Tolerances, with reasons:
  * the small scene (n = 96, 48x32, make_test_scene's defaults), JAX as
    shipped: features and opacity within 1e-4, depth 1e-3, hit counts
    flipping on < 1% of pixels (tests/test_torch_render.py: the JAX
    kernel's split-bf16 matmuls, ~5e-5);
  * a dense scene (96 particles in a 0.5-deep slab) where the order
    matters (sorted and global-Z renders differ by ~0.4): JAX's
    split-bf16 hit distances (~2e-5 absolute error at depth 3) swap
    candidates closer than that, so there JAX runs its exact-f32 dot
    mode (``ops/pallas/mxu.py`` ``THREEDGRUT_MXU_F32MODE=fp32``, set
    through the module's flag): features and opacity within 2e-6, depth
    1e-5, and the telemetry within 1e-6;
  * gradients against ``tests/fixtures/torch_port_grt_grad_small.npz``
    (JAX, exact-f32 dots, the dense scene): max-normalised 2e-3 and
    cosine >= 0.9999, as the unsorted slice's.

Also: kernels B, C and E as their CUDA sources walk the pairs (one tile
at a time, fp32, a sequential loop over the sorted windows, the hand
pullback of raster_bwd.cu) against the plain versions; the YAML
mapping of ``train_torch.py``, the Trainer with weight pruning and the
CLI with both configurations. Weight pruning against JAX:
tests/test_torch_strategy.py. The kernels themselves:
tests/test_torch_gpu.py.
"""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from threedgrut_tpu.config.loader import load_config, to_trainer_config
from threedgrut_tpu.ops.pallas import mxu as j_mxu
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu.render.grt import render_grt as j_render_grt
from threedgrut_tpu.render.gut import render_gut as j_render_gut
from threedgrut_tpu_torch.convert import model_from_state
from threedgrut_tpu_torch.models.background import BackgroundConfig
from threedgrut_tpu_torch.ops.cuda import raster as t_raster
from threedgrut_tpu_torch.ops.cuda.raster import (
    rasterize_tiles, rasterize_tiles_backward, rasterize_tiles_backward_plain,
    rasterize_tiles_plain)
from threedgrut_tpu_torch.ops.cuda.wmax import (pair_weight_max,
                                                pair_weight_max_plain)
from threedgrut_tpu_torch.ops.hit import particle_response
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.render.common import RasterConfig, camera_rays_world
from threedgrut_tpu_torch.render.grt import grt_raster_config, render_grt
from threedgrut_tpu_torch.render.gut import prepare_view, render_gut
from threedgrut_tpu_torch.render.serve import make_serving_renderer
from threedgrut_tpu_torch.train import trainer as t_tr
from torch_port_utils import np32, torch_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures",
                       "torch_port_grt_grad_small.npz")
RES = (48, 32)
# the sorted configurations as train_torch.py composes them (held to the
# YAML by test_trainer_config_matches_jax_loader): 3DGRT
# (apps/nerf_synthetic_3dgrt) and the paper's sorted 3DGUT
# (paper/3dgut/sorted_nerf_synthetic, which takes render/3dgrt.yaml's
# sort_window 16)
CONFIG_NAMES = {"grt": "apps/nerf_synthetic_3dgrt",
                "sorted3dgut": "paper/3dgut/sorted_nerf_synthetic"}
MODES = {
    "grt": dict(kernel_degree=4, min_transmittance=1e-3,
                sorted_compositing=True, sort_window=16),
    "sorted3dgut": dict(kernel_degree=2, min_transmittance=1e-4,
                        sorted_compositing=True, sort_window=16),
}
WALK_MODES = dict(MODES, unsorted=dict(kernel_degree=2),
                  unsorted4=dict(kernel_degree=4, min_transmittance=1e-3))
NAMES = ("positions", "rotation", "scale", "density", "features_albedo",
         "features_specular")
KEYS = ("pred_features", "pred_opacity", "pred_dist", "hits_count")
GRAD_SH = 1


def j_rc(mode, **kw):
    return JRasterConfig(max_pairs=1 << 13, exact_kill=True, grad_fold=False,
                         **MODES.get(mode, WALK_MODES.get(mode)), **kw)


def dense_scene():
    """96 particles in a 0.5-deep slab: many overlaps whose hit-distance
    order differs from the centers' depth order."""
    return make_test_scene(n=96, seed=0, res=RES, z_range=(3.0, 3.5),
                           scale_range=(0.15, 0.45), spread=0.8)


@contextlib.contextmanager
def jax_exact_dots():
    """JAX's kernels with full-f32 dots (mxu.py's fp32 mode)."""
    old = j_mxu._FP32_MODE
    j_mxu._FP32_MODE = True
    try:
        yield
    finally:
        j_mxu._FP32_MODE = old


def _np(out):
    return {k: np32(out[k]) for k in KEYS}


def assert_render_close(got, ref, atol, atol_depth, max_flips):
    for k in ("pred_features", "pred_opacity"):
        np.testing.assert_allclose(got[k], ref[k], atol=atol, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(got["pred_dist"], ref["pred_dist"],
                               atol=atol_depth, rtol=0)
    assert (got["hits_count"] != ref["hits_count"]).mean() <= max_flips


def port_render(tcam, model, mode, sh=3):
    if mode == "grt":     # render_grt applies the 3DGRT settings itself
        return render_grt(tcam, UTConfig(), RasterConfig(), model, sh)
    return render_gut(tcam, UTConfig(), RasterConfig(**MODES[mode]), model,
                      sh)


def jax_render(cam, state, mode, sh=3, **kw):
    if mode == "grt":
        rc = JRasterConfig(max_pairs=1 << 13, exact_kill=True,
                           grad_fold=False)
        return j_render_grt(cam, JUTConfig(), rc, state, sh, interpret=True)
    return j_render_gut(cam, JUTConfig(), j_rc(mode), state, sh,
                        interpret=True, **kw)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_render_matches_jax(mode, seed):
    cam, state = make_test_scene(n=96, seed=seed, res=RES)
    tcam, model = torch_scene(cam, state)
    ref = _np(jax_render(cam, state, mode))
    launches = rasterize_tiles.launches
    with torch.no_grad():
        got = _np(port_render(tcam, model, mode))
    assert rasterize_tiles.launches == launches   # CPU: the plain version
    assert_render_close(got, ref, 1e-4, 1e-3, 0.01)
    assert got["pred_opacity"].mean() > 0.2


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dense_sorted_render_matches_exact_jax(mode):
    cam, state = dense_scene()
    tcam, model = torch_scene(cam, state)
    with jax_exact_dots():
        ref = _np(jax_render(cam, state, mode))
    with torch.no_grad():
        got = _np(port_render(tcam, model, mode))
        unsorted = render_gut(tcam, UTConfig(), RasterConfig(
            kernel_degree=MODES[mode]["kernel_degree"],
            min_transmittance=MODES[mode]["min_transmittance"]), model, 3)
    assert_render_close(got, ref, 2e-6, 1e-5, 0.0)
    # the windows' order matters on this scene
    assert np.abs(np32(unsorted["pred_features"])
                  - got["pred_features"]).max() > 0.1


@pytest.mark.parametrize("mode", ["unsorted", "grt", "sorted3dgut"])
def test_weight_telemetry_matches_jax(mode):
    """Kernel E's plain version and the per-particle max against JAX
    render_gut(weight_telemetry=True), exact-f32 dots, dense scene."""
    cam, state = dense_scene()
    tcam, model = torch_scene(cam, state)
    with jax_exact_dots():
        ref = np.asarray(j_render_gut(cam, JUTConfig(), j_rc(mode), state, 3,
                                      interpret=True,
                                      weight_telemetry=True)["particle_wmax"])
    launches = pair_weight_max.launches
    got = render_gut(tcam, UTConfig(), RasterConfig(**WALK_MODES[mode]),
                     model, 3, weight_telemetry=True)["particle_wmax"]
    assert pair_weight_max.launches == launches
    assert got.shape == (model.capacity,) and not got.requires_grad
    np.testing.assert_allclose(np32(got), ref, atol=1e-6, rtol=0)
    assert (ref > 0.05).sum() > 20


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _loss(feat, opacity, dist, mean):
    """tests/test_render_parity.py:49-61 with a zero target."""
    return mean(feat ** 2) + 0.1 * mean(opacity) + 0.01 * mean(dist)


def jax_grads(cam, state, mode):
    """(loss, {leaf: grad}) of JAX render_gut, sorted config ``mode``,
    exact-f32 dots, the wide interval fold."""
    rc = JRasterConfig(max_pairs=1 << 13, exact_kill=True, grad_fold=True,
                       fold_wide=True, **MODES[mode])

    def loss(params):
        out = j_render_gut(cam, JUTConfig(), rc, state.replace(params=params),
                           GRAD_SH, interpret=True)
        return _loss(out["pred_features"], out["pred_opacity"],
                     out["pred_dist"], jnp.mean)

    with jax_exact_dots():
        val, g = jax.value_and_grad(loss)(state.params)
    return float(val), {k: np.asarray(getattr(g, k)) for k in NAMES}


def make_grad_fixture():
    cam, state = dense_scene()
    data = {f"params/{k}": np.asarray(getattr(state.params, k))
            for k in NAMES}
    data.update(
        n_active=np.int32(state.n_active),
        n_active_features=np.int32(state.n_active_features),
        density_activation=state.config.density_activation,
        scale_activation=state.config.scale_activation,
        resolution=np.asarray(cam.resolution, np.int32),
        focal=np.asarray(cam.focal), principal=np.asarray(cam.principal),
        t=np.asarray(cam.t_start), q=np.asarray(cam.q_start),
        sh_degree=np.int32(GRAD_SH))
    for mode in sorted(MODES):
        loss, grads = jax_grads(cam, state, mode)
        data[f"{mode}/loss"] = np.float32(loss)
        data.update({f"{mode}/grad/{k}": np.asarray(v, np.float32)
                     for k, v in grads.items()})
        for k, v in MODES[mode].items():
            data[f"{mode}/raster/{k}"] = np.asarray(v)
    return data


@pytest.mark.parametrize("mode", sorted(MODES))
def test_grads_match_jax_fixture(mode):
    """render_gut's backward (on the CPU: the float64 autograd plain
    version of kernel C through the sorted windows, then the plain fold)
    against the JAX gradients of the fixture."""
    cam, state = dense_scene()
    tcam, model = torch_scene(cam, state)
    out = port_render(tcam, model, mode, sh=GRAD_SH)
    loss = _loss(out["pred_features"], out["pred_opacity"],
                 out["pred_dist"], torch.mean)
    loss.backward()
    with np.load(FIXTURE) as f:
        np.testing.assert_allclose(float(loss.detach()),
                                   float(f[f"{mode}/loss"]),
                                   rtol=1e-5)
        for k in NAMES:
            a = getattr(model, k).grad.double().numpy()
            b = f[f"{mode}/grad/{k}"].astype(np.float64)
            scale = np.abs(b).max() + 1e-12
            np.testing.assert_allclose(a / scale, b / scale, atol=2e-3,
                                       rtol=0, err_msg=k)
            cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
            assert cos >= 0.9999, (k, cos)


@pytest.mark.slow
def test_grt_grad_fixture_is_current():
    """The saved JAX gradients agree with a fresh JAX run within 1e-6, so
    the fixture chip_smoke.py reads cannot drift (slow: the JAX sorted
    backward in interpret mode, twice)."""
    fresh = make_grad_fixture()
    with np.load(FIXTURE) as saved:
        assert set(saved.files) == set(fresh)
        for k, v in fresh.items():
            if saved[k].dtype.kind in "fi":
                scale = max(1.0, float(np.abs(v).max()))
                np.testing.assert_allclose(saved[k], v, atol=1e-6 * scale,
                                           rtol=0, err_msg=k)
            else:
                assert str(saved[k]) == str(v), k
    assert os.path.getsize(FIXTURE) < 200_000


# ---------------------------------------------------------------------------
# the kernels' walk, emulated
# ---------------------------------------------------------------------------

def _walk_tile(rec, start, rd, tmin, tmax, cfg, up=None, ro=None):
    """Kernels B, E and C on one tile as the CUDA sources compute them:
    fp32; the lanes [start, start + L) in windows of W aligned on the
    global pair index, each pixel's accepted candidates of a window in
    stable hit_t order; T, the kill and (with ``up`` = (g_feat, g_t, gd,
    phi_total, t_final), per pixel) the suffix cotangents along that
    walk; then raster_bwd.cu's pullback per (pair, pixel), summed over
    the pixels. With per-pixel origins ``ro`` [256, 3], the general mode
    (common.cuh:eval_hit_general): a = M (o - p), hit_t times |d|, and
    the pullback on to p and M. Returns (rgb [256, 3], depth, hits,
    T [256], w [L, 256], d_rec [L, 16] or None)."""
    s, thr_resp, log_min_alpha = t_raster._thresholds(cfg)
    n = rec.shape[0]
    window = cfg.sort_window if cfg.sorted_compositing else 1
    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]
    col = [rec[:, i:i + 1] for i in range(16)]
    bx = col[3] * dx + col[4] * dy + col[5] * dz
    by = col[6] * dx + col[7] * dy + col[8] * dz
    bz = col[9] * dx + col[10] * dy + col[11] * dz
    if ro is None:
        ax, ay, az = col[0], col[1], col[2]
    else:
        ex, ey, ez = ro[:, 0] - col[0], ro[:, 1] - col[1], ro[:, 2] - col[2]
        ax = col[3] * ex + col[4] * ey + col[5] * ez
        ay = col[6] * ex + col[7] * ey + col[8] * ez
        az = col[9] * ex + col[10] * ey + col[11] * ez
        dn = torch.sqrt(dx * dx + dy * dy + dz * dz)
    cx, cy, cz = ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx
    inv_m = 1.0 / torch.clamp(bx * bx + by * by + bz * bz, min=1e-30)
    c2 = cx * cx + cy * cy + cz * cz
    sq = c2 * inv_m
    q = ax * bx + ay * by + az * bz
    hit_t = -q * inv_m
    if ro is not None:
        hit_t = hit_t * dn
    t = torch.clamp((log_min_alpha - torch.log(torch.clamp(col[12],
                                                           min=1e-30))) / s,
                    max=thr_resp)
    if cfg.kernel_degree == 4:
        t = torch.sqrt(torch.clamp(t, min=0.0))
    keep = (sq < t) & (hit_t > tmin) & (hit_t < tmax)
    resp = particle_response(sq, cfg.kernel_degree)
    alpha_raw = resp * col[12]
    alpha = torch.clamp(alpha_raw, max=cfg.max_alpha)

    first = start - start % window
    order = []
    for w0 in range(first, start + n, window):
        lanes = torch.arange(max(w0, start), min(w0 + window, start + n)
                             ) - start
        key = torch.where(keep[lanes], hit_t[lanes],
                          torch.full_like(hit_t[lanes], float("inf")))
        order.append(lanes[torch.sort(key, dim=0, stable=True).indices])
    order = torch.cat(order)                       # [L, 256] lane per step
    px = torch.arange(rd.shape[0])
    rgb = rec[:, 13:16]
    trans = torch.ones(rd.shape[0])
    alive = torch.ones(rd.shape[0], dtype=torch.bool)
    feat = torch.zeros(rd.shape[0], 3)
    depth = torch.zeros(rd.shape[0])
    hits = torch.zeros(rd.shape[0])
    w_all = torch.zeros(n, rd.shape[0])
    g_alpha = torch.zeros(n, rd.shape[0])
    psi = torch.zeros(rd.shape[0])
    for k in range(n):
        j = order[k]
        ok = keep[j, px] & alive
        a = alpha[j, px]
        w = torch.where(ok, a * trans, torch.zeros_like(a))
        feat += w[:, None] * rgb[j]
        depth += w * hit_t[j, px]
        hits += (w > 0).float()
        w_all[j, px] = w
        if up is not None:
            gf, g_t, gd, phi_total, t_final = up
            u = (gf[:, 0] * rgb[j, 0] + gf[:, 1] * rgb[j, 1]
                 + gf[:, 2] * rgb[j, 2] + gd * hit_t[j, px])
            psi = torch.where(ok, psi + w * u, psi)
            ga = trans * u - ((phi_total - psi) + g_t * t_final) / \
                torch.clamp(1.0 - a, min=1e-6)
            g_alpha[j, px] = torch.where(w > 0, ga, torch.zeros_like(ga))
        trans = torch.where(ok, trans * (1.0 - a), trans)
        alive = alive & ~(ok & (trans < cfg.min_transmittance))
    if up is None:
        return feat, depth, hits, trans, w_all, None

    gf, g_t, gd, _, _ = up
    touched = w_all > 0
    g_ht = gd * w_all if ro is None else gd * w_all * dn
    g_eff = torch.where(alpha_raw < cfg.max_alpha, g_alpha,
                        torch.zeros_like(g_alpha))
    if cfg.kernel_degree == 4:
        dsq = resp * s * 2.0 * sq
    else:
        dsq = resp * s
    d_sq = (g_eff * col[12]) * dsq
    d_q = -g_ht * inv_m
    d_inv_m = d_sq * c2 - g_ht * q
    d_c2 = d_sq * inv_m
    d_m = -d_inv_m * inv_m * inv_m
    gcx, gcy, gcz = 2.0 * d_c2 * cx, 2.0 * d_c2 * cy, 2.0 * d_c2 * cz
    dbx = gcy * az - gcz * ay + d_q * ax + 2.0 * d_m * bx
    dby = gcz * ax - gcx * az + d_q * ay + 2.0 * d_m * by
    dbz = gcx * ay - gcy * ax + d_q * az + 2.0 * d_m * bz
    dax = by * gcz - bz * gcy + d_q * bx
    day = bz * gcx - bx * gcz + d_q * by
    daz = bx * gcy - by * gcx + d_q * bz
    if ro is None:
        geo = [dax, day, daz, dbx * dx, dbx * dy, dbx * dz, dby * dx,
               dby * dy, dby * dz, dbz * dx, dbz * dy, dbz * dz]
    else:   # a = M e, e = o - p: d_p = -M^T d_a, d_M += d_a e^T
        geo = [-(col[3] * dax + col[6] * day + col[9] * daz),
               -(col[4] * dax + col[7] * day + col[10] * daz),
               -(col[5] * dax + col[8] * day + col[11] * daz)]
        geo += [da * e + db * dk for da, db in ((dax, dbx), (day, dby),
                                                (daz, dbz))
                for e, dk in ((ex, dx), (ey, dy), (ez, dz))]
    d = torch.stack(geo + [g_eff * resp, gf[:, 0] * w_all,
                           gf[:, 1] * w_all, gf[:, 2] * w_all], dim=-1)
    d = torch.where(touched[..., None], d, torch.zeros_like(d))
    return feat, depth, hits, trans, w_all, d.sum(dim=1)


def walk_reference(v, cfg, upstream):
    """``_walk_tile`` over every tile of a prepared view: (forward
    (features, opacity, depth, hits, T_final) images, d_records [P, 16],
    wpair [P])."""
    b = v.binning
    rays = t_raster._tilize_rays(v.ray_d, v.tmin, v.tmax, v.ray_o)
    gx, gy = rays.gx, rays.gy
    h, w = v.ray_d.shape[:2]
    ts = b.tile_start.tolist()
    out = torch.zeros(gx * gy, 256, 6)
    out[..., 5] = 1.0
    d_rec = torch.zeros(b.pair_particle.shape[0], 16)
    wpair = torch.zeros(b.pair_particle.shape[0])
    g_feat, g_opac, g_dep = upstream
    tiles = []
    for t in range(gx * gy):
        s0, s1 = ts[t], ts[t + 1]
        if s1 == s0:
            continue
        rec = v.table[b.pair_particle[s0:s1].long()]
        ro = None if rays.ro is None else rays.ro[t]
        f, dep, hits, tr, w_all, _ = _walk_tile(rec, s0, rays.rd[t],
                                                rays.tmin[t], rays.tmax[t],
                                                cfg, ro=ro)
        out[t, :, 0:3], out[t, :, 3], out[t, :, 4] = f, dep, hits
        out[t, :, 5] = tr
        wpair[s0:s1] = w_all.amax(dim=1)
        tiles.append((t, s0, s1, rec))
    img = t_raster._untile(out, gx, gy, h, w)
    gf = t_raster._tilize(g_feat, gx, gy, 0.0)
    g_t = -t_raster._tilize(g_opac, gx, gy, 0.0)[..., 0]
    gd = t_raster._tilize(g_dep, gx, gy, 0.0)[..., 0]
    for t, s0, s1, rec in tiles:
        phi = (gf[t, :, 0] * out[t, :, 0] + gf[t, :, 1] * out[t, :, 1]
               + gf[t, :, 2] * out[t, :, 2] + gd[t] * out[t, :, 3])
        *_, dr = _walk_tile(rec, s0, rays.rd[t], rays.tmin[t], rays.tmax[t],
                            cfg, (gf[t], g_t[t], gd[t], phi, out[t, :, 5]),
                            None if rays.ro is None else rays.ro[t])
        d_rec[s0:s1] = dr
    fwd = (img[..., 0:3], 1.0 - img[..., 5:6], img[..., 3:4], img[..., 4:5],
           img[..., 5:6])
    return fwd, d_rec, wpair


def _upstream(v, seed=0):
    rng = np.random.default_rng(seed)
    h, w = v.ray_d.shape[:2]
    return [torch.tensor(rng.normal(size=(h, w, c)).astype(np.float32))
            for c in (3, 1, 1)]


def assert_grads_agree(got, ref, cos_min, rel_max):
    """Cosine and relative L2 per record field group (a, M, density,
    rgb), as chip_smoke.py holds kernel C."""
    for sl in (slice(0, 3), slice(3, 12), slice(12, 13), slice(13, 16)):
        x, y = got[:, sl].double().flatten(), ref[:, sl].double().flatten()
        assert float(x @ y / (x.norm() * y.norm())) >= cos_min, sl
        assert float((x - y).norm() / y.norm()) <= rel_max, sl


@pytest.mark.parametrize("mode", sorted(WALK_MODES))
def test_kernel_walk_matches_plain(mode):
    """The kernels' sequential fp32 walk (emulated: the windows, the
    insertion order, the lane map of g_alpha and w, the degree-4
    pullback) against the plain versions, whose float64 autograd
    backward derives the gradients independently. A sort window that
    straddles a tile boundary occurs in both sorted modes here."""
    cam, state = dense_scene()
    tcam, model = torch_scene(cam, state)
    cfg = RasterConfig(**WALK_MODES[mode])
    with torch.no_grad():
        v = prepare_view(tcam, UTConfig(), cfg, model, 3)
    b = v.binning
    if cfg.sorted_compositing:
        starts = b.tile_start.tolist()
        assert any(s % cfg.sort_window and e > s
                   for s, e in zip(starts, starts[1:]))
    up = _upstream(v)
    fwd, d_walk, w_walk = walk_reference(v, cfg, up)
    args = (v.table, b.pair_particle, b.tile_start, v.ray_d, v.tmin, v.tmax)
    ref = rasterize_tiles_plain(*args, cfg)
    for got, r in zip(fwd, ref):
        np.testing.assert_allclose(np32(got), np32(r), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np32(w_walk),
                               np32(pair_weight_max_plain(*args, cfg)),
                               atol=1e-6, rtol=0)
    d_ref = rasterize_tiles_backward_plain(*args, ref[0], ref[2], ref[4],
                                           *up, cfg)
    assert_grads_agree(d_walk, d_ref, 0.99999, 1e-4)
    # the wrapper takes the plain versions on the CPU, without a launch
    launches = rasterize_tiles_backward.launches
    d_wrap = rasterize_tiles_backward(*args, ref[0], ref[2], ref[4], *up,
                                      cfg)
    assert rasterize_tiles_backward.launches == launches
    torch.testing.assert_close(d_wrap, d_ref, atol=0, rtol=0)


def test_configs_and_wrappers_refuse_what_is_not_built():
    rc = grt_raster_config()
    assert (rc.kernel_degree, rc.min_transmittance, rc.sorted_compositing,
            rc.sort_window) == (4, 1e-3, True, 16)
    with pytest.raises(ValueError, match="power of two"):
        RasterConfig(sort_window=24)
    with pytest.raises(ValueError, match="power of two"):
        RasterConfig(sort_window=256)
    cam, state = make_test_scene(n=32, seed=3, res=(32, 32))
    tcam, model = torch_scene(cam, state)
    for bad in (RasterConfig(sorted_compositing=True, sort_window=32),
                RasterConfig(sorted_compositing=True, sort_window=64),
                RasterConfig(kernel_degree=3)):
        with pytest.raises(NotImplementedError):
            render_gut(tcam, UTConfig(), bad, model, 3)
    # a window the kernels lack is fine while compositing is unsorted
    with torch.no_grad():
        render_gut(tcam, UTConfig(), RasterConfig(sort_window=32), model, 3)
    # kernel E lacks trace()'s windows of 128, which B and C take
    w128 = RasterConfig(kernel_degree=4, sorted_compositing=True,
                        sort_window=128)
    with torch.no_grad():
        v = prepare_view(tcam, UTConfig(), w128, model, 3,
                         camera_rays_world(tcam))
        args = (v.table, v.binning.pair_particle, v.binning.tile_start,
                v.ray_d, v.tmin, v.tmax, w128, v.ray_o)
        assert t_raster.rasterize_tiles_forward(*args)[0].shape[-1] == 3
        with pytest.raises(NotImplementedError, match="kernel E"):
            pair_weight_max(*args)


def test_serving_renderer_serves_grt():
    cam, state = make_test_scene(n=96, seed=4, res=RES)
    tcam, model = torch_scene(cam, state)
    bg = torch.tensor([1.0, 0.5, 0.25])
    serve = make_serving_renderer(model, grt_raster_config(), 3,
                                  background=bg)
    imgs = serve([tcam, tcam])
    with torch.no_grad():
        out = render_grt(tcam, UTConfig(), RasterConfig(), model, 3)
    ref = out["pred_features"] + (1.0 - out["pred_opacity"]) * bg
    assert imgs.shape == (2, RES[1], RES[0], 3)
    torch.testing.assert_close(imgs[1], ref, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the YAML mapping, the trainer with weight pruning, and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(CONFIG_NAMES))
def test_trainer_config_matches_jax_loader(mode, capsys):
    """train_torch.trainer_config against config/loader.py's mapping:
    the render fields of both sorted configurations and the weight-prune
    fields. The JAX loader reads prune_weight.threshold where
    configs/strategy/gs.yaml says weight_threshold (ROADMAP section 3),
    so the threshold is set under both names here."""
    sys.path.insert(0, REPO)
    import train_torch

    name = CONFIG_NAMES[mode]
    overrides = ["path=/none", "strategy.prune_weight.weight_threshold=0.25",
                 "strategy.prune_weight.threshold=0.25",
                 "strategy.prune_weight.telemetry_frequency=7"]
    conf = load_config(name, overrides=overrides)
    j = to_trainer_config(conf)
    t = train_torch.trainer_config(conf)
    for k in ("kernel_degree", "min_transmittance", "sorted_compositing",
              "sort_window", "min_response", "min_alpha", "max_alpha"):
        assert getattr(t.raster, k) == getattr(j.raster, k), k
    for k in ("prune_weight_frequency", "prune_weight_start",
              "prune_weight_end", "prune_weight_threshold",
              "weight_telemetry_frequency"):
        assert getattr(t.gs, k) == getattr(j.gs, k), k
    # render/3dgut.yaml composes render/3dgrt.yaml first, so both carry
    # its sort_window 16; the loader's default 64 is never reached
    assert t.raster.sorted_compositing and t.raster.sort_window == 16
    # the settings every sorted test here, the gradient fixture and
    # chip_smoke.py use
    assert {k: getattr(t.raster, k) for k in MODES[mode]} == MODES[mode]
    # the YAML's relaxed kill, which the JAX loader passes on, is named
    # where the port composes the exact kill instead
    assert j.raster.exact_kill is False
    assert "exact_kill is false" in capsys.readouterr().err
    # without the override the port takes the YAML's weight_threshold
    t0 = train_torch.trainer_config(load_config(name, overrides=["path=/n"]))
    assert t0.gs.prune_weight_threshold == 0.5


@pytest.mark.parametrize("knobs", [("aligned_segments",),
                                   ("aligned_segments", "flat_grid")])
def test_trainer_config_names_tpu_layouts(knobs, capsys):
    """render.aligned_segments (which config/loader.py maps) and flat_grid
    lay out the same image for the TPU: trainer_config names them on
    stderr, in one line, and composes the render it composes without
    them."""
    sys.path.insert(0, REPO)
    import train_torch

    name = CONFIG_NAMES["grt"]
    base = train_torch.trainer_config(load_config(name,
                                                  overrides=["path=/n"]))
    capsys.readouterr()
    conf = load_config(name, overrides=["path=/n"] + [
        f"render.{k}=true" for k in knobs])
    assert to_trainer_config(conf).raster.aligned_segments is True
    t = train_torch.trainer_config(conf)
    assert t.raster == base.raster
    err = [line for line in capsys.readouterr().err.splitlines()
           if "TPU layouts" in line]
    assert len(err) == 1
    assert all(f"render.{k}" in err[0] for k in knobs)


def test_grt_trainer_prunes_by_weight():
    """A few Trainer steps with the 3DGRT settings and weight pruning on:
    telemetry every step, a prune at step 4 that drops exactly the
    particles parked out of every view, and the buffer reset after it."""
    import test_torch_trainer as tt

    views = tt.Views(n_views=2)
    state = tt._init_state()
    pos = np.asarray(state.params.positions).copy()
    pos[80:96, 0] += 1e3      # out of every view: blend weight 0
    state = state.replace(params=state.params.replace(
        positions=jnp.asarray(pos)))
    conf = t_tr.TrainerConfig(raster=grt_raster_config(),
                              background=BackgroundConfig(color="white"))
    conf.gs = conf.gs.replace(
        densify_frequency=0, prune_frequency=0, reset_density_frequency=0,
        prune_weight_frequency=4, prune_weight_start=1,
        prune_weight_end=100, weight_telemetry_frequency=1,
        prune_weight_threshold=1e-6)
    trainer = t_tr.Trainer(conf, views, model_from_state(state))
    launches = pair_weight_max.launches
    hist = trainer.run_training(5)
    assert pair_weight_max.launches == launches     # CPU: plain version
    events = [(s, k, st) for s, k, st in trainer.event_stats
              if k == "weight-pruned"]
    assert [s for s, _, _ in events] == [4]
    assert events[0][2]["n_pruned"] == 16 and trainer.model.n_active == 80
    # step 5 sampled one view since the reset
    assert float(trainer.gs_weight_buf[80:].abs().max()) == 0.0
    assert float(trainer.gs_weight_buf.max()) > 0.0
    assert all(np.isfinite(h["total"]) for h in hist)


@pytest.mark.parametrize("name", sorted(CONFIG_NAMES.values()))
def test_train_cli_runs_sorted_configs(tmp_path, name):
    import test_torch_trainer as tt

    data = str(tmp_path / "lego_mini")
    tt._write_nerf_dataset(data)
    out = str(tmp_path / "out")
    res = subprocess.run(
        [sys.executable, "train_torch.py", "--config-name", name,
         "--device", "cpu", f"path={data}", "n_iterations=4",
         "initialization.num_gaussians=300", f"out_dir={out}",
         "experiment_name=cli", "log_frequency=0.04"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "step 4:" in res.stdout
    with np.load(os.path.join(out, "cli", "ckpt_last.npz")) as f:
        assert int(f["global_step"]) == 4


if __name__ == "__main__":
    # regenerate the fixture: PYTHONPATH=. python tests/test_torch_grt.py
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (JAX on the CPU, highest precision)
    np.savez_compressed(FIXTURE, **make_grad_fixture())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
