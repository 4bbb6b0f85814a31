"""The table-gradient raster route of the PyTorch port and its row-scatter
kernel (F) against the JAX package.

CPU, plain versions against the JAX functions in Pallas interpret mode:
  * ``scatter_accumulate_rows_plain`` (a float64 ``index_add``) against
    JAX ``scatter_accumulate_rows`` on 4 chunks of 128 pairs, 16 and 11
    wide: within 1e-6 of max. JAX's kernel adds the rows in pair order in
    fp32; a sequential fp32 ``np.add.at`` in pair order equals it bit for
    bit, and tests/test_torch_gpu.py holds kernel F to that same
    reference on the card, bit for bit;
  * ``rasterize_tiles_table``'s table gradient against JAX
    ``rasterize_tiles_table``'s vjp (raster kernels and scatter in
    interpret mode) on the same table, pairs and rays: max-normalised
    2e-3 and cosine >= 0.9999 (tests/test_torch_train_render.py's
    tolerances: the JAX kernels emulate fp32 products with split-bf16
    matmuls), and the image within 1e-4 (tests/test_torch_render.py's);
  * the table route against the port's own D route (``rasterize_tiles``
    with the binning's FoldMeta) in the 3DGUT, 3DGRT and general modes:
    within 1e-6 of max (both sum the same float32 rows in float64, in
    another order);
  * the refusals: NHT records and rows wider than 16;
  * kernel F's set-up and run sum in their plain versions
    (``id_runs_plain``, a stable sort, then ``scatter_runs_plain``) on
    adversarial ids (one id owning 5,000 pairs, all ids distinct, ids out
    of range, no pairs): bit for bit a sequential fp32 ``np.add.at``, and
    within 1e-6 of max of JAX's scatter in interpret mode;
  * the NHT sine and cosine of kernels B and C in its plain version
    (``nht_sincos_plain``: the Cody-Waite step emulated in float32, the
    SFU's sine as float64) within 1.5e-7 of float64 over the fast path's
    range (common.cuh:sincos_fast states it; the card's own, with the
    SFU, is held to 1e-6 by tests/test_torch_gpu.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from threedgrut_tpu.ops.pallas.raster import RasterKernelConfig
from threedgrut_tpu.ops.pallas.raster import \
    rasterize_tiles_table as j_rasterize_tiles_table
from threedgrut_tpu.ops.pallas.scatter import \
    scatter_accumulate_rows as j_scatter_accumulate_rows
from threedgrut_tpu.render.gut import pack_rays, unpack_tiles
from threedgrut_tpu_torch.ops.cuda.raster import (NHT_TRIG_FAST_MAX, FoldMeta,
                                                  nht_sincos,
                                                  rasterize_tiles,
                                                  rasterize_tiles_table)
from threedgrut_tpu_torch.ops.cuda.scatter import (
    id_runs, id_runs_plain, scatter_accumulate_rows,
    scatter_accumulate_rows_plain, scatter_runs, scatter_runs_plain)
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.render.common import RasterConfig, camera_rays_world
from threedgrut_tpu_torch.render.grt import grt_raster_config
from threedgrut_tpu_torch.render.gut import prepare_view
from torch_port_utils import (ADVERSARIAL_IDS, adversarial_ids, np32,
                              torch_scene)

CHUNK = 128
RES = (64, 48)
RC = RasterConfig()
MODES = {"3dgut": (RC, False), "3dgrt": (grt_raster_config(), False),
         "general": (RC, True)}


def sequential_rows(rows, ids, n_rows):
    """The sequential fp32 sum in pair order (JAX's loop, kernel F's)."""
    out = np.zeros((n_rows, rows.shape[1]), np.float32)
    np.add.at(out, ids, rows)
    return out


@pytest.mark.parametrize("width", [16, 11])
def test_plain_scatter_matches_jax(width):
    rng = np.random.default_rng(width)
    n_chunks, n_rows = 4, 64
    d_chunks = rng.normal(size=(n_chunks, width, CHUNK)).astype(np.float32)
    ids = rng.integers(0, n_rows, (n_chunks, CHUNK)).astype(np.int32)
    ref = np.asarray(j_scatter_accumulate_rows(
        jnp.asarray(d_chunks), jnp.asarray(ids), n_rows, interpret=True))
    rows = d_chunks.transpose(0, 2, 1).reshape(-1, width)
    np.testing.assert_array_equal(
        ref, sequential_rows(rows, ids.reshape(-1), n_rows))
    before = scatter_runs.launches
    got = scatter_accumulate_rows(torch.from_numpy(rows),
                                  torch.from_numpy(ids.reshape(-1)), n_rows)
    assert scatter_runs.launches == before   # CPU: plain
    assert got.shape == (n_rows, width)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-6 * np.abs(ref).max(), rtol=0)


def test_plain_scatter_drops_out_of_range_ids():
    rows = torch.ones((4, 3))
    ids = torch.tensor([0, 5, -1, 2], dtype=torch.int32)
    got = scatter_accumulate_rows_plain(rows, ids, 3)
    np.testing.assert_array_equal(got.numpy(), [[1] * 3, [0] * 3, [1] * 3])


@pytest.mark.parametrize("case", ADVERSARIAL_IDS)
def test_plain_set_up_and_run_sum_match_sequential_and_jax(case):
    """id_runs_plain then scatter_runs_plain: bit for bit the sequential
    fp32 sum in pair order, and within 1e-6 of max of JAX's scatter (its
    dropped pairs given zero rows and id 0, which JAX allows)."""
    ids, n_rows = adversarial_ids(case)
    rows = np.random.default_rng(3).normal(
        size=(ids.shape[0], 16)).astype(np.float32)
    keep = (ids >= 0) & (ids < n_rows)
    tids = torch.from_numpy(ids)
    perm, row_start = id_runs(tids, n_rows)     # CPU: the plain version
    plain = id_runs_plain(tids, n_rows)
    assert torch.equal(perm, plain[0]) and torch.equal(row_start, plain[1])
    got = scatter_runs_plain(torch.from_numpy(rows), perm, row_start)
    seq = sequential_rows(rows[keep], ids[keep], n_rows)
    np.testing.assert_array_equal(got.numpy(), seq)
    if ids.shape[0] == 0:
        assert not seq.any()
        return
    p_pad = -(-ids.shape[0] // CHUNK) * CHUNK
    j_rows = np.zeros((p_pad, 16), np.float32)
    j_rows[:ids.shape[0]][keep] = rows[keep]
    j_ids = np.zeros(p_pad, np.int32)
    j_ids[:ids.shape[0]][keep] = ids[keep]
    ref = np.asarray(j_scatter_accumulate_rows(
        jnp.asarray(j_rows.reshape(-1, CHUNK, 16).transpose(0, 2, 1)),
        jnp.asarray(j_ids.reshape(-1, CHUNK)), n_rows, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-6 * np.abs(ref).max(), rtol=0)


def test_nht_sincos_plain_within_its_bound():
    """Kernel C's NHT sine and cosine, plain: within 1.5e-7 of float64 on
    4M seeded and 1M evenly spaced arguments of the fast path's range,
    and sin and cos of x itself (rounded) past it."""
    rng = np.random.default_rng(8)
    lim = NHT_TRIG_FAST_MAX
    x = np.concatenate([rng.uniform(-lim, lim, 4_000_000),
                        np.linspace(-lim, lim, 1_000_001)]).astype(np.float32)
    s, c = nht_sincos(torch.from_numpy(x))     # CPU: the plain version
    xd = x.astype(np.float64)
    assert np.abs(s.numpy() - np.sin(xd)).max() <= 1.5e-7
    assert np.abs(c.numpy() - np.cos(xd)).max() <= 1.5e-7
    far = rng.uniform(lim, 1e9, 10_000).astype(np.float32)
    s, c = nht_sincos(torch.from_numpy(far))
    np.testing.assert_array_equal(s.numpy(), np.sin(far.astype(np.float64))
                                  .astype(np.float32))


def _view(general=False, rc=RC, seed=0):
    """(model, ViewInputs) of the small parity scene on the CPU; the
    general mode takes the camera's rays as given rays."""
    cam, state = make_test_scene(n=96, seed=seed, res=RES)
    tcam, model = torch_scene(cam, state)
    rays = camera_rays_world(tcam) if general else None
    with torch.no_grad():
        v = prepare_view(tcam, UTConfig(), rc, model, 3, rays=rays)
    return tcam, v


def _upstream(seed=1):
    rng = np.random.default_rng(seed)
    w, h = RES
    return [rng.normal(size=(h, w, c)).astype(np.float32) for c in (3, 1, 1)]


def _table_grad(raster, table, v, rc, ups, **kw):
    """(outputs, d_table) of ``raster`` on the view, for the loss
    sum(features g_feat) + sum(opacity g_opacity) + sum(depth g_depth)."""
    t = table.detach().clone().requires_grad_(True)
    out = raster(t, v.binning.pair_particle, v.binning.tile_start, v.ray_d,
                 v.tmin, v.tmax, rc, ray_o=v.ray_o, **kw)
    loss = sum((o * torch.from_numpy(g)).sum() for o, g in zip(out[:3], ups))
    loss.backward()
    return [o.detach() for o in out], t.grad


@pytest.fixture(scope="module")
def jax_table_run():
    """The port's shared-origin view and JAX rasterize_tiles_table's
    outputs and table gradient on it (interpret mode), for the upstream
    gradients of ``_upstream``."""
    tcam, v = _view()
    b = v.binning
    p = b.pair_particle.shape[0]
    p_pad = -(-p // CHUNK) * CHUNK
    # the pad pairs lie past the last tile, as JAX's sentinel pairs do
    ids = np.zeros(p_pad, np.int32)
    ids[:p] = b.pair_particle.numpy()
    table = np32(v.table)
    records = table[ids].reshape(-1, CHUNK, 16).transpose(0, 2, 1)
    start = b.tile_start.numpy()
    w, h = RES
    grid = (w // 16, h // 16)
    ray_o, _ = camera_rays_world(tcam)
    rays = pack_rays(jnp.asarray(np32(ray_o)), jnp.asarray(np32(v.ray_d)),
                     jnp.asarray(np32(v.tmin)), jnp.asarray(np32(v.tmax)),
                     grid)
    kcfg = RasterKernelConfig(exact_kill=True)
    g_feat, g_opac, g_dep = (jnp.asarray(g) for g in _upstream())

    def loss(tab):
        out = j_rasterize_tiles_table(
            tab, jnp.asarray(records), jnp.asarray(ids.reshape(-1, CHUNK)),
            jnp.asarray(start[:-1]), jnp.asarray(np.diff(start)), rays, kcfg,
            True)
        img = unpack_tiles(out, grid, h, w, kcfg.out_dim)
        return (jnp.sum(img[..., 0:3] * g_feat)
                + jnp.sum(img[..., 3:4] * g_opac)
                + jnp.sum(img[..., 4:5] * g_dep)), img

    import jax

    (_, img), grad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(table))
    return v, np.asarray(img), np.asarray(grad)


def test_table_route_grads_match_jax(jax_table_run):
    v, img, ref = jax_table_run
    launches = scatter_runs.launches
    out, got = _table_grad(rasterize_tiles_table, v.table, v, RC,
                           _upstream())
    assert scatter_runs.launches == launches   # CPU: plain
    for i, (lo, hi) in enumerate(((0, 3), (3, 4), (4, 5))):
        np.testing.assert_allclose(out[i].numpy(), img[..., lo:hi],
                                   atol=1e-4 if i < 2 else 1e-3, rtol=0)
    a, b = got.numpy().astype(np.float64), ref.astype(np.float64)
    # the pairs touch only some rows; every other row reads 0 on both
    scale = np.abs(b).max()
    assert scale > 0
    np.testing.assert_allclose(a / scale, b / scale, atol=2e-3, rtol=0)
    cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 0.9999, cos


@pytest.mark.parametrize("mode", sorted(MODES))
def test_table_route_matches_fold_route(mode):
    rc, general = MODES[mode]
    _, v = _view(general, rc, seed=2)
    b = v.binning
    ups = _upstream(3)
    out_f, g_f = _table_grad(rasterize_tiles_table, v.table, v, rc, ups)
    out_d, g_d = _table_grad(
        rasterize_tiles, v.table, v, rc, ups,
        fold=FoldMeta(b.perm, b.order, b.excl, b.counts, b.limit))
    for a, c in zip(out_f, out_d):
        assert torch.equal(a, c)
    scale = float(g_d.abs().max())
    assert scale > 0
    torch.testing.assert_close(g_f, g_d, atol=1e-6 * scale, rtol=0)


def test_table_route_refusals():
    _, v = _view()
    b = v.binning
    nht = torch.zeros((v.table.shape[0], 64), requires_grad=True)
    with pytest.raises(ValueError, match="16-float records"):
        rasterize_tiles_table(nht, b.pair_particle, b.tile_start, v.ray_d,
                              v.tmin, v.tmax, RC)
    with pytest.raises(ValueError, match="record width 17"):
        scatter_accumulate_rows(torch.zeros((4, 17)),
                                torch.zeros(4, dtype=torch.int32), 8)
    # with no gradient asked for, the route is kernel B alone
    with torch.no_grad():
        out = rasterize_tiles_table(v.table, b.pair_particle, b.tile_start,
                                    v.ray_d, v.tmin, v.tmax, RC)
    assert len(out) == 4 and out[0].shape == (RES[1], RES[0], 3)
