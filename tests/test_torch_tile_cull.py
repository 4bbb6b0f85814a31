"""The cull of kernels B and E in their RGB modes (common.cuh:
stage_rgb_row: each warp's pyramid of 8x4 rays, warp_bundle, against the
particle's ellipsoid in global-Z order, cull_quadric and ellipsoid_keeps,
or its sphere in windows of 16, cull_sphere and planes_keep)
through its plain mirror in the kernels' fp32 operation order
(ops/cuda/raster.py:cull_plain): on every (pair, pixel) of seeded views it
never culls a candidate that the exact test of ``_hit_terms`` accepts; its
counts of the work it leaves add up; and the plain render and the plain
blend-weight telemetry are the same with and without it. The card runs
the same mirror on chip_smoke.py phases 4, 13, 15, 19 and 21's inputs.

The views: the bench cloud through a small pinhole in the 3DGUT, 3DGRT
and sorted-3DGUT settings (shared origin: the cull re-derives each
particle's centre from its record's a = M (o - p)), through a fisheye
(shared origin) and a rolling shutter (the general mode, 3DGUT and
3DGRT); needle-shaped particles (up to 50 to 1) through the pinhole; and
hand-built tiles where every particle is grazed by the corner ray of one
warp's 8x4 block, at its acceptance threshold along its widest axis,
outward of the warp's pyramid, from 1 to 300 units away (shared origin
and general); and particles straddling the camera plane, behind the
camera and across a ray's tmin, with some rays open behind their origins
(no pyramid: the warp keeps every pair).
"""

import math

import numpy as np
import pytest
import torch

from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                   GaussianModelConfig)
from threedgrut_tpu_torch.ops.cuda.raster import (_cull_setup, _thresholds,
                                                  _tilize_rays, cull_plain,
                                                  rasterize_tiles_plain)
from threedgrut_tpu_torch.ops.cuda.wmax import pair_weight_max_plain
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.render.grt import grt_raster_config
from threedgrut_tpu_torch.render.gut import prepare_view
from threedgrut_tpu_torch.synthetic import bench_camera, bench_cloud

RC = RasterConfig()
GRT = grt_raster_config()
SORTED_3DGUT = RasterConfig(sorted_compositing=True, sort_window=16)


def _view_args(model, cam, rc, sh_degree=3):
    """Kernel B's arguments for one camera view (chip_smoke.py:view_inputs):
    the shared-origin mode for a global shutter, else the general one."""
    with torch.no_grad():
        v = prepare_view(cam, UTConfig(), rc, model, sh_degree)
    args = (v.table, v.binning.pair_particle, v.binning.tile_start, v.ray_d,
            v.tmin, v.tmax, rc)
    return args if v.ray_o is None else args + (v.ray_o,)


def _needles(n=400, seed=7):
    """Anisotropic particles (scales 0.002-0.1, up to 50 to 1) in the bench
    cloud's box in front of the bench camera."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0:2] = rng.uniform(-2.0, 2.0, (n, 2))
    pos[:, 2] = rng.uniform(2.0, 9.0, n)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    scale = np.exp(rng.uniform(np.log(0.002), np.log(0.1), (n, 3)))
    arrays = dict(positions=pos, rotation=quat,
                  scale=scale.astype(np.float32),
                  density=rng.uniform(0.3, 0.95, (n, 1)).astype(np.float32),
                  features_albedo=rng.uniform(0, 1, (n, 3)).astype(
                      np.float32),
                  features_specular=np.zeros((n, 0), np.float32))
    return GaussianModel.from_numpy(arrays, config=GaussianModelConfig(
        density_activation="none", scale_activation="none", max_sh_degree=0))


def _tile_rays(n_tiles, general, origin=(0.0, 0.0, 0.0), tmin=0.0):
    """Rays of a 16 x 16 n_tiles image, every tile the same 16x16 pinhole
    pattern down +z (focal 16), float64: directions [16, W, 3] (unit),
    origins (``origin``, plus 1e-3 per pixel column in the general mode),
    t-ranges (tmin, 1e4)."""
    w = 16 * n_tiles
    ys, xs = torch.meshgrid(torch.arange(16.0, dtype=torch.float64),
                            torch.arange(float(w), dtype=torch.float64),
                            indexing="ij")
    d = torch.stack([(xs % 16 + 0.5 - 8.0) / 16.0, (ys + 0.5 - 8.0) / 16.0,
                     torch.ones_like(xs)], -1)
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.zeros_like(d) + torch.tensor(origin, dtype=torch.float64)
    if general:
        o[..., 0] += 1e-3 * xs
    tmin = torch.full((16, w), float(tmin), dtype=torch.float64)
    return o, d, tmin, torch.full((16, w), 1e4, dtype=torch.float64)


def _table(p, axes, s, density, general, origin=None):
    """[N, 16] f32 records of particles at p [N, 3] (float64) with unit
    axes [N, 3, 3] (row i the axis of scale s[:, i]): M = diag(1/s) R^T,
    so row i of M is axis i over s_i; a = M (origin - p) in the
    shared-origin mode, p itself in the general one."""
    m = axes / s[:, :, None]
    first = p if general else torch.einsum("nij,nj->ni", m, origin - p)
    rgb = torch.rand((p.shape[0], 3), generator=torch.Generator().manual_seed(
        0), dtype=torch.float64)
    return torch.cat([first, m.reshape(-1, 9), density[:, None], rgb],
                     -1).float().contiguous()


def _args(table, n_tiles, rays, rc, general, pairs_per_tile=None):
    """Kernel B's arguments over ``n_tiles`` tiles of the rays: tile t
    holds pairs_per_tile[t] (default: every particle, in order)."""
    o, d, tmin, tmax = rays
    n = table.shape[0]
    if pairs_per_tile is None:
        pp = torch.arange(n, dtype=torch.int32).repeat(n_tiles)
        ts = torch.arange(n_tiles + 1, dtype=torch.int32) * n
    else:
        pp = torch.cat(pairs_per_tile).to(torch.int32)
        ts = torch.tensor([0] + [len(x) for x in pairs_per_tile]).cumsum(
            0).to(torch.int32)
    args = (table, pp, ts, d.float().contiguous(), tmin.float().contiguous(),
            tmax.float().contiguous(), rc)
    return args + (o.float().contiguous(),) if general else args


def _grazing(rc, general, seed=11):
    """One particle a tile, grazed by the corner ray of one warp's 8x4
    block (warp k % 8, corner k / 8 % 4): its widest axis across that ray,
    along the outward normal of the side plane of the warp's pyramid
    (``_cull_setup``, as the kernels build it) that faces the corner most,
    at sq = thr (1 + delta)^2 for delta in +-1e-3, 1e-4, 1e-5 and 0, 1,
    30 and 300 units along the ray, so the particle lies just outside the
    pyramid, at the cull's radius; widest scales 0.3-1 and ratios up to
    1.5 at 1 unit, else 0.01-0.1 and up to 50. Built in float64,
    rounded to the f32 records the kernels take."""
    rng = np.random.default_rng(seed)
    deltas = (-1e-3, -1e-4, -1e-5, 0.0, 1e-5, 1e-4, 1e-3)
    backs = (1.0, 30.0, 300.0)
    n = 32 * len(deltas) * len(backs) // 4
    origin = torch.tensor([40.0, -25.0, 7.0], dtype=torch.float64)
    rays = _tile_rays(n, general, origin=tuple(origin.tolist()))
    o, d = rays[0], rays[1]
    tiled = _tilize_rays(d.float(), rays[2].float(), rays[3].float(),
                         o.float() if general else None)
    planes = _cull_setup(tiled, rc, False).bundles[3].double()  # [T, 8, 5, 3]
    s, thr_resp, log_min_alpha = _thresholds(rc)
    dens = torch.tensor(rng.uniform(0.3, 0.95, n))
    thr = torch.clamp((log_min_alpha - torch.log(dens)) / s, max=thr_resp)
    if rc.kernel_degree == 4:
        thr = torch.sqrt(torch.clamp(thr, min=0.0))
    p, axes, scales = [], [], []
    for k in range(n):
        w = k % 8
        cx, cy = (k // 8) % 2, (k // 16) % 2
        x = (w % 2) * 8 + (7 if cx else 0)
        y = (w // 2) * 4 + (3 if cy else 0)
        de, oe = d[y, 16 * k + x], o[y, 16 * k + x]
        out = torch.tensor([1.0 if cx else -1.0, 1.0 if cy else -1.0, 0.0],
                           dtype=torch.float64)
        side = planes[k, w, :4]
        wide = side[torch.argmax(side @ out)]
        wide = wide - (wide @ de) * de
        wide = wide / wide.norm()
        third = torch.linalg.cross(de, wide)
        ax = torch.stack([wide, de, third])
        delta = deltas[k % len(deltas)]
        back = backs[(k // len(deltas)) % len(backs)]
        # near particles large and nearly round: there the radius' own
        # margin, not the pyramid's padding (1e-5 of the distance) or the
        # fp32 terms (64 eps (1 + s_max / s_min)^2 of the distance), is
        # what keeps them
        near = back == 1.0
        big = rng.uniform(0.3, 1.0) if near else rng.uniform(0.01, 0.1)
        ratio = 1.5 if near else 50.0
        sc = torch.tensor([big, big / rng.uniform(1.0, ratio),
                           big / rng.uniform(1.0, ratio)])
        # sq along wide = h^2 / big^2 (wide is an axis, across the ray)
        h = math.sqrt(float(thr[k])) * big * (1.0 + delta)
        p.append(oe + back * de + h * wide)
        axes.append(ax)
        scales.append(sc)
    table = _table(torch.stack(p), torch.stack(axes), torch.stack(scales),
                   dens, general, origin)
    return _args(table, n, rays, rc, general,
                 [torch.tensor([k]) for k in range(n)])


def _straddle(rc, general, seed=5):
    """Particles around the camera plane (z in [-1, 1]: behind the camera,
    across it and in front), every particle in every tile of a 2 x 3 tile
    image; in the general mode tmin 0.3 (particles across it) and, on the
    last tile, -0.5 (rays open behind their origins: no pyramid)."""
    rng = np.random.default_rng(seed)
    n, n_tiles = 120, 3
    o, d, tmin, tmax = _tile_rays(n_tiles, general,
                                  tmin=0.3 if general else 0.0)
    if general:
        tmin[:, 32:] = -0.5
    p = torch.tensor(np.stack([rng.uniform(-0.6, 0.6, n),
                               rng.uniform(-0.6, 0.6, n),
                               rng.uniform(-1.0, 1.0, n)], 1))
    q = torch.tensor(rng.normal(size=(n, 3, 3)))
    axes = torch.linalg.qr(q).Q.transpose(1, 2)
    scales = torch.tensor(np.exp(rng.uniform(np.log(0.01), np.log(0.3),
                                             (n, 3))))
    dens = torch.tensor(rng.uniform(0.3, 0.95, n))
    table = _table(p, axes, scales, dens, general,
                   torch.zeros(3, dtype=torch.float64))
    return _args(table, n_tiles, (o, d, tmin, tmax), rc, general)


# case -> (a function giving kernel B's arguments, floor of the culled
# share)
CASES = {
    "3dgut": (lambda: _view_args(bench_cloud(3000, seed=3),
                                 bench_camera("pinhole", (96, 80)), RC), 0.3),
    "3dgrt-w16": (lambda: _view_args(bench_cloud(3000, seed=3),
                                     bench_camera("pinhole", (96, 80)), GRT),
                  0.3),
    "sorted3dgut-w16": (lambda: _view_args(
        bench_cloud(3000, seed=3), bench_camera("pinhole", (96, 80)),
        SORTED_3DGUT), 0.3),
    "fisheye": (lambda: _view_args(bench_cloud(3000, seed=3),
                                   bench_camera("fisheye", (96, 64)), RC),
                0.3),
    "rolling": (lambda: _view_args(bench_cloud(3000, seed=3),
                                   bench_camera("rolling", (96, 64)), RC),
                0.3),
    "rolling-3dgrt-w16": (lambda: _view_args(
        bench_cloud(3000, seed=3), bench_camera("rolling", (96, 64)), GRT),
        0.3),
    "needles": (lambda: _view_args(_needles(), bench_camera(
        "pinhole", (96, 80)), RC, sh_degree=0), 0.3),
    "grazing": (lambda: _grazing(RC, False), 0.5),
    "grazing-3dgrt": (lambda: _grazing(GRT, False), 0.5),
    "grazing-general": (lambda: _grazing(RC, True), 0.5),
    "grazing-general-3dgrt": (lambda: _grazing(GRT, True), 0.5),
    "straddle": (lambda: _straddle(RC, False), 0.0),
    "straddle-general": (lambda: _straddle(GRT, True), 0.0),
}


@pytest.fixture(scope="module")
def inputs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = CASES[case][0]()
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_cull_never_drops_an_accepted_candidate(inputs, case):
    args = inputs(case)
    with torch.no_grad():
        got = cull_plain(*args)
    assert got["culled_accepted"] == 0, got
    assert got["accepted"] > 0, got
    # no per-ray sphere test in the RGB modes
    assert got["sphere_culled"] == 0 and got["sphere_tests"] == 0, got
    assert got["bundle_culled"] / got["tests"] >= CASES[case][1], got
    if case.startswith("grazing"):
        # the rays inside the threshold are accepted by the exact test:
        # the cull kept candidates at the corner of a warp's pyramid
        assert got["accepted"] >= 3 * args[0].shape[0] // 7, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_cull_counts_add_up(inputs, case):
    """The counts chip_smoke.py's bound of B and E reads: the exact tests
    at most what the cull leaves and at least the candidates the plain
    forward composites; each walked pair staged once and tested against
    at most every warp's pyramid; windows of at most W accepted."""
    args = inputs(case)
    rc = args[6]
    with torch.no_grad():
        got = cull_plain(*args)
        ref = rasterize_tiles_plain(*args)
    kept = got["tests"] - got["bundle_culled"]
    composited = int(ref[3].sum())
    assert composited <= got["exact_tests"] <= kept, got
    assert got["accepted"] <= kept, got
    assert 0 < got["staged"] <= got["tests"] // 256, got
    assert got["bundle_tests"] <= 8 * got["staged"], got
    window = rc.sort_window if rc.sorted_compositing else 1
    assert got["max_window"] <= window, got
    killed = int((ref[4] < rc.min_transmittance).sum())
    if killed == 0:
        assert got["exact_tests"] == kept, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_render_and_weights_equal_with_the_cull(inputs, case):
    """The kernels walk only what the cull keeps: the plain version that
    rejects what it drops gives the same five outputs and per-pair
    weights, bit for bit."""
    args = inputs(case)
    with torch.no_grad():
        ref = rasterize_tiles_plain(*args)
        got = rasterize_tiles_plain(*args, cull=True)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)
        w_ref = pair_weight_max_plain(*args)
        assert torch.equal(pair_weight_max_plain(*args, cull=True), w_ref)
    assert float(w_ref.max()) > 0.0
