"""trace()'s cull (kernels B and C in their windows of 128; common.cuh:
cull_radius, warp_bundle, bundle_keeps, sphere_keeps) through its plain
mirror in the kernels' fp32 operation order
(ops/cuda/raster.py:cull_plain): on every (pair, pixel) of seeded
scenes it never culls a candidate that the exact test of ``_hit_terms``
accepts, and it culls at least a stated share of them. The card runs the
same mirror on chip_smoke.py phases 31 and 33's inputs.

The scenes: trace's CPU test scene (tests/test_torch_trace.py's, brute
force and grid); a 3,000-particle orbit view; the same cloud seen from
origins hundreds of particle radii away; and rays grazing anisotropic
particles at their acceptance threshold along their widest axis, where
the cull's sphere is tight, from near and far, either each along its own
direction (the sphere test decides) or all along one (a warp's bundle
of parallel rays, with origins spread over the cloud); and incoherent
rays from origins across the cloud, some open behind them. The mirror's
counts of the work the kernels need (chip_smoke.py's bound of them) are
held against what the cull leaves and what the plain forward composites.
"""

import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from threedgrut_tpu_torch.convert import model_from_state
from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                   GaussianModelConfig)
from threedgrut_tpu_torch.ops.cuda.raster import (_thresholds, TRACE_K,
                                                  rasterize_tiles_plain,
                                                  cull_plain)
from threedgrut_tpu_torch.render.common import camera_rays_world
from threedgrut_tpu_torch.render.grt import prepare_trace
from threedgrut_tpu_torch.synthetic import bench_cloud, orbit_cameras
from torch_port_utils import (column_rays, faint_column, far_rays,
                              incoherent_rays)

# tests/test_torch_trace.py's grid with room for every cell list
GRID = dict(grid_dims=4, max_cells=64, cell_cap=64, global_cap=256)


def _patch_rays(seed=0, n=300):
    """tests/test_torch_trace.py:_rays: a small patch at z = -6 toward +z."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    ro[:, 2] = -6.0
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 2] = np.abs(rd[:, 2]) + 2.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.tensor(ro), torch.tensor(rd)


def _orbit(model, side=48):
    cam = orbit_cameras(model, 1, resolution=(side, side))[0]
    return camera_rays_world(cam)


def _needles(n=96, seed=7):
    """Anisotropic particles (scales from 0.002 to 0.1, up to 50 to 1),
    densities 0.3-0.95 as given, in the bench cloud's box."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0:2] = rng.uniform(-2.5, 2.5, (n, 2))
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


def _grazing(model, shared_dir, seed=11):
    """Rays whose lines pass each particle at sq = thr (1 + delta)^2 for
    delta in +-1e-3, 1e-4, 1e-5 and 0, offset across the ray along the
    particle's widest direction (the cull's sphere is tight there), with
    origins 1, 30 and 300 units back along the ray; each ray along its own
    direction, or (``shared_dir``) all along one. Built in float64 from
    the fp32 records trace composites."""
    rng = np.random.default_rng(seed)
    inp = prepare_trace(model, torch.zeros(1, 3), torch.ones(1, 3))
    rec = inp.table[:model.n_active].double()
    s, thr_resp, log_min_alpha = _thresholds(inp.cfg)
    thr = torch.sqrt(torch.clamp(torch.clamp(
        (log_min_alpha - torch.log(rec[:, 12])) / s, max=thr_resp), min=0.0))
    m = rec[:, 3:12].reshape(-1, 3, 3)
    p = rec[:, 0:3]
    # the widest world axis: row k of M over its norm (M = diag(1/s) R^T)
    k = torch.argmin((m * m).sum(-1), dim=1)
    wide = m[torch.arange(len(k)), k]
    wide = wide / wide.norm(dim=-1, keepdim=True)
    n = len(k)
    if shared_dir:
        d = torch.tensor(rng.normal(size=3)).expand(n, 3)
    else:
        d = torch.tensor(rng.normal(size=(n, 3)))
    d = d / d.norm(dim=-1, keepdim=True)
    w = wide - (wide * d).sum(-1, keepdim=True) * d
    w = w / w.norm(dim=-1, keepdim=True)
    mw = torch.einsum("nij,nj->ni", m, w)
    md = torch.einsum("nij,nj->ni", m, d)
    g = (mw * mw).sum(-1) - (mw * md).sum(-1) ** 2 / (md * md).sum(-1)
    ro, rd = [], []
    for delta in (-1e-3, -1e-4, -1e-5, 0.0, 1e-5, 1e-4, 1e-3):
        h = torch.sqrt(thr / g) * (1.0 + delta)
        for back in (1.0, 30.0, 300.0):
            ro.append(p + h[:, None] * w - back * d)
            rd.append(d)
    return torch.cat(ro).float(), torch.cat(rd).float()


def _scene_model():
    _, state = make_test_scene(n=200, capacity=256, seed=4, res=(32, 32))
    return model_from_state(state)


# case -> (model, rays, prepare_trace keywords, floor of the culled share)
CASES = {
    "scene-brute": (_scene_model, lambda m: _patch_rays(),
                    dict(accelerate=False), 0.5),
    "scene-grid": (_scene_model, lambda m: _patch_rays(),
                   dict(accelerate=True, **GRID), 0.5),
    "orbit-brute": (lambda: bench_cloud(3000, seed=3), _orbit,
                    dict(accelerate=False), 0.9),
    "orbit-grid": (lambda: bench_cloud(3000, seed=3), _orbit,
                   dict(accelerate=True), 0.9),
    "far-brute": (lambda: bench_cloud(3000, seed=3), far_rays,
                  dict(accelerate=False), 0.9),
    "far-grid": (lambda: bench_cloud(3000, seed=3), far_rays,
                 dict(accelerate=True), 0.9),
    # rays open behind their origins: no warp's rays fit a pyramid, the
    # rays' spheres alone cull
    "orbit-behind": (lambda: bench_cloud(3000, seed=3), _orbit,
                     dict(accelerate=False, t_min=-10.0), 0.9),
    # origins spread over the cloud, directions anywhere, a quarter of
    # the rays of the second half open behind their origins
    "incoherent-brute": (lambda: bench_cloud(3000, seed=3), incoherent_rays,
                         dict(accelerate=False), 0.9),
    "incoherent-grid": (lambda: bench_cloud(3000, seed=3), incoherent_rays,
                        dict(accelerate=True), 0.9),
    "grazing": (_needles, lambda m: _grazing(m, False),
                dict(accelerate=False), 0.5),
    "grazing-parallel": (_needles, lambda m: _grazing(m, True),
                         dict(accelerate=False), 0.5),
}


def _case_inputs(model, make_rays, kw):
    """prepare_trace's inputs of a case: its rays (and their t_min, where
    the rays carry one) through its keywords."""
    rays = make_rays(model)
    if len(rays) == 3:
        kw = dict(kw, t_min=rays[2])
    return prepare_trace(model, rays[0], rays[1], **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cull_never_drops_an_accepted_candidate(case):
    make_model, make_rays, kw, floor = CASES[case]
    model = make_model()
    with torch.no_grad():
        got = cull_plain(*_case_inputs(model, make_rays, kw).args())
    assert got["culled_accepted"] == 0, got
    assert got["accepted"] > 0, got
    share = (got["bundle_culled"] + got["sphere_culled"]) / got["tests"]
    assert share >= floor, got
    if case.startswith("grazing"):
        # the rays at or inside the threshold are accepted by the exact
        # test: the cull kept candidates right at its sphere's edge
        assert got["accepted"] >= model.n_active * 3, got
    assert got["max_window"] <= 128


def test_cull_sees_windows_over_the_kbuffer():
    """A column of faint particles along the rays: more than TRACE_K
    accepted in one window, which the kernels' k-buffer takes in extra
    passes (tests/test_torch_gpu.py holds them against the plain
    versions), and still nothing accepted is culled."""
    model = faint_column()
    ro, rd = column_rays()
    with torch.no_grad():
        got = cull_plain(*prepare_trace(model, ro, rd,
                                              accelerate=False).args())
    assert got["culled_accepted"] == 0, got
    assert got["over_k"] > 0 and got["max_window"] > 2 * TRACE_K, got


@pytest.mark.parametrize("case", ["column", "orbit-brute",
                                  "incoherent-brute"])
def test_cull_counts_the_work_the_kernels_need(case):
    """The counts chip_smoke.py's bound of trace's B and C reads: each
    count at most what the cull leaves and the exact tests at least the
    candidates the plain forward composites; where no ray is killed (the
    orbit view) every (pair, pixel) the cull leaves, each pair staged once
    and tested against every warp's pyramid; down the faint column, whose
    rays are killed, fewer than the cull leaves; where warps test every
    pair (the incoherent rays), fewer pyramid tests than warps."""
    if case == "column":
        model, (ro, rd), kw = faint_column(), column_rays(), {}
    else:
        model = CASES[case][0]()
        rays = CASES[case][1](model)
        ro, rd = rays[:2]
        kw = dict(CASES[case][2], **(dict(t_min=rays[2]) if len(rays) == 3
                                     else {}))
    with torch.no_grad():
        inp = prepare_trace(model, ro, rd, **kw)
        got = cull_plain(*inp.args())
        ref = rasterize_tiles_plain(*inp.args())
    kept = got["tests"] - got["bundle_culled"]
    tested = kept - got["sphere_culled"]
    composited = int(ref[3].sum())
    killed = int((ref[4] < inp.cfg.min_transmittance).sum())
    assert composited <= got["exact_tests"] <= tested, got
    assert got["exact_tests"] <= got["sphere_tests"] <= kept, got
    assert got["staged"] <= got["tests"] // 256, got
    assert got["bundle_tests"] <= 8 * got["staged"], got
    if case == "orbit-brute":
        assert killed == 0
        assert (got["sphere_tests"], got["exact_tests"]) == (kept, tested)
        assert got["staged"] == got["tests"] // 256
        assert got["bundle_tests"] == 8 * got["staged"]
    elif case == "column":
        assert killed > 0 and got["exact_tests"] < tested, got
        assert got["staged"] < got["tests"] // 256, got
    else:
        assert got["bundle_tests"] < 8 * got["staged"], got
