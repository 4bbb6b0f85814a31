"""Each CUDA kernel of the port against its plain PyTorch version, on
the card. Every test here is marked ``gpu`` and skips where there is no
CUDA device. This file imports no JAX, so the card's machine (which has
none) runs it without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from threedgrut_tpu_torch.models.gaussians import GaussianModelConfig
from threedgrut_tpu_torch.ops import binning as t_bin
from threedgrut_tpu_torch.ops.cameras import make_pinhole
from threedgrut_tpu_torch.ops.cuda.expand import (
    expand_decode_pairs, expand_decode_pairs_plain, expand_sorted_rows,
    expand_sorted_rows_plain)
from threedgrut_tpu_torch.ops.cuda.fill import (forward_fill,
                                                forward_fill_plain,
                                                segmented_fill_rows,
                                                segmented_fill_rows_plain)
from threedgrut_tpu_torch.ops.cuda.fold import (fold_pairs, fold_pairs_plain,
                                                fold_shared_segment,
                                                invert_permutation,
                                                invert_permutation_plain)
from threedgrut_tpu_torch.ops.cuda.project import project_view
from threedgrut_tpu_torch.ops.cuda.raster import (
    NHT_TRIG_FAST_MAX, FoldMeta, cull_plain, nht_fwd_kernel_attributes,
    nht_kernel_attributes, nht_sincos, rasterize_tiles,
    rasterize_tiles_backward, rasterize_tiles_backward_plain,
    rasterize_tiles_forward, rasterize_tiles_plain, rasterize_tiles_table,
    repeat_fold, rgb_kernel_attributes)
from threedgrut_tpu_torch.ops.cuda.scatter import (
    id_runs, id_runs_plain, kernel_attributes, scatter_accumulate_rows,
    scatter_accumulate_rows_plain, scatter_runs)
from threedgrut_tpu_torch.ops.cuda.wmax import (pair_weight_max,
                                                pair_weight_max_plain)
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.render.grt import grt_raster_config, render_grt
from threedgrut_tpu_torch.render.gut import prepare_view, render_gut
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.synthetic import bench_cloud
from torch_port_utils import (ADVERSARIAL_IDS, PROJECTION_CAMERAS,
                              adversarial_ids, column_rays, faint_column,
                              far_rays, incoherent_rays, projection_camera,
                              projection_backward_check, projection_check,
                              projection_cloud)

RC = RasterConfig()
# the sorted settings of apps/nerf_synthetic_3dgrt and of
# paper/3dgut/sorted_nerf_synthetic as train_torch.py composes them
# (tests/test_torch_grt.py holds them to the YAML)
SORTED = {"grt": grt_raster_config(),
          "sorted3dgut": RasterConfig(kernel_degree=2, min_transmittance=1e-4,
                                      sorted_compositing=True,
                                      sort_window=16)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _view(device, n=4000, side=200, rc=RC):
    model = bench_cloud(n, seed=1, device=device)
    cam = make_pinhole((side, side + 24), (1.1 * side, 1.1 * side),
                       (side / 2, side / 2 + 12), device=device)
    with torch.no_grad():
        return prepare_view(cam, UTConfig(), rc, model, 3)


@pytest.mark.gpu
def test_bin_decode_matches_plain(cuda):
    v = _view(cuda)
    slots = t_bin.pair_slots(v.proj, (13, 15))
    before = expand_decode_pairs.launches
    got = expand_decode_pairs(slots.rows, slots.order, slots.excl,
                              slots.counts, slots.total, (13, 15))
    assert expand_decode_pairs.launches == before + 1
    ref = expand_decode_pairs_plain(slots.rows, slots.order, slots.excl,
                                    slots.counts, slots.total, (13, 15))
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.gpu
def test_raster_fwd_matches_plain(cuda):
    v = _view(cuda)
    args = (v.table, v.binning.pair_particle, v.binning.tile_start,
            v.ray_d, v.tmin, v.tmax, RC)
    before = rasterize_tiles.launches
    got = rasterize_tiles_forward(*args)
    assert rasterize_tiles.launches == before + 1
    ref = rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    for i in (0, 1, 4):        # features, opacity, T_final
        torch.testing.assert_close(got[i], ref[i], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=1e-3, rtol=1e-3)
    assert (got[3] != ref[3]).float().mean() < 0.01
    assert float(got[1].mean()) > 0.05      # the view is covered


@pytest.mark.gpu
def test_wrappers_reject_bad_cuda_inputs(cuda):
    v = _view(cuda)
    b = v.binning
    with pytest.raises(TypeError):
        rasterize_tiles(v.table.double(), b.pair_particle, b.tile_start,
                        v.ray_d, v.tmin, v.tmax, RC)
    with pytest.raises(ValueError):
        rasterize_tiles(v.table, b.pair_particle, b.tile_start.cpu(),
                        v.ray_d, v.tmin, v.tmax, RC)
    with pytest.raises(ValueError, match="FoldMeta"):
        rasterize_tiles(v.table.requires_grad_(), b.pair_particle,
                        b.tile_start, v.ray_d, v.tmin, v.tmax, RC)
    with pytest.raises(ValueError):
        fold_pairs(torch.zeros((b.limit, 16), device=cuda), b.perm,
                   b.order, b.excl, b.counts, b.limit + 1,
                   b.order.shape[0])


def _upstream(v, seed=0):
    """Seeded random gradients of features, opacity and depth."""
    g = torch.Generator(device=v.ray_d.device).manual_seed(seed)
    h, w = v.ray_d.shape[:2]
    return [torch.randn((h, w, c), generator=g, device=v.ray_d.device)
            for c in (3, 1, 1)]


@pytest.mark.gpu
def test_raster_bwd_matches_plain(cuda):
    """Kernel C against the float64 autograd plain version: cosine and
    relative L2 per record field group (fp32 sums over up to 256 pixels
    in another order; the suffix subtraction cancels in fp32)."""
    v = _view(cuda)
    b = v.binning
    fwd = rasterize_tiles_forward(v.table, b.pair_particle, b.tile_start,
                                  v.ray_d, v.tmin, v.tmax, RC)
    args = (v.table, b.pair_particle, b.tile_start, v.ray_d, v.tmin,
            v.tmax, fwd[0], fwd[2], fwd[4], *_upstream(v), RC)
    before = rasterize_tiles_backward.launches
    got = rasterize_tiles_backward(*args)
    assert rasterize_tiles_backward.launches == before + 1
    ref = rasterize_tiles_backward_plain(*args)
    torch.cuda.synchronize()
    for sl in (slice(0, 3), slice(3, 12), slice(12, 13), slice(13, 16)):
        x, y = got[:, sl].double().flatten(), ref[:, sl].double().flatten()
        assert float(x @ y / (x.norm() * y.norm())) >= 0.9999
        assert float((x - y).norm() / y.norm()) <= 1e-3
    # culled pairs past the last tile read zero
    assert float(got[int(b.tile_start[-1]):].abs().sum()) == 0.0


@pytest.mark.gpu
def test_fold_matches_plain_and_is_deterministic(cuda):
    v = _view(cuda)
    b = v.binning
    g = torch.Generator(device=cuda).manual_seed(1)
    d_rec = torch.randn((b.limit, 16), generator=g, device=cuda)
    args = (d_rec, b.perm, b.order, b.excl, b.counts, b.limit,
            b.order.shape[0])
    before = fold_pairs.launches
    got = fold_pairs(*args)
    again = fold_pairs(*args)
    assert fold_pairs.launches == before + 2
    ref = fold_pairs_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, atol=1e-5 * float(ref.abs().max()),
                               rtol=0)


@pytest.mark.gpu
def test_render_grad_on_card_matches_cpu(cuda):
    """render_gut's backward on the card goes through kernels B, C and D
    and agrees with the CPU's plain versions."""
    grads = []
    for dev in (cuda, torch.device("cpu")):
        model = bench_cloud(3000, seed=2, device=dev)
        cam = make_pinhole((96, 80), (110.0, 110.0), (48.0, 40.0),
                           device=dev)
        counts = (rasterize_tiles.launches, rasterize_tiles_backward.launches,
                  fold_pairs.launches)
        out = render_gut(cam, UTConfig(), RC, model, 3)
        loss = (out["pred_features"].square().mean()
                + 0.1 * out["pred_opacity"].mean()
                + 0.01 * out["pred_dist"].mean())
        loss.backward()
        after = (rasterize_tiles.launches, rasterize_tiles_backward.launches,
                 fold_pairs.launches)
        step = 1 if dev.type == "cuda" else 0
        assert after == tuple(c + step for c in counts)
        grads.append({k: getattr(model, k).grad.cpu() for k in (
            "positions", "rotation", "scale", "density", "features_albedo",
            "features_specular")})
    for k, g in grads[0].items():
        r = grads[1][k]
        scale = float(r.abs().max()) + 1e-12
        torch.testing.assert_close(g / scale, r / scale, atol=2e-3, rtol=0)


@pytest.mark.gpu
def test_render_on_card_matches_cpu(cuda):
    model_g = bench_cloud(3000, seed=2, device=cuda)
    model_c = bench_cloud(3000, seed=2)
    outs = []
    for dev, model in ((cuda, model_g), ("cpu", model_c)):
        cam = make_pinhole((96, 80), (110.0, 110.0), (48.0, 40.0),
                           device=dev)
        with torch.no_grad():
            outs.append(render_gut(cam, UTConfig(), RC, model, 3))
    g, c = outs
    for k in ("pred_features", "pred_opacity"):
        torch.testing.assert_close(g[k].cpu(), c[k], atol=1e-4, rtol=0)
    assert (g["hits_count"].cpu() != c["hits_count"]).float().mean() < 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(SORTED))
def test_sorted_raster_fwd_matches_plain(cuda, mode):
    rc = SORTED[mode]
    v = _view(cuda, rc=rc)
    args = (v.table, v.binning.pair_particle, v.binning.tile_start,
            v.ray_d, v.tmin, v.tmax, rc)
    got = rasterize_tiles_forward(*args)
    ref = rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    for i in (0, 1, 4):        # features, opacity, T_final
        torch.testing.assert_close(got[i], ref[i], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=1e-3, rtol=1e-3)
    assert (got[3] != ref[3]).float().mean() < 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(SORTED))
def test_sorted_raster_bwd_matches_plain(cuda, mode):
    """Kernel C in the sorted mode against the float64 autograd plain
    version (same tolerances as the unsorted test), bitwise repeatable."""
    rc = SORTED[mode]
    v = _view(cuda, rc=rc)
    b = v.binning
    fwd = rasterize_tiles_forward(v.table, b.pair_particle, b.tile_start,
                                  v.ray_d, v.tmin, v.tmax, rc)
    args = (v.table, b.pair_particle, b.tile_start, v.ray_d, v.tmin,
            v.tmax, fwd[0], fwd[2], fwd[4], *_upstream(v), rc)
    got = rasterize_tiles_backward(*args)
    again = rasterize_tiles_backward(*args)
    ref = rasterize_tiles_backward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for sl in (slice(0, 3), slice(3, 12), slice(12, 13), slice(13, 16)):
        x, y = got[:, sl].double().flatten(), ref[:, sl].double().flatten()
        assert float(x @ y / (x.norm() * y.norm())) >= 0.9999
        assert float((x - y).norm() / y.norm()) <= 1e-3
    assert float(got[int(b.tile_start[-1]):].abs().sum()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["unsorted", "grt", "sorted3dgut"])
def test_wmax_matches_plain_and_is_deterministic(cuda, mode):
    rc = SORTED.get(mode, RC)
    v = _view(cuda, rc=rc)
    b = v.binning
    args = (v.table, b.pair_particle, b.tile_start, v.ray_d, v.tmin,
            v.tmax, rc)
    before = pair_weight_max.launches
    got = pair_weight_max(*args)
    again = pair_weight_max(*args)
    assert pair_weight_max.launches == before + 2
    ref = pair_weight_max_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    assert float(got.max()) > 0.1


@pytest.mark.gpu
def test_grt_render_grad_on_card_matches_cpu(cuda):
    """render_grt's backward on the card (sorted kernels B and C, then D)
    agrees with the CPU's plain versions."""
    grads = []
    for dev in (cuda, torch.device("cpu")):
        model = bench_cloud(3000, seed=2, device=dev)
        cam = make_pinhole((96, 80), (110.0, 110.0), (48.0, 40.0),
                           device=dev)
        out = render_grt(cam, UTConfig(), RC, model, 3)
        loss = (out["pred_features"].square().mean()
                + 0.1 * out["pred_opacity"].mean()
                + 0.01 * out["pred_dist"].mean())
        loss.backward()
        grads.append({k: getattr(model, k).grad.cpu() for k in (
            "positions", "rotation", "scale", "density", "features_albedo",
            "features_specular")})
    for k, g in grads[0].items():
        r = grads[1][k]
        scale = float(r.abs().max()) + 1e-12
        torch.testing.assert_close(g / scale, r / scale, atol=2e-3, rtol=0)


# the general-geometry mode (kernel 5): a rolling-shutter view, whose rays
# each start at the mid-shutter centre plus a per-pixel offset, so that
# no two pixels share an origin
GENERAL = {"3dgut": RC, "grt": SORTED["grt"]}


def _general_view(device, rc=RC, n=4000, side=200):
    from threedgrut_tpu_torch.render.common import camera_rays_world
    from threedgrut_tpu_torch.synthetic import bench_camera

    model = bench_cloud(n, seed=1, device=device)
    cam = bench_camera("rolling", device=device)
    cam.resolution = (side, side + 24)
    cam.principal = torch.tensor([side / 2, side / 2 + 12], device=device)
    cam.focal = torch.tensor([1.1 * side, 1.1 * side], device=device)
    ray_o, ray_d = camera_rays_world(cam)
    g = torch.Generator(device=device).manual_seed(3)
    ray_o = ray_o + 0.01 * torch.randn(ray_o.shape, generator=g,
                                       device=device)
    with torch.no_grad():
        return prepare_view(cam, UTConfig(), rc, model, 3,
                            rays=(ray_o, ray_d))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(GENERAL))
def test_general_raster_fwd_matches_plain(cuda, mode):
    rc = GENERAL[mode]
    v = _general_view(cuda, rc)
    assert v.ray_o is not None
    args = (v.table, v.binning.pair_particle, v.binning.tile_start,
            v.ray_d, v.tmin, v.tmax, rc, v.ray_o)
    before = (rasterize_tiles.launches, rasterize_tiles.launches_general)
    got = rasterize_tiles_forward(*args)
    assert (rasterize_tiles.launches,
            rasterize_tiles.launches_general) == (before[0], before[1] + 1)
    ref = rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    for i in (0, 1, 4):        # features, opacity, T_final
        torch.testing.assert_close(got[i], ref[i], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=1e-3, rtol=1e-3)
    assert (got[3] != ref[3]).float().mean() < 0.01
    assert float(got[1].mean()) > 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(GENERAL))
def test_general_raster_bwd_matches_plain(cuda, mode):
    """Kernel C in the general mode against the float64 autograd plain
    version (the tolerances of the shared-origin test), bitwise
    repeatable."""
    rc = GENERAL[mode]
    v = _general_view(cuda, rc)
    b = v.binning
    fwd = rasterize_tiles_forward(v.table, b.pair_particle, b.tile_start,
                                  v.ray_d, v.tmin, v.tmax, rc, v.ray_o)
    args = (v.table, b.pair_particle, b.tile_start, v.ray_d, v.tmin,
            v.tmax, fwd[0], fwd[2], fwd[4], *_upstream(v), rc, v.ray_o)
    before = rasterize_tiles_backward.launches_general
    got = rasterize_tiles_backward(*args)
    again = rasterize_tiles_backward(*args)
    assert rasterize_tiles_backward.launches_general == before + 2
    ref = rasterize_tiles_backward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for sl in (slice(0, 3), slice(3, 12), slice(12, 13), slice(13, 16)):
        x, y = got[:, sl].double().flatten(), ref[:, sl].double().flatten()
        assert float(x @ y / (x.norm() * y.norm())) >= 0.9999
        assert float((x - y).norm() / y.norm()) <= 1e-3
    assert float(got[int(b.tile_start[-1]):].abs().sum()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(GENERAL))
def test_general_wmax_matches_plain(cuda, mode):
    rc = GENERAL[mode]
    v = _general_view(cuda, rc)
    b = v.binning
    args = (v.table, b.pair_particle, b.tile_start, v.ray_d, v.tmin,
            v.tmax, rc, v.ray_o)
    got = pair_weight_max(*args)
    again = pair_weight_max(*args)
    ref = pair_weight_max_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    assert float(got.max()) > 0.1


@pytest.mark.gpu
def test_rolling_render_grad_on_card_matches_cpu(cuda):
    """A rolling-shutter render_gut's backward on the card (general B, C,
    then D) agrees with the CPU's plain versions."""
    from threedgrut_tpu_torch.synthetic import bench_camera

    grads = []
    for dev in (cuda, torch.device("cpu")):
        model = bench_cloud(3000, seed=2, device=dev)
        cam = bench_camera("rolling", device=dev)
        cam.resolution = (96, 80)
        cam.principal = torch.tensor([48.0, 40.0], device=dev)
        cam.focal = torch.tensor([110.0, 110.0], device=dev)
        before = rasterize_tiles_backward.launches_general
        out = render_gut(cam, UTConfig(), RC, model, 3)
        loss = (out["pred_features"].square().mean()
                + 0.1 * out["pred_opacity"].mean()
                + 0.01 * out["pred_dist"].mean())
        loss.backward()
        step = 1 if dev.type == "cuda" else 0
        assert rasterize_tiles_backward.launches_general == before + step
        grads.append({k: getattr(model, k).grad.cpu() for k in (
            "positions", "rotation", "scale", "density", "features_albedo",
            "features_specular")})
    for k, g in grads[0].items():
        r = grads[1][k]
        scale = float(r.abs().max()) + 1e-12
        torch.testing.assert_close(g / scale, r / scale, atol=2e-3, rtol=0)


# the NHT mode (kernel 8): 64-float records, always general and global-Z;
# degree 2 (3DGUT) and 4 (3DGRT, which NHT composites unsorted)
NHT = {"3dgut": RC, "grt": SORTED["grt"].replace(sorted_compositing=False)}
NHT_GROUPS = {"p": slice(0, 3), "M": slice(3, 12), "density": slice(12, 13),
              "features": slice(13, 61)}


def _nht_view(device, rc=RC, n=4000, side=200):
    from threedgrut_tpu_torch.synthetic import nht_cloud

    model = nht_cloud(n, seed=1, device=device)
    cam = make_pinhole((side, side + 24), (1.1 * side, 1.1 * side),
                       (side / 2, side / 2 + 12), device=device)
    with torch.no_grad():
        return prepare_view(cam, UTConfig(), rc, model, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(NHT))
def test_nht_raster_fwd_matches_plain(cuda, mode):
    rc = NHT[mode]
    v = _nht_view(cuda, rc)
    assert v.ray_o is not None and v.table.shape[1] == 64
    args = (v.table, v.binning.pair_particle, v.binning.tile_start,
            v.ray_d, v.tmin, v.tmax, rc, v.ray_o)
    before = rasterize_tiles.launches_nht
    got = rasterize_tiles_forward(*args)
    assert rasterize_tiles.launches_nht == before + 1
    ref = rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (224, 200, 24)
    for i in (0, 1, 4):        # features, opacity, T_final
        torch.testing.assert_close(got[i], ref[i], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=1e-3, rtol=1e-3)
    assert (got[3] != ref[3]).float().mean() < 0.01
    assert float(got[1].mean()) > 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(NHT))
def test_nht_raster_bwd_matches_plain(cuda, mode):
    """Kernel C in the NHT mode against the float64 autograd plain version
    per field group (p, M, density, the 48 features), bitwise
    repeatable; the 3 padding fields stay zero."""
    rc = NHT[mode]
    v = _nht_view(cuda, rc)
    b = v.binning
    fwd = rasterize_tiles_forward(v.table, b.pair_particle, b.tile_start,
                                  v.ray_d, v.tmin, v.tmax, rc, v.ray_o)
    g = torch.Generator(device=cuda).manual_seed(0)
    h, w = v.ray_d.shape[:2]
    up = [torch.randn((h, w, c), generator=g, device=cuda) for c in (24, 1, 1)]
    args = (v.table, b.pair_particle, b.tile_start, v.ray_d, v.tmin,
            v.tmax, fwd[0], fwd[2], fwd[4], *up, rc, v.ray_o)
    before = rasterize_tiles_backward.launches_nht
    got = rasterize_tiles_backward(*args)
    again = rasterize_tiles_backward(*args)
    assert rasterize_tiles_backward.launches_nht == before + 2
    ref = rasterize_tiles_backward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for sl in NHT_GROUPS.values():
        x, y = got[:, sl].double().flatten(), ref[:, sl].double().flatten()
        assert float(x @ y / (x.norm() * y.norm())) >= 0.9999
        assert float((x - y).norm() / y.norm()) <= 1e-3
    assert float(got[:, 61:].abs().sum()) == 0.0
    assert float(got[int(b.tile_start[-1]):].abs().sum()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(NHT))
def test_nht_raster_bwd_far_blends_match_plain(cuda, mode):
    """Kernel C in the NHT mode with half the particles' control features
    moved by 9,000 (the barycentric weights sum to 1, so their blends move
    by as much): the fast sine's Cody-Waite step far from [-pi, pi].
    Against the float64 plain version per field group: cosine
    >= 0.999 and relative L2 <= 1e-2, looser than the 0.9999 / 1e-3 of
    the test above because a float32 blend near 9,000 carries ~5e-4 of
    rounding into its sine and cosine; bitwise repeatable."""
    rc = NHT[mode]
    v = _nht_view(cuda, rc)
    b = v.binning
    table = v.table.clone()
    table[::2, 13:61] += 9000.0
    fwd = rasterize_tiles_forward(table, b.pair_particle, b.tile_start,
                                  v.ray_d, v.tmin, v.tmax, rc, v.ray_o)
    g = torch.Generator(device=cuda).manual_seed(1)
    h, w = v.ray_d.shape[:2]
    up = [torch.randn((h, w, c), generator=g, device=cuda) for c in (24, 1, 1)]
    args = (table, b.pair_particle, b.tile_start, v.ray_d, v.tmin, v.tmax,
            fwd[0], fwd[2], fwd[4], *up, rc, v.ray_o)
    got = rasterize_tiles_backward(*args)
    again = rasterize_tiles_backward(*args)
    ref = rasterize_tiles_backward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for sl in NHT_GROUPS.values():
        x, y = got[:, sl].double().flatten(), ref[:, sl].double().flatten()
        assert float(x @ y / (x.norm() * y.norm())) >= 0.999
        assert float((x - y).norm() / y.norm()) <= 1e-2


@pytest.mark.gpu
def test_nht_sincos_within_its_bound(cuda):
    """The NHT sine and cosine of kernels B and C on the card (the
    Cody-Waite step and the SFU up to NHT_TRIG_FAST_MAX, the accurate
    sincosf past it, here to 1e9) within 1e-6 of float64
    (common.cuh:sincos_fast), and the resources of kernel C's NHT mode:
    two blocks an SM need <= 128 registers."""
    rng = np.random.default_rng(9)
    x = np.concatenate([
        rng.uniform(-NHT_TRIG_FAST_MAX, NHT_TRIG_FAST_MAX, 1_000_000),
        rng.uniform(-1e9, 1e9, 100_000)]).astype(np.float32)
    s, c = nht_sincos(torch.from_numpy(x).to(cuda))
    xd = x.astype(np.float64)
    assert np.abs(s.cpu().numpy() - np.sin(xd)).max() <= 1e-6
    assert np.abs(c.cpu().numpy() - np.cos(xd)).max() <= 1e-6
    for a in nht_kernel_attributes().values():
        assert a["registers"] <= 128 and a["shared_bytes"] == 0
        assert 48 * 1024 < a["dynamic_shared_bytes"] <= 227 * 1024 // 2


@pytest.mark.gpu
def test_fold_64_wide_matches_plain_and_is_deterministic(cuda):
    v = _nht_view(cuda)
    b = v.binning
    g = torch.Generator(device=cuda).manual_seed(1)
    d_rec = torch.randn((b.limit, 64), generator=g, device=cuda)
    args = (d_rec, b.perm, b.order, b.excl, b.counts, b.limit,
            b.order.shape[0])
    before = (fold_pairs.launches, fold_pairs.launches_wide)
    got = fold_pairs(*args)
    again = fold_pairs(*args)
    assert (fold_pairs.launches, fold_pairs.launches_wide) == (
        before[0], before[1] + 2)
    ref = fold_pairs_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, atol=1e-5 * float(ref.abs().max()),
                               rtol=0)


@pytest.mark.gpu
def test_nht_render_grad_on_card_matches_cpu(cuda):
    """An NHT render_gut's backward on the card (NHT kernels B and C, then
    the 64-wide D) agrees with the CPU's plain versions."""
    from threedgrut_tpu_torch.synthetic import nht_cloud

    grads = []
    for dev in (cuda, torch.device("cpu")):
        model = nht_cloud(3000, seed=2, device=dev)
        cam = make_pinhole((96, 80), (110.0, 110.0), (48.0, 40.0),
                           device=dev)
        before = fold_pairs.launches_wide
        out = render_gut(cam, UTConfig(), RC, model, 0)
        loss = (out["pred_features"].square().mean()
                + 0.1 * out["pred_opacity"].mean()
                + 0.01 * out["pred_dist"].mean())
        loss.backward()
        assert fold_pairs.launches_wide == before + (dev.type == "cuda")
        grads.append({k: getattr(model, k).grad.cpu() for k in (
            "positions", "rotation", "scale", "density", "features")})
    for k, g in grads[0].items():
        r = grads[1][k]
        scale = float(r.abs().max()) + 1e-12
        torch.testing.assert_close(g / scale, r / scale, atol=2e-3, rtol=0)


def _trace_rays(model, side):
    """Orbit camera rays [side, side, 3] (origins, directions) around the
    live cloud, on the model's device."""
    from threedgrut_tpu_torch.render.common import camera_rays_world
    from threedgrut_tpu_torch.synthetic import orbit_cameras

    cam = orbit_cameras(model, 1, resolution=(side, side),
                        device=model.device)[0]
    return camera_rays_world(cam)


# trace()'s regimes: brute force (the shared-segment mode of B and C) and
# the grid, each in its windows of 128 and in rank order (_sorted=False)
TRACE = {f"{acc}-{srt}": (acc == "grid", srt == "sorted")
         for acc in ("brute", "grid") for srt in ("sorted", "rank")}
# their rays, as (origins, directions, trace keywords): an orbit camera's;
# a grid of rays from 300 units behind the cloud (the cull's far origins,
# tests/test_torch_trace_cull.py); and incoherent rays, from origins
# across the cloud in all directions, some open behind their origins
# (warps that test every pair, and pyramids with wide apexes)
TRACE_RAYS = {
    "orbit": lambda m, side: (*_trace_rays(m, side), {}),
    "far": lambda m, side: (*far_rays(m, side=side), {}),
    "incoherent": lambda m, side: (lambda ro, rd, t_min: (
        ro, rd, dict(t_min=t_min)))(*incoherent_rays(m, side))}


def _far_matches_plain(cuda, accelerate, srt):
    """Kernel B in trace()'s modes (with normals) on far rays against its
    plain version on the same inputs on the card: from 300 units away a
    ray's direction rounded one ulp apart moves it by 2e-5, so the CPU's
    own trace inputs would differ. Features, opacity and T_final within
    1e-4 but on at most 8 kill flips (chip_smoke.py phase 19's rule: T
    within rounding of min_transmittance, one candidate apart); normals
    3e-4 but on at most 8 rays, those within 2e-3 (phase 34's)."""
    from threedgrut_tpu_torch.render.grt import prepare_trace

    model = bench_cloud(3000, seed=3, device=cuda)
    ro, rd = far_rays(model, side=48)
    with torch.no_grad():
        inp = prepare_trace(model, ro, rd,
                            raster_cfg=RasterConfig(enable_normals=True),
                            accelerate=accelerate, _sorted=srt)
        got = rasterize_tiles_forward(*inp.args())
        ref = rasterize_tiles_plain(*inp.args())
    pix = torch.maximum(torch.maximum(
        (got[0] - ref[0]).abs().amax(-1), (got[1] - ref[1]).abs()[..., 0]),
        (got[4] - ref[4]).abs()[..., 0])
    flip = pix > 1e-4
    rc = inp.cfg
    assert int(flip.sum()) <= 8, int(flip.sum())
    assert float(pix.max()) <= max(rc.max_alpha * rc.min_transmittance,
                                   1e-4)
    assert bool((torch.maximum(got[4], ref[4])[..., 0][flip]
                 < rc.min_transmittance).all())
    # normals: chip_smoke.py:normals_agreement's rule (the hit's entry
    # point cancels digits at far origins)
    n_err = (got[5] - ref[5]).abs().amax(-1)[~flip]
    assert int((n_err > 3e-4).sum()) <= 8 and float(n_err.max()) <= 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("rays", sorted(TRACE_RAYS))
@pytest.mark.parametrize("mode", sorted(TRACE))
def test_trace_matches_plain(cuda, mode, rays):
    """trace on the card (kernel B in trace()'s modes, and its normals
    mode) against the CPU's plain versions: features and opacity within
    1e-4, normals 3e-4 (the plain version's in the kernel's fp32
    operation order), accel_overflow equal; from far origins against the
    plain version on the card's own inputs (``_far_matches_plain``)."""
    from threedgrut_tpu_torch.render.grt import trace

    accelerate, srt = TRACE[mode]
    if rays == "far":
        _far_matches_plain(cuda, accelerate, srt)
        return
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model = bench_cloud(3000, seed=3, device=dev)
        ro, rd, kw = TRACE_RAYS[rays](model, 48)
        with torch.no_grad():
            outs.append(trace(model, ro, rd, accelerate=accelerate,
                              _sorted=srt, **kw))
            before = rasterize_tiles.launches_normals
            outs[-1]["pred_normals"] = trace(
                model, ro, rd, raster_cfg=RasterConfig(enable_normals=True),
                accelerate=accelerate, _sorted=srt, **kw)["pred_normals"]
        step = 1 if dev.type == "cuda" else 0
        assert rasterize_tiles.launches_normals == before + step
    g, c = outs
    for k in ("pred_features", "pred_opacity"):
        torch.testing.assert_close(g[k].cpu(), c[k], atol=1e-4, rtol=0)
    torch.testing.assert_close(g["pred_normals"].cpu(), c["pred_normals"],
                               atol=3e-4, rtol=0)
    torch.testing.assert_close(g["pred_dist"].cpu(), c["pred_dist"],
                               atol=1e-3, rtol=1e-3)
    if accelerate:
        assert int(g["accel_overflow"]) == int(c["accel_overflow"])


@pytest.mark.gpu
@pytest.mark.parametrize("rays", sorted(TRACE_RAYS))
@pytest.mark.parametrize("mode", sorted(TRACE))
def test_trace_grad_on_card_matches_cpu(cuda, mode, rays):
    """trace's backward on the card (kernel C in trace()'s modes, then D)
    against the CPU's plain versions, max-normalised 2e-3, and bitwise
    repeatable."""
    from threedgrut_tpu_torch.render.grt import trace

    accelerate, srt = TRACE[mode]
    counter = ("launches_shared_segment" if not accelerate
               else "launches_window128" if srt else "launches_general")
    grads = []
    for dev in (cuda, cuda, torch.device("cpu")):
        model = bench_cloud(3000, seed=4, device=dev)
        ro, rd, kw = TRACE_RAYS[rays](model, 32)
        before = getattr(rasterize_tiles_backward, counter)
        out = trace(model, ro, rd, accelerate=accelerate, _sorted=srt, **kw)
        (out["pred_features"].square().mean()
         + 0.1 * out["pred_opacity"].mean()
         + 0.01 * out["pred_dist"].mean()).backward()
        step = 1 if dev.type == "cuda" else 0
        assert getattr(rasterize_tiles_backward, counter) == before + step
        grads.append({k: getattr(model, k).grad.cpu() for k in (
            "positions", "rotation", "scale", "density", "features_albedo",
            "features_specular")})
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k])
        r = grads[2][k]
        scale = float(r.abs().max()) + 1e-12
        torch.testing.assert_close(g / scale, r / scale, atol=2e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("accelerate", [False, True])
def test_trace_kbuffer_overflow_matches_plain(cuda, accelerate):
    """Rays down a column of faint particles accept more candidates in a
    window than the k-buffer of trace's B and C holds (up to 128): their
    extra passes run (the kernels' overflow count grows) and trace's
    outputs and gradients still match the CPU's plain versions (1e-4;
    2e-3 max-normalised), the gradients bitwise repeatable."""
    from threedgrut_tpu_torch.ops.cuda.raster import window_overflows
    from threedgrut_tpu_torch.render.grt import trace

    kw = dict(accelerate=accelerate)
    if accelerate:
        kw.update(grid_dims=4, max_cells=64, cell_cap=512)
    outs, grads = [], []
    window_overflows(reset=True)
    for dev in (cuda, cuda, torch.device("cpu")):
        model = faint_column(device=dev)
        ro, rd = column_rays(device=dev)
        out = trace(model, ro, rd, sh_degree=0, **kw)
        (out["pred_features"].square().mean()
         + 0.1 * out["pred_opacity"].mean()).backward()
        outs.append({k: v.detach().cpu() for k, v in out.items()})
        grads.append({k: getattr(model, k).grad.cpu() for k in (
            "positions", "rotation", "scale", "density", "features_albedo")})
    over = window_overflows(reset=True)
    assert over["raster_fwd"] > 0 and over["raster_bwd"] > 0, over
    assert float(outs[2]["hits_count"].max()) > 128
    for k in ("pred_features", "pred_opacity"):
        torch.testing.assert_close(outs[0][k], outs[2][k], atol=1e-4, rtol=0)
    torch.testing.assert_close(outs[0]["pred_dist"], outs[2]["pred_dist"],
                               atol=1e-3, rtol=1e-3)
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k])
        r = grads[2][k]
        scale = float(r.abs().max()) + 1e-12
        torch.testing.assert_close(g / scale, r / scale, atol=2e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["shared", "general", "grt"])
def test_normals_raster_fwd_matches_plain(cuda, mode):
    """The normals mode of kernel B through render_gut (shared origin, a
    rolling-shutter-free general view, sorted 3DGRT) against plain."""
    rc = (grt_raster_config() if mode == "grt" else RC).replace(
        enable_normals=True)
    model = bench_cloud(4000, seed=1, device=cuda)
    cam = make_pinhole((200, 224), (220.0, 220.0), (100.0, 112.0),
                       device=cuda)
    rays = None
    if mode == "general":
        from threedgrut_tpu_torch.render.common import camera_rays_world
        rays = camera_rays_world(cam)
    with torch.no_grad():
        v = prepare_view(cam, UTConfig(), rc, model, 3, rays)
    b = v.binning
    args = (v.table, b.pair_particle, b.tile_start, v.ray_d, v.tmin, v.tmax,
            rc, v.ray_o)
    before = rasterize_tiles.launches_normals
    got = rasterize_tiles_forward(*args)
    assert rasterize_tiles.launches_normals == before + 1
    ref = rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == 6
    for i in (0, 1):           # features, opacity
        torch.testing.assert_close(got[i], ref[i], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[5], ref[5], atol=3e-4, rtol=0)


# kernels F, G and H, and the table-gradient raster route (B, C, F)

@pytest.mark.gpu
@pytest.mark.parametrize("width", [16, 11, 3])
def test_scatter_rows_matches_plain_and_sequential(cuda, width):
    """Kernel F against its float64 plain version (1e-6 of max), bit for
    bit against a sequential fp32 sum in pair order (np.add.at), and
    bitwise repeatable."""
    rng = np.random.default_rng(width)
    p, n_rows = 50_000, 4_000
    rows = rng.normal(size=(p, width)).astype(np.float32)
    ids = rng.integers(0, n_rows, p).astype(np.int32)
    ids[:300] = 7                  # one long run
    d, i = torch.from_numpy(rows).to(cuda), torch.from_numpy(ids).to(cuda)
    before = scatter_runs.launches
    got = scatter_accumulate_rows(d, i, n_rows)
    again = scatter_accumulate_rows(d, i, n_rows)
    assert scatter_runs.launches == before + 2
    ref = scatter_accumulate_rows_plain(d, i, n_rows)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, atol=1e-6 * float(ref.abs().max()),
                               rtol=0)
    seq = np.zeros((n_rows, width), np.float32)
    np.add.at(seq, ids, rows)
    assert torch.equal(got.cpu(), torch.from_numpy(seq))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ADVERSARIAL_IDS)
@pytest.mark.parametrize("width", [16, 11])
def test_scatter_rows_adversarial_ids_equal_sequential(cuda, case, width):
    """Kernel F with its counting-sort set-up on adversarial ids (one id
    owning 5,000 pairs, all distinct, out of range, none): bit for bit
    the sequential fp32 np.add.at; the set-up's runs hold the stable
    sort's pairs (in any order); one launch each of the set-up and F."""
    ids, n_rows = adversarial_ids(case)
    rows = np.random.default_rng(width).normal(
        size=(ids.shape[0], width)).astype(np.float32)
    d, i = torch.from_numpy(rows).to(cuda), torch.from_numpy(ids).to(cuda)
    before = (id_runs.launches, scatter_runs.launches)
    got = scatter_accumulate_rows(d, i, n_rows)
    assert (id_runs.launches, scatter_runs.launches) == (before[0] + 1,
                                                         before[1] + 1)
    keep = (ids >= 0) & (ids < n_rows)
    seq = np.zeros((n_rows, width), np.float32)
    np.add.at(seq, ids[keep], rows[keep])
    assert torch.equal(got.cpu(), torch.from_numpy(seq))
    perm, row_start = id_runs(i, n_rows)
    ref_perm, ref_start = id_runs_plain(i, n_rows)
    assert torch.equal(row_start - row_start[0], ref_start - ref_start[0])
    placed = perm[:int(row_start[-1])].cpu()
    ref_placed = ref_perm[int(ref_start[0]):int(ref_start[-1])].cpu()
    starts = row_start.cpu().tolist()
    for r in range(n_rows):
        a, b = starts[r], starts[r + 1]
        assert torch.equal(placed[a:b].sort().values,
                           ref_placed[a:b].sort().values)
    for a in kernel_attributes().values():
        assert a["local_bytes"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["3dgut", "grt"])
def test_table_route_matches_fold_route(cuda, mode):
    """rasterize_tiles_table (B, C, then F) against rasterize_tiles (B, C,
    then D) on the card: the same image, table gradients within 1e-5 of
    max; F launched once and D never on the table route."""
    rc = RC if mode == "3dgut" else SORTED["grt"]
    v = _view(cuda, rc=rc)
    b = v.binning
    g_feat, g_opac, g_dep = _upstream(v)
    grads, outs = [], []
    for table_route in (True, False):
        t = v.table.detach().clone().requires_grad_(True)
        before = (scatter_runs.launches, fold_pairs.launches)
        args = (t, b.pair_particle, b.tile_start, v.ray_d, v.tmin, v.tmax, rc)
        out = (rasterize_tiles_table(*args) if table_route else
               rasterize_tiles(*args, FoldMeta(b.perm, b.order, b.excl,
                                               b.counts, b.limit)))
        ((out[0] * g_feat).sum() + (out[1] * g_opac).sum()
         + (out[2] * g_dep).sum()).backward()
        step = (1, 0) if table_route else (0, 1)
        assert (scatter_runs.launches - before[0],
                fold_pairs.launches - before[1]) == step
        grads.append(t.grad)
        outs.append(out)
    torch.cuda.synchronize()
    for a, c in zip(*outs):
        assert torch.equal(a, c)
    scale = float(grads[1].abs().max())
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5 * scale, rtol=0)


def _intervals(counts, length, device):
    offsets = torch.cumsum(counts, 0)
    starts = torch.clamp(offsets - counts, max=length).to(torch.int32)
    ends = torch.clamp(offsets, max=length).to(torch.int32)
    return starts.to(device), ends.to(device)


def _off_grid(t):
    """t's values in a view 4 bytes (a bool's 1 byte) past an allocation's
    start: off the 16-byte grid of float4 rows and the 4-byte grid of
    packed marks."""
    flat = torch.cat([t.new_zeros(1), t.flatten()])[1:]
    return flat.view(t.shape)


# kernel G's cases: (sources, width, hi), each interval randint(0, hi)
# slots long; the buffer cuts 50 slots off the end unless the case sets
# its length
EXPAND_CASES = {
    "pairs": (20_000, 16, 12),    # the pair expansion's shape
    "tiles": (600, 3, 400),       # the tile intervals'
    "width1": (5_000, 1, 12),
    "width4": (5_000, 4, 12),
    "width7": (5_000, 7, 12),
    "width12": (5_000, 12, 12),
    "long": (40, 16, 30),         # one interval spans several blocks
    "empty_run": (8_000, 4, 12),  # 3,000 empty intervals at one slot
    "no_sources": (0, 16, 1),
    "one_slot": (300, 16, 12),    # length 1
    "ragged": (2_000, 16, 12),    # 5 blocks and 7 slots
    "misaligned": (5_000, 16, 12),  # rows not 16-byte aligned
    "wide": (300, 257, 12),       # a row wider than the block
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(EXPAND_CASES))
def test_expand_rows_matches_plain(cuda, shape):
    """Kernel G equal to its plain version: many short intervals (the pair
    expansion's shape, 16 wide, with ids up to 2^24 and a denormal) and
    few long ones (the tile intervals', 3 wide), the last cut by the
    buffer; float4 and float rows (widths 1-16, 16-wide rows off the
    16-byte grid, and 257 wide); an interval longer than a block; a run of empty
    intervals at one slot, more than a block stages; no source; one
    slot; a length off the block span."""
    g = torch.Generator().manual_seed(5)
    k, d, hi = EXPAND_CASES[shape]
    counts = torch.randint(0, hi, (k,), generator=g)
    if shape == "long":
        counts[7] = 5_000
    if shape == "empty_run":
        counts[1_000:4_000] = 0
    length = max(int(counts.sum()) - 50, 1)
    length = {"no_sources": 777, "one_slot": 1,
              "ragged": 5 * 1024 + 7}.get(shape, length)
    rows = torch.randn((k, d), generator=g)
    if k:
        rows[:, 0] = torch.randint(0, 1 << 24, (k,), generator=g).float()
        rows[0, 1 % d] = 1e-40
    starts, ends = _intervals(counts, length, cuda)
    rows = rows.to(cuda)
    if shape == "misaligned":
        rows = _off_grid(rows)
        assert rows.data_ptr() % 16
    before = expand_sorted_rows.launches
    got = expand_sorted_rows(rows, starts, ends, length)
    assert expand_sorted_rows.launches == before + 1
    ref = expand_sorted_rows_plain(rows, starts, ends, length)
    torch.cuda.synchronize()
    assert got.shape == (length, d)
    assert torch.equal(got, ref)


# kernel H's cases beside "mixed": (length, width, marks)
FILL_CASES = {
    "width1": (300_001, 1, "sparse"),
    "width12": (300_001, 12, "sparse"),
    "width16": (300_001, 16, "sparse"),
    "far_carry": (1_100 * 1024 + 3, 1, "first10"),  # 1,100 spans back
    "first_only": (20_000, 7, "first"),
    "no_marks": (20_000, 7, "none"),
    "short": (300, 16, "sparse"),                    # under one block
    "misaligned": (100_003, 12, "sparse"),           # marks and rows
    "wide": (5_000, 257, "sparse"),                  # wider than the block
}


def _fill_case(case, g, cuda):
    """(vals, marked, row_vals, row_slots, length) of a FILL_CASES case:
    the segmented fill's rows sit at the marks (shuffled; where there are
    30 or more, the last ten share a slot with the first ten and five lie
    past the end)."""
    length, d, marks = FILL_CASES[case]
    vals = torch.randn((length, d), generator=g)
    marked = torch.zeros(length, dtype=torch.bool)
    if marks == "sparse":
        marked = torch.rand(length, generator=g) < 0.01
    elif marks == "first10":
        marked[10] = True
    elif marks == "first":
        marked[0] = True
    pos = torch.nonzero(marked).flatten()
    pos = pos[torch.randperm(pos.numel(), generator=g)].to(torch.int32)
    if pos.numel() >= 30:
        pos[-10:] = pos[:10]
        pos[10:15] += length
    row_vals = torch.randn((pos.numel(), d), generator=g)
    vals, marked, row_vals = (t.to(cuda) for t in (vals, marked, row_vals))
    if case == "misaligned":
        vals, marked, row_vals = map(_off_grid, (vals, marked, row_vals))
        assert vals.data_ptr() % 16 and marked.data_ptr() % 4
    return vals, marked, row_vals, pos.to(cuda), length


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mixed"] + sorted(FILL_CASES))
def test_fill_matches_plain(cuda, case):
    """Kernel H equal to its plain versions: forward_fill over blocks whose
    carry spans several empty blocks, and segmented_fill_rows with slots
    shared by several rows (the last in input order wins) and slots past
    the end; a negative slot raises ("mixed"). The other cases: widths 1,
    12, 16 and 257 (float and float4 rows), one mark whose carry reaches
    1,100 spans on, only the first slot marked, no mark (and no row), a length
    under one block, and marks and rows off the 4- and 16-byte grid."""
    g = torch.Generator().manual_seed(6)
    if case == "mixed":
        length, d = 300_001, 7
        vals = torch.randn((length, d), generator=g).to(cuda)
        marked = torch.rand(length, generator=g) < 1e-4
        marked[50_000:120_000] = False
        marked = marked.to(cuda)
        n = 5_000
        slots = torch.randint(0, length + 10, (n,), generator=g,
                              dtype=torch.int32)
        slots[100:200] = 77            # one slot, many rows
        row_vals = torch.randn((n, d), generator=g).to(cuda)
        slots = slots.to(cuda)
    else:
        vals, marked, row_vals, slots, length = _fill_case(case, g, cuda)
    before = forward_fill.launches
    got = forward_fill(vals, marked)
    got_rows = segmented_fill_rows(row_vals, slots, length)
    assert forward_fill.launches == before + 2
    ref = forward_fill_plain(vals, marked)
    ref_rows = segmented_fill_rows_plain(row_vals, slots, length)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got_rows, ref_rows)
    if case == "mixed":
        assert torch.equal(got_rows[77], row_vals[199])
        slots[0] = -1
        with pytest.raises(ValueError, match="negative slot"):
            segmented_fill_rows(row_vals, slots, length)
    elif case == "far_carry":
        assert torch.equal(got[-1], vals[10])
    elif case == "no_marks":
        assert not got.any() and not got_rows.any()


@pytest.mark.gpu
def test_layout_ops_refuse_rows_past_int_range(cuda):
    """Kernels G and H index a block's output in 32 bits: rows of 2^21
    floats or more (1,024 slots x 2^21 reach 2^31) are refused, not
    written past."""
    rows = torch.zeros((1, 1 << 21), device=cuda)
    bounds = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        expand_sorted_rows(rows, bounds, bounds + 1, 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        forward_fill(rows, torch.ones(1, dtype=torch.bool, device=cuda))
    with pytest.raises(RuntimeError, match="launch failed"):
        segmented_fill_rows(rows, bounds, 1)


# ---- kernel C's RGB modes and NHT kernel B on hand-built tiles ----


def _tile_rays(device, tiles_x=1, general=False):
    """Rays of a 16 x (16 tiles_x) pinhole image from the origin down +z
    (focal 16): directions [16, W, 3] (unit), t-ranges, and in the general
    mode per-pixel origins (the origin plus 1e-3 per pixel column)."""
    w = 16 * tiles_x
    ys, xs = torch.meshgrid(torch.arange(16.0), torch.arange(float(w)),
                            indexing="ij")
    d = torch.stack([(xs + 0.5 - w / 2) / 16.0, (ys + 0.5 - 8.0) / 16.0,
                     torch.ones_like(xs)], -1)
    d = (d / d.norm(dim=-1, keepdim=True)).to(device)
    tmin = torch.zeros((16, w), device=device)
    tmax = torch.full((16, w), 1e4, device=device)
    o = None
    if general:
        o = torch.zeros_like(d)
        o[..., 0] = 1e-3 * torch.arange(float(w), device=device)
    return d, tmin, tmax, o


def _records(p, s, density, rgb, general=False):
    """Table rows of axis-aligned particles at p [N, 3] with scales s
    [N, 3]: a = M (0 - p) with M = diag(1 / s) (the shared origin at 0)
    or, ``general``, p itself; then M, density, rgb."""
    m = torch.diag_embed(1.0 / s)
    first = p if general else torch.einsum("nij,nj->ni", m, -p)
    return torch.cat([first, m.reshape(-1, 9), density[:, None], rgb],
                     -1).float().contiguous()


def _c_agrees(cuda, rc, table, pair_particle, tile_start, d, tmin, tmax,
              o=None, shared=False, seed=0):
    """Kernel C on the tiles against the float64 plain version per field
    group (cosine >= 0.9999, relative L2 <= 1e-3, the tests above), two
    runs bitwise equal; returns (C's rows, B's outputs)."""
    fwd = rasterize_tiles_forward(table, pair_particle, tile_start, d, tmin,
                                  tmax, rc, o, shared)
    g = torch.Generator(device=cuda).manual_seed(seed)
    h, w = d.shape[:2]
    up = [torch.randn((h, w, c), generator=g, device=cuda) for c in (3, 1, 1)]
    args = (table, pair_particle, tile_start, d, tmin, tmax, fwd[0], fwd[2],
            fwd[4], *up, rc, o, shared)
    got = rasterize_tiles_backward(*args)
    again = rasterize_tiles_backward(*args)
    ref = rasterize_tiles_backward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for sl in (slice(0, 3), slice(3, 12), slice(12, 13), slice(13, 16)):
        x, y = got[:, sl].double().flatten(), ref[:, sl].double().flatten()
        if float(y.norm()) == 0.0:
            assert float(x.norm()) == 0.0
            continue
        assert float(x @ y / (x.norm() * y.norm())) >= 0.9999
        assert float((x - y).norm() / y.norm()) <= 1e-3
    return got, fwd


def _near_pixel(d, y, x, depth):
    """A point 0.03 to the side of pixel (y, x)'s ray at ``depth`` (off
    the ray, so c = a x b keeps its digits)."""
    p = depth * d[y, x].cpu().double() / d[y, x, 2].cpu().double()
    return p + torch.tensor([0.03, 0.0, 0.0], dtype=torch.float64)


@pytest.mark.gpu
@pytest.mark.parametrize("general", [False, True])
def test_raster_bwd_one_pixel_in_a_warp(cuda, general):
    """A tile where one warp has a single composited pixel: one small
    particle by pixel (3, 5)'s ray (0.6 sigma off it, 6 sigma off its
    neighbours'), the rest of the tile's 40 pairs off to the side of
    every ray; only that pair's row is written."""
    d, tmin, tmax, o = _tile_rays(cuda, general=general)
    rng = np.random.default_rng(0)
    p = torch.tensor(rng.uniform(-40, 40, (40, 3)) + [0, 0, 60.0])
    p[:, 0] = torch.where(p[:, 0] < 0, p[:, 0] - 80, p[:, 0] + 80)
    p[17] = _near_pixel(d, 3, 5, 5.0)
    s = torch.full((40, 3), 0.5, dtype=torch.float64)
    s[17] = 0.05
    table = _records(p, s, torch.full((40,), 0.8), torch.rand(40, 3).double(),
                     general=general).to(cuda)
    pp = torch.arange(40, dtype=torch.int32, device=cuda)
    ts = torch.tensor([0, 40], dtype=torch.int32, device=cuda)
    got, fwd = _c_agrees(cuda, RC, table, pp, ts, d, tmin, tmax, o)
    assert int((fwd[3] > 0).sum()) == 1 and float(fwd[3][3, 5]) == 1.0
    touched = got.abs().sum(-1) > 0
    assert touched.tolist() == [i == 17 for i in range(40)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["3dgut", "grt"])
def test_raster_bwd_tile_dies_early(cuda, mode):
    """A tile whose pixels all die in its first 16 pairs (wide particles of
    alpha ~0.9 one behind the other), with 600 pairs behind them: C leaves
    at the kill and the later rows keep their zeros."""
    rc = {"3dgut": RC, "grt": SORTED["grt"]}[mode]
    d, tmin, tmax, _ = _tile_rays(cuda)
    n = 620
    z = torch.arange(n, dtype=torch.float64) * 0.05 + 5.0
    p = torch.stack([torch.zeros(n, dtype=torch.float64),
                     torch.zeros(n, dtype=torch.float64), z], -1)
    s = torch.full((n, 3), 20.0, dtype=torch.float64)
    table = _records(p, s, torch.full((n,), 0.9), torch.rand(n, 3).double()
                     ).to(cuda)
    pp = torch.arange(n, dtype=torch.int32, device=cuda)
    ts = torch.tensor([0, n], dtype=torch.int32, device=cuda)
    got, fwd = _c_agrees(cuda, rc, table, pp, ts, d, tmin, tmax)
    assert float(fwd[3].max()) <= 16
    assert float(got[16:].abs().sum()) == 0.0
    assert float(got[:4].abs().sum()) > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["3dgut", "grt", "sorted3dgut"])
def test_raster_bwd_tile_spans_three_batches(cuda, mode):
    """A tile of 700 faint particles over its pixels (three batches of 256
    pairs): every pixel lives through all of them."""
    rc = {"3dgut": RC, **SORTED}[mode]
    d, tmin, tmax, _ = _tile_rays(cuda)
    n = 700
    rng = np.random.default_rng(1)
    z = np.sort(rng.uniform(5.0, 30.0, n))
    xy = rng.uniform(-0.5, 0.5, (n, 2)) * z[:, None]
    p = torch.tensor(np.concatenate([xy, z[:, None]], -1))
    s = torch.tensor(rng.uniform(0.2, 1.0, (n, 3)))
    table = _records(p, s, torch.full((n,), 0.03),
                     torch.tensor(rng.uniform(0, 1, (n, 3)))).to(cuda)
    pp = torch.arange(n, dtype=torch.int32, device=cuda)
    ts = torch.tensor([0, n], dtype=torch.int32, device=cuda)
    got, fwd = _c_agrees(cuda, rc, table, pp, ts, d, tmin, tmax)
    assert float(fwd[4].min()) > rc.min_transmittance
    assert float(got[512:].abs().sum()) > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["grt", "sorted3dgut"])
@pytest.mark.parametrize("general", [False, True])
def test_sorted_raster_bwd_windows_cut_by_tiles(cuda, mode, general):
    """Three tiles of [0, 5), [5, 37) and [37, 50) pairs, so windows of 16
    on the global pair index are cut by each tile's start and end, and 10
    culled pairs past the last tile: each tile's rows agree with the plain
    version and the culled rows stay zero."""
    rc = SORTED[mode]
    d, tmin, tmax, o = _tile_rays(cuda, tiles_x=3, general=general)
    rng = np.random.default_rng(2)
    bounds = [0, 5, 37, 50]
    rows = []
    for t in range(3):
        n = bounds[t + 1] - bounds[t]
        z = rng.uniform(5.0, 12.0, n)    # unsorted: the windows sort them
        x = (rng.uniform(-0.5, 0.5, n) + (t - 1)) * z
        y = rng.uniform(-0.5, 0.5, n) * z
        rows.append(np.stack([x, y, z], -1))
    p = torch.tensor(np.concatenate(rows + [rng.uniform(-3, 3, (10, 3))
                                            + [0, 0, 8.0]]))
    s = torch.tensor(rng.uniform(0.3, 1.5, (60, 3)))
    table = _records(p, s, torch.full((60,), 0.5),
                     torch.tensor(rng.uniform(0, 1, (60, 3))),
                     general=general).to(cuda)
    pp = torch.arange(60, dtype=torch.int32, device=cuda)
    ts = torch.tensor(bounds, dtype=torch.int32, device=cuda)
    got, _ = _c_agrees(cuda, rc, table, pp, ts, d, tmin, tmax, o)
    assert float(got[50:].abs().sum()) == 0.0
    for t in range(3):
        assert float(got[bounds[t]:bounds[t + 1]].abs().sum()) > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("sort", [False, True])
def test_raster_bwd_degree4_alpha_clamped(cuda, sort):
    """Degree 4 with alpha clamped at max_alpha (dense particles whose
    centres reach alpha_raw > 0.99): no alpha gradient there, so their
    density rows come from the unclamped pixels alone."""
    rc = SORTED["grt"].replace(sorted_compositing=sort)
    d, tmin, tmax, _ = _tile_rays(cuda)
    n = 48
    rng = np.random.default_rng(3)
    z = np.sort(rng.uniform(5.0, 20.0, n))
    xy = rng.uniform(-0.4, 0.4, (n, 2)) * z[:, None]
    p = torch.tensor(np.concatenate([xy, z[:, None]], -1))
    s = torch.tensor(rng.uniform(0.5, 2.0, (n, 3)))
    table = _records(p, s, torch.full((n,), 5.0),
                     torch.tensor(rng.uniform(0, 1, (n, 3)))).to(cuda)
    pp = torch.arange(n, dtype=torch.int32, device=cuda)
    ts = torch.tensor([0, n], dtype=torch.int32, device=cuda)
    got, fwd = _c_agrees(cuda, rc, table, pp, ts, d, tmin, tmax)
    # some composited hits were clamped: their opacity reached max_alpha
    assert float(fwd[1].max()) >= rc.max_alpha


@pytest.mark.gpu
def test_raster_bwd_shared_segment_global_order(cuda):
    """The general W 0 shared-segment mode (trace()'s brute force in rank
    order): every block walks one segment and writes its rows at t n + j;
    against the plain version, bitwise repeatable."""
    from threedgrut_tpu_torch.render.grt import prepare_trace

    model = bench_cloud(3000, seed=3, device=cuda)
    ro, rd = _trace_rays(model, 48)
    inp = prepare_trace(model, ro, rd, accelerate=False, _sorted=False)
    a = inp.args()
    assert inp.shared and not inp.cfg.sorted_compositing
    before = rasterize_tiles_backward.launches_shared_segment
    _c_agrees(cuda, inp.cfg, a[0].detach(), *a[1:6], inp.ray_o, True)
    assert rasterize_tiles_backward.launches_shared_segment == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [9000.0, 2.0 ** 21])
def test_nht_raster_fwd_far_blends(cuda, shift):
    """Kernel B in the NHT mode with half the particles' control features
    moved by ``shift`` (the blends move by as much): 9,000 takes the fast
    sine's Cody-Waite step far from [-pi, pi], 2^21 the accurate sincosf
    past kTrigFastMax (2^20). Opacity, depth, hits and T_final equal B's
    on the unmoved table bit for bit; bitwise repeatable; the features
    against the float64 plain version at 9,000: cosine >= 0.999 and
    relative L2 <= 1e-2 (a float32 blend near 9,000 carries ~5e-4 of
    rounding, test_nht_raster_bwd_far_blends_match_plain's tolerances).
    At 2^21 a float32 blend's own rounding (ulp 0.25, and its barycentric
    weights' times 2^21) leaves no digit of its sine to compare; each
    feature, a sum of w sin or w cos, stays within sum w = 1 - T."""
    rc = NHT["3dgut"]
    v = _nht_view(cuda, rc)
    b = v.binning
    table = v.table.clone()
    table[::2, 13:61] += shift
    args = (table, b.pair_particle, b.tile_start, v.ray_d, v.tmin, v.tmax,
            rc, v.ray_o)
    got = rasterize_tiles_forward(*args)
    again = rasterize_tiles_forward(*args)
    base = rasterize_tiles_forward(v.table, *args[1:])
    ref = rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    for i in (1, 2, 3, 4):
        assert torch.equal(got[i], base[i])
    assert bool(torch.isfinite(got[0]).all())
    if shift < NHT_TRIG_FAST_MAX:
        x, y = got[0].double().flatten(), ref[0].double().flatten()
        assert float(x @ y / (x.norm() * y.norm())) >= 0.999
        assert float((x - y).norm() / y.norm()) <= 1e-2
    else:
        assert bool((got[0].abs().amax(-1) <= (1.0 - got[4][..., 0])
                     * (1.0 + 1e-5) + 1e-6).all())


@pytest.mark.gpu
def test_redesigned_kernels_resources(cuda):
    """Kernel C's RGB modes and kernel B's NHT mode fit three blocks an SM:
    <= 80 registers, and the shared memory of three within the SM's
    228 KB."""
    rgb = rgb_kernel_attributes()
    assert len(rgb) == 9
    for a in list(rgb.values()) + list(nht_fwd_kernel_attributes().values()):
        assert a["registers"] <= 80
        shared = a["shared_bytes"] + a["dynamic_shared_bytes"]
        assert 0 < shared <= 227 * 1024 // 3


# ---- kernels B and E in their eight RGB modes (the per-warp cull) ----

# (degree, window, general): launch_mode's eight modes
RGB_MODES = [(deg, win, gen) for deg in (2, 4) for win in (0, 16)
             for gen in (False, True)]


def _rgb_mode_args(device, deg, win, gen):
    """B's and E's arguments of one RGB mode on a 200x224 view (partial
    tiles at the bottom): the pinhole (shared origin) or per-pixel origins
    (the general mode), min_transmittance 1e-3 at degree 4 (3DGRT's)."""
    rc = RasterConfig(kernel_degree=deg, sorted_compositing=win > 0,
                      sort_window=16,
                      min_transmittance=1e-3 if deg == 4 else 1e-4)
    v = _general_view(device, rc) if gen else _view(device, rc=rc)
    return (v.table, v.binning.pair_particle, v.binning.tile_start, v.ray_d,
            v.tmin, v.tmax, rc, v.ray_o)


@pytest.mark.gpu
@pytest.mark.parametrize("deg,win,gen", RGB_MODES)
def test_rgb_modes_of_b_and_e_match_plain(cuda, deg, win, gen):
    """B (features, opacity and T_final within 1e-4, depth 1e-3, hits on
    99% of pixels) and E (within 1e-6, bitwise repeatable) against their
    plain versions in each RGB mode, and the plain version that rejects
    what the kernels' cull drops equal to the one that tests every pair;
    one launch each in the mode's counter."""
    args = _rgb_mode_args(cuda, deg, win, gen)
    counter = "launches_general" if gen else "launches"
    before = getattr(rasterize_tiles, counter)
    got = rasterize_tiles_forward(*args)
    assert getattr(rasterize_tiles, counter) == before + 1
    ref = rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    for i in (0, 1, 4):        # features, opacity, T_final
        torch.testing.assert_close(got[i], ref[i], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=1e-3, rtol=1e-3)
    assert (got[3] != ref[3]).float().mean() < 0.01
    assert float(got[1].mean()) > 0.05
    culled = rasterize_tiles_plain(*args, cull=True)
    for x, y in zip(culled, ref):
        assert torch.equal(x, y)
    w1 = pair_weight_max(*args)
    w2 = pair_weight_max(*args)
    w_ref = pair_weight_max_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(w1, w2)
    torch.testing.assert_close(w1, w_ref, atol=1e-6, rtol=0)
    assert float(w1.max()) > 0.1
    assert cull_plain(*args)["culled_accepted"] == 0


@pytest.mark.gpu
def test_rgb_b_kernel_resources(cuda):
    """Kernel B's eight RGB instantiations: no spills past their stack,
    and the static shared memory of four blocks within the SM's 228 KB."""
    att = rgb_kernel_attributes("raster_fwd")
    assert len(att) == 8
    for a in att.values():
        assert 0 < a["registers"] <= 255
        assert 0 < a["shared_bytes"] <= 227 * 1024 // 4


@pytest.mark.gpu
@pytest.mark.parametrize("width", [16 + 4 * 8, 16 + 4 * 16])
def test_nht_kernels_refuse_other_feature_widths(cuda, width):
    """The NHT kernels are built for 12 control features a vertex (64-float
    records): B and C refuse another width on the card (the plain
    versions take any)."""
    v = _general_view(cuda)
    n = v.table.shape[0]
    table = torch.zeros((n, width), device=cuda)
    table[:, :13] = v.table[:, :13]
    b = v.binning
    args = (table, b.pair_particle, b.tile_start, v.ray_d, v.tmin, v.tmax,
            RC, v.ray_o)
    with pytest.raises(NotImplementedError, match="built for 64"):
        rasterize_tiles_forward(*args)
    h, w = v.ray_d.shape[:2]
    f = (width - 16) // 2
    zeros = [torch.zeros((h, w, c), device=cuda) for c in (f, 1, 1, f, 1, 1)]
    with pytest.raises(NotImplementedError, match="built for 64"):
        rasterize_tiles_backward(table, b.pair_particle, b.tile_start,
                                 v.ray_d, v.tmin, v.tmax, *zeros, RC,
                                 v.ray_o)


# kernel A's adversarial runs on an 800x800 view's 50 x 50 tiles: one
# particle over the whole image (a run of 2,500 slots) among small ones;
# runs cut by max_pairs inside the long run; and zero-count ranks
# interleaved, at the start and end of the kernel's rank chunks
A_CASES = ("whole_image", "max_pairs_cut", "zero_counts")


def _decode_inputs(device, case, n=700, grid=(50, 50)):
    """(rows, order, excl, counts, limit) of ``case`` (A_CASES)."""
    rng = np.random.default_rng(11)
    gx, gy = grid
    lo_x = rng.integers(0, gx, n)
    lo_y = rng.integers(0, gy, n)
    w = np.minimum(rng.integers(1, 6, n), gx - lo_x)
    h = np.minimum(rng.integers(1, 6, n), gy - lo_y)
    cx = (lo_x + w / 2) * 16 + rng.normal(0, 8, n)
    cy = (lo_y + h / 2) * 16 + rng.normal(0, 8, n)
    a = rng.uniform(1e-4, 2e-2, n)
    c = rng.uniform(1e-4, 2e-2, n)
    b = rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c)
    max_power = rng.uniform(0.5, 6.0, n)
    # the whole image: particle 0, a wide conic culling the corners
    lo_x[0], lo_y[0], w[0], h[0] = 0, 0, gx, gy
    cx[0], cy[0], a[0], c[0], b[0], max_power[0] = 400, 400, 1e-4, 1.5e-4, 0, 5
    counts = (w * h).astype(np.int64)
    order = rng.permutation(n)
    order = np.concatenate([[0], order[order != 0]])   # the long run first
    if case == "zero_counts":
        order = rng.permutation(n)
        counts[rng.random(n) < 0.5] = 0
        counts[order[[0, 127, 128, 255, 256, n - 1]]] = 0
        counts[1] = gx * gy
        lo_x[1], lo_y[1], w[1], h[1] = 0, 0, gx, gy
    cnt = counts[order]
    excl = np.cumsum(cnt) - cnt
    limit = int(cnt.sum())
    if case == "max_pairs_cut":
        limit = 1_234        # inside the 2,500-slot run
    rows = np.stack([lo_x, lo_y, w, a, b, c, cx, cy, max_power],
                    axis=1).astype(np.float32)
    t = lambda x: torch.tensor(x.astype(np.int32), device=device)
    return (torch.tensor(rows, device=device), t(order), t(excl), t(cnt),
            limit)


@pytest.mark.gpu
@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("case", A_CASES)
def test_bin_decode_adversarial_runs_equal_plain(cuda, case, cull):
    """Kernel A on long runs, runs cut by the buffer and zero-count ranks:
    pair_tile and pair_particle equal to the plain version, with the
    conic cull on and off."""
    rows, order, excl, counts, limit = _decode_inputs(cuda, case)
    before = expand_decode_pairs.launches
    got = expand_decode_pairs(rows, order, excl, counts, limit, (50, 50),
                              cull)
    assert expand_decode_pairs.launches == before + 1
    ref = expand_decode_pairs_plain(rows, order, excl, counts, limit,
                                    (50, 50), cull)
    torch.cuda.synchronize()
    assert got[0].shape == (limit,)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    culled = int((got[0] == 2500).sum())
    assert (culled > 0) == cull


def _fold_runs(device, width, seed, n=3000, long_run=5000):
    """(d_records, perm, inv_perm, order, excl, counts, limit, n_valid) of
    random runs with one of ``long_run`` slots, a third of the ranks with
    none, and the last 15% of the tile-sorted rows culled (random rows
    there all the same: n_valid must keep them out)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 12, n)
    counts[rng.random(n) < 0.33] = 0
    counts[n // 3] = long_run
    limit = int(counts.sum())
    perm = rng.permutation(limit).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(limit, dtype=np.int32)
    t = lambda x: torch.tensor(x.astype(np.int32), device=device)
    d = torch.tensor(rng.normal(size=(limit, width)).astype(np.float32),
                     device=device)
    n_valid = torch.tensor(int(limit * 0.85), dtype=torch.int32,
                           device=device)
    return (d, t(perm), t(inv), t(rng.permutation(n)),
            t(np.cumsum(counts) - counts), t(counts), limit, n_valid)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [16, 64])
def test_fold_adversarial_runs_match_plain(cuda, width):
    """Kernel D on a 5,000-slot run (folded by the warp: runs past four
    batches of a rank's lanes),
    zero-count ranks and culled rows (n_valid): within 1e-5 of max of
    the float64 plain version, bitwise repeatable, the same through the
    inverse as through perm (D's own inversion); every row without
    n_valid."""
    d, perm, inv, order, excl, counts, limit, nv = _fold_runs(cuda, width,
                                                              width)
    cap = order.shape[0]
    counter = "launches" if width == 16 else "launches_wide"
    before = (getattr(fold_pairs, counter), invert_permutation.launches)
    got = fold_pairs(d, perm, order, excl, counts, limit, cap, None, nv)
    assert (getattr(fold_pairs, counter), invert_permutation.launches) == (
        before[0] + 1, before[1] + 1)
    again = fold_pairs(d, None, order, excl, counts, limit, cap, inv, nv)
    assert invert_permutation.launches == before[1] + 1
    assert torch.equal(invert_permutation(perm), inv)
    assert torch.equal(invert_permutation_plain(perm), inv)
    ref = fold_pairs_plain(d, perm, order, excl, counts, limit, cap, None,
                           nv)
    zeroed = d.clone()
    zeroed[int(nv):] = 0.0
    old = fold_pairs_plain(zeroed, perm, order, excl, counts, limit, cap)
    every = fold_pairs(d, perm, order, excl, counts, limit, cap)
    every_ref = fold_pairs_plain(d, perm, order, excl, counts, limit, cap)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(ref, old)
    for g, r in ((got, ref), (every, every_ref)):
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()))
    # the long run's particle and the zero-count ranks
    assert float(got[int(order[cap // 3])].abs().max()) > 0
    zero = order[counts == 0].long()
    assert float(got[zero].abs().max()) == 0.0


def _segment_meta(device, n_seg, cap, n_active, seed):
    from threedgrut_tpu_torch.render.grt import _segment_fold

    rng = np.random.default_rng(seed)
    order = torch.tensor(rng.permutation(cap).astype(np.int32),
                         device=device)
    return _segment_fold(order, n_active, n_seg, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [16, 64])
def test_fold_shared_segment_matches_repeat_fold(cuda, width):
    """Kernel D's shared-segment mode against repeat_fold + the plain
    fold, over 1,024 tiles of a 1,152-slot segment and over two groups of
    tiles summed in group order (the backward's tile-row groups): within
    1e-5 of max, bitwise repeatable."""
    n_seg, cap, n_active, tiles = 1152, 1100, 1050, 1024
    meta = _segment_meta(cuda, n_seg, cap, n_active, width)
    g = torch.Generator(device=cuda).manual_seed(width)
    d = torch.randn((tiles * n_seg, width), generator=g, device=cuda)
    rep = repeat_fold(meta, tiles)
    ref = fold_pairs_plain(d, rep.perm, rep.order, rep.excl, rep.counts,
                           rep.limit, cap + 1)
    args = (meta.order, meta.excl, meta.counts, meta.limit, cap + 1)
    before = fold_shared_segment.launches
    got = fold_shared_segment(d, tiles, *args)
    again = fold_shared_segment(d, tiles, *args)
    assert fold_shared_segment.launches == before + 2
    split = 384 * n_seg
    groups = (fold_shared_segment(d[:split], 384, *args)
              + fold_shared_segment(d[split:], tiles - 384, *args))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for x in (got, groups):
        torch.testing.assert_close(x, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))
    assert float(got[cap].abs().max()) == 0.0    # the dead row


@pytest.mark.gpu
def test_trace_backward_tile_row_groups_on_card(cuda, monkeypatch):
    """trace()'s brute-force backward with its blocks' rows folded in
    three tile-row groups (SHARED_BWD_BYTES cut) against one group, on
    the card: D's shared mode launches once a group; the gradients agree
    within fp32 rounding of the group sums."""
    from threedgrut_tpu_torch.ops.cuda import raster
    from threedgrut_tpu_torch.render.grt import trace

    model = bench_cloud(3000, seed=4, device=cuda)
    ro, rd = _trace_rays(model, 48)

    def grads():
        for p in model.params().values():
            p.grad = None
        out = trace(model, ro, rd, accelerate=False)
        (out["pred_features"].square().mean()
         + 0.1 * out["pred_opacity"].mean()).backward()
        return {k: p.grad.clone() for k, p in model.params().items()}

    one = grads()
    n_seg = -(-model.capacity // 128) * 128
    # 48 x 48 rays: 9 blocks as a [144, 16] image, 9 tile rows of one block
    monkeypatch.setattr(raster, "SHARED_BWD_BYTES", 3 * n_seg * 16 * 4)
    before = fold_shared_segment.launches
    three = grads()
    assert fold_shared_segment.launches == before + 3
    for k, g in one.items():
        scale = float(g.abs().max()) + 1e-30
        torch.testing.assert_close(three[k] / scale, g / scale, rtol=0,
                                   atol=1e-5)


@pytest.mark.gpu
def test_fold_meta_paths_match_old_composition(cuda):
    """The FoldMeta the port now builds against the composition it
    replaces, on the card: render_gut's binning with n_valid (random
    rows past tile_start[-1] left out) against the plain fold of the
    rows with those zeroed; the grid trace's _particle_fold (the sort's
    indices as the inverse, no perm) against the scatter-inverted perm."""
    from threedgrut_tpu_torch.render.grt import _particle_fold

    v = _view(cuda)
    b = v.binning
    g = torch.Generator(device=cuda).manual_seed(3)
    d = torch.randn((b.limit, 16), generator=g, device=cuda)
    cap = b.order.shape[0]
    got = fold_pairs(d, b.perm, b.order, b.excl, b.counts, b.limit, cap,
                     n_valid=b.num_pairs)
    zeroed = d.clone()
    zeroed[int(b.num_pairs):] = 0.0
    ref = fold_pairs_plain(zeroed, b.perm, b.order, b.excl, b.counts,
                           b.limit, cap)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    rng = np.random.default_rng(6)
    pid = torch.tensor(rng.integers(0, cap + 1, 200_000).astype(np.int32),
                       device=cuda)
    meta = _particle_fold(pid, cap)
    perm = torch.empty_like(meta.inv_perm)
    perm[meta.inv_perm.long()] = torch.arange(pid.numel(), dtype=torch.int32,
                                              device=cuda)
    d = torch.randn((pid.numel(), 16), generator=g, device=cuda)
    before = invert_permutation.launches
    got = fold_pairs(d, meta.perm, meta.order, meta.excl, meta.counts,
                     meta.limit, cap + 1, meta.inv_perm)
    assert invert_permutation.launches == before    # no inversion
    ref = fold_pairs_plain(d, perm, meta.order, meta.excl, meta.counts,
                           meta.limit, cap + 1)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


BAKE_ITERS = 8
BAKE_VIEWS = 3


@pytest.mark.gpu
@pytest.mark.parametrize("sampling", ["training", "trajectory"])
def test_bake_ppisp_steps_on_card_match_cpu(cuda, sampling):
    """export/sh_bake.py:bake_ppisp on the card against the same bake on
    the CPU (the plain versions): the targets within the forward's 1e-4,
    each step's loss within 1e-3 relative, and a render of the baked SH
    within 1e-3 (Adam moves an SH row whose gradient is ~0 by ~lr either
    way, so rows are not compared one by one). On the card each step
    launches A-D and D's inversion once, each target render A and B."""
    from threedgrut_tpu_torch.export.sh_bake import bake_ppisp
    from threedgrut_tpu_torch.models.gaussians import GaussianModel
    from threedgrut_tpu_torch.models.ppisp import init_ppisp_params
    from threedgrut_tpu_torch.synthetic import (ViewDataset, build_teacher,
                                                teacher_views)
    from threedgrut_tpu_torch.train.trainer import camera_from_batch

    views = ViewDataset(teacher_views(BAKE_VIEWS, (96, 64)))
    rng = np.random.default_rng(5)
    tables = init_ppisp_params(1, BAKE_VIEWS)
    tables["exposure"] = torch.tensor(rng.normal(size=BAKE_VIEWS) * 0.3,
                                      dtype=torch.float32)
    tables["color_latents"] = torch.tensor(
        rng.normal(size=(BAKE_VIEWS, 8)) * 0.2, dtype=torch.float32)
    tables["crf"] = torch.tensor(rng.normal(size=(1, 3, 4)) * 0.2,
                                 dtype=torch.float32)
    teacher = build_teacher(2000, seed=0)
    counters = (expand_decode_pairs, rasterize_tiles,
                rasterize_tiles_backward, fold_pairs, invert_permutation)
    outs, renders = {}, {}
    for dev in (torch.device("cpu"), cuda):
        arrays = {k: v.detach().to(dev) for k, v in teacher.params().items()}
        model = GaussianModel(arrays, teacher.n_active, 3, teacher.config)
        for fn in counters:
            fn.launches = 0
        outs[dev.type] = bake_ppisp(
            model, {k: v.to(dev) for k, v in tables.items()}, views,
            UTConfig(), RC, 3, iters=BAKE_ITERS, view_sampling=sampling,
            n_views=BAKE_VIEWS)
        launches = [fn.launches for fn in counters]
        out = outs[dev.type]
        baked = GaussianModel({**arrays,
                               "features_albedo": out["features_albedo"],
                               "features_specular": out["features_specular"]},
                              teacher.n_active, 3, teacher.config)
        with torch.no_grad():
            renders[dev.type] = render_gut(
                camera_from_batch(views[0], dev), UTConfig(), RC, baked,
                3)["pred_features"].cpu()
    calls = BAKE_VIEWS + BAKE_ITERS
    assert launches == [calls, calls, BAKE_ITERS, BAKE_ITERS, BAKE_ITERS]
    cpu, card = outs["cpu"], outs["cuda"]
    for got, ref in zip(card["targets"], cpu["targets"]):
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(card["loss_history"], cpu["loss_history"],
                               rtol=1e-3)
    assert card["features_albedo"].device.type == "cuda"
    torch.testing.assert_close(renders["cuda"], renders["cpu"], rtol=0,
                               atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("denoiser", ["cnn", "atrous"])
def test_denoiser_on_card_matches_cpu(cuda, denoiser):
    """The playground's denoisers (fp32 cuDNN convolutions; the a-trous
    filter's exp-weighted taps) on the card within 1e-5 of the CPU, with
    and without the guides."""
    from threedgrut_tpu_torch.playground.denoise import atrous_denoise
    from threedgrut_tpu_torch.playground.denoise_cnn import (apply_cnn,
                                                             init_params,
                                                             load_params)

    rng = np.random.default_rng(0)
    rgb = torch.tensor(rng.uniform(0, 1, (96, 128, 3)), dtype=torch.float32)
    nrm = torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(96, 128, 3)), dtype=torch.float32), dim=-1)
    dep = torch.tensor(rng.uniform(1, 9, (96, 128)), dtype=torch.float32)
    if denoiser == "cnn":
        guided = init_params(torch.Generator().manual_seed(0), guides=True)
        guided["conv_out"]["w"] = 0.05 * torch.randn(
            guided["conv_out"]["w"].shape,
            generator=torch.Generator().manual_seed(1))
        nets = (load_params(), guided)

        def run(x, n, d, dev):
            return [apply_cnn({k: {m: t.to(dev) for m, t in v.items()}
                               for k, v in p.items()}, x, n, d)
                    for p in nets]
    else:
        def run(x, n, d, dev):
            return [atrous_denoise(x), atrous_denoise(x, n, d)]
    ref = run(rgb, nrm, dep, "cpu")
    got = run(rgb.to(cuda), nrm.to(cuda), dep.to(cuda), cuda)
    for g, r in zip(got, ref):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), r, atol=1e-5, rtol=0)


# kernel P's cases against its plain version: every camera of
# torch_port_utils.PROJECTION_CAMERAS (three models, the global shutter
# and the four rolling ones), the active SH degrees 0-2 below the model's
# 3, the UT's other branches (no dilation, so the scale-0 rows' covariance
# is degenerate; no rect or tight bound, no mip scaling, distance depth,
# every sigma point required, 3 shutter iterations), and the other
# activations
PROJECT_BRANCHES = UTConfig(
    covariance_dilation=0.0, rect_bounding=False,
    tight_opacity_bounding=False, mip_splatting_scaling=False,
    global_z_order=False, require_all_sigma_points=True,
    n_rolling_shutter_iterations=3)
PROJECT_CASES = {
    **{k: (k, UTConfig(), 3, None) for k in PROJECTION_CAMERAS},
    **{f"pinhole_degree{d}": ("pinhole", UTConfig(), d, None)
       for d in (0, 1, 2)},
    "pinhole_branches": ("pinhole", PROJECT_BRANCHES, 3, None),
    "pinhole_rolling_branches": ("pinhole_rolling", PROJECT_BRANCHES, 3,
                                 None),
    "fisheye_activations": ("fisheye", UTConfig(), 3, GaussianModelConfig(
        scale_activation="none", density_activation="exp")),
}
@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(PROJECT_CASES))
def test_project_matches_plain(cuda, case):
    """Kernel P against its plain version on 20,224 rows with every edge
    row of projection_cloud (dead rows past n_active, rows behind the
    camera and under min_sensor_z, faint rows, scale-0 rows, wide rows),
    in the shared-origin and the general records (a rolling shutter: the
    general only). Tolerances (projection_check): 1e-5 relative (fp32
    rounding through a few dozen operations), widened by the plain
    version's own distance from float64 and by what 2 ulps of the sigma
    points' pixels move (the covariance of sub-pixel splats cancels);
    validity may flip only within rounding of a decision; the AABB's min
    and max are exact."""
    kind, cfg, degree, config = PROJECT_CASES[case]
    model = projection_cloud(20000, device=cuda, config=config)
    cam = projection_camera(kind, cuda)
    for shared in ([True, False] if "rolling" not in kind else [False]):
        projection_check(cam, cfg, model, degree, shared)


@pytest.mark.gpu
def test_project_full_size_matches_plain(cuda):
    """Kernel P at the serving cell's size, 2,300,160 rows on a 1920x1080
    pinhole view, against its plain version (as test_project_matches_plain
    holds it)."""
    model = bench_cloud(2_300_160, seed=0, device=cuda)
    cam = make_pinhole((1920, 1080), (1100.0, 1100.0), (960.0, 540.0),
                       device=cuda)
    errs = projection_check(cam, UTConfig(), model, 3, True)
    assert errs["rows"] == 2_300_160


@pytest.mark.gpu
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", PROJECTION_CAMERAS)
def test_project_backward_matches_plain(cuda, kind, degree):
    """Kernel P_b against project_view_backward_plain on 20,224 rows with
    every edge row of projection_cloud, at each active degree 0-3 of a
    degree-3 model, in the shared-origin and the general records (a rolling
    shutter: the general only; the backward reads the start pose's sensor
    alone). Tolerances (projection_backward_check): 1e-5 relative, widened
    by 4 x the fp32 plain version's own distance from float64 (both run
    the same operations in the same order without FMA contraction; they
    part where an ulp of the sensor position or of expf moves a value);
    rows with a zero cotangent and coefficients past the degree exact
    zeros; one launch each."""
    model = projection_cloud(20000, device=cuda)
    cam = projection_camera(kind, cuda)
    for shared in ([True, False] if "rolling" not in kind else [False]):
        projection_backward_check(cam, model, degree, shared)


@pytest.mark.gpu
def test_project_backward_full_size_matches_plain(cuda):
    """Kernel P_b at the cuSFM cell's size, 2,300,160 rows on a 1920x1080
    pinhole view at degree 3, against its plain version (as
    test_project_backward_matches_plain holds it)."""
    model = bench_cloud(2_300_160, seed=0, device=cuda)
    cam = make_pinhole((1920, 1080), (1100.0, 1100.0), (960.0, 540.0),
                       device=cuda)
    errs = projection_backward_check(cam, model, 3, True)
    assert errs["rows"] == 2_300_160


@pytest.mark.gpu
def test_project_backward_frozen_parameters_get_none(cuda):
    """A parameter that does not require grad gets None and no memory
    (sh_bake's frozen geometry); the others get P_b's gradients."""
    from threedgrut_tpu_torch.models.gaussians import PARAM_NAMES
    from threedgrut_tpu_torch.ops.cuda.project import ProjectFunction

    model = projection_cloud(5000, device=cuda)
    for k in ("positions", "rotation", "scale", "density"):
        getattr(model, k).requires_grad_(False)
    params = [getattr(model, k) for k in PARAM_NAMES]
    table = ProjectFunction.apply(projection_camera("pinhole", cuda),
                                  UTConfig(), model, 3, True, *params)[6]
    table.backward(torch.ones_like(table))
    assert all(getattr(model, k).grad is None
               for k in ("positions", "rotation", "scale", "density"))
    assert bool(model.features_albedo.grad.abs().sum() > 0)
    assert bool(model.features_specular.grad.abs().sum() > 0)


@pytest.mark.gpu
def test_project_launches_once_a_served_frame_and_each_way_a_step(cuda):
    """A served frame launches kernel P once (the shared-origin records
    for a global shutter, the general ones for a rolling one) and P_b
    never; a training step of an SH model launches P once and P_b once,
    with no grut.sh span (the composition's), and its gradients are the
    composition's: each leaf's norm within 1e-3 of the composition's
    (the benchmark's grad_gap limits are 3e-3 and 1e-2), and the whole
    gradient within 1e-3 relative L2 (P's table and the composition's
    differ in the last bits, which the raster carries through its accept
    tests; the backwards sum in fp32 in another order)."""
    import copy

    from threedgrut_tpu_torch.models.background import BackgroundConfig
    from threedgrut_tpu_torch.ops.cuda import launch_counts
    from threedgrut_tpu_torch.ops.cuda.project import project_view_plain
    from threedgrut_tpu_torch.render import gut
    from threedgrut_tpu_torch.render.serve import make_serving_renderer
    from threedgrut_tpu_torch.synthetic import build_teacher, teacher_dataset
    from threedgrut_tpu_torch.train.trainer import Trainer, TrainerConfig
    from threedgrut_tpu_torch.utils import timer

    keys = ("project_view.launches", "project_view.launches_general",
            "project_view.launches_backward")

    def counts():
        c = launch_counts()
        return tuple(c.get(k, 0) for k in keys)

    def delta(before):
        return tuple(a - b for a, b in zip(counts(), before))

    model = projection_cloud(3000, device=cuda)
    for kind, want in (("pinhole", (1, 0, 0)),
                       ("pinhole_rolling", (0, 1, 0))):
        before = counts()
        make_serving_renderer(model, RC, 3)([projection_camera(kind, cuda)])
        assert delta(before) == want
    ds = teacher_dataset(build_teacher(2000, seed=0, device=cuda), n_views=2,
                         side=64)
    cloud = bench_cloud(1000, seed=1, device=cuda)
    conf = TrainerConfig(background=BackgroundConfig(color="white"))
    trainer = Trainer(conf, ds, cloud)
    plain = Trainer(conf, ds, copy.deepcopy(cloud))
    timer.timing_options.active = True
    timer.reset_spans()
    try:
        before = counts()
        trainer.train_iteration(ds[0], 0)
        assert delta(before) == (1, 0, 1)
        spans = timer.span_table()
    finally:
        timer.timing_options.active = False
    assert "grut.ut" in spans and "grut.sh" not in spans
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gut, "project_view", project_view_plain)
        before = counts()
        plain.train_iteration(ds[0], 0)
        assert delta(before) == (0, 0, 0)
    got = {k: p.grad.double() for k, p in trainer.params().items()}
    want = {k: p.grad.double() for k, p in plain.params().items()}
    norms = {k: float(w.norm()) for k, w in want.items()}
    med = float(np.median(list(norms.values())))
    for k, w in want.items():
        # the benchmark's leaf_gap: against the larger of the leaf's norm
        # and the median leaf's (a leaf past the active SH degree is 0)
        gap = abs(float(got[k].norm()) - norms[k]) / max(norms[k], med)
        assert gap < 1e-3, (k, gap)
    num = sum(float((got[k] - w).square().sum()) for k, w in want.items())
    den = sum(float(w.square().sum()) for w in want.values())
    assert (num / den) ** 0.5 < 1e-3
