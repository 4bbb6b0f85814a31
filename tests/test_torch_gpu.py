"""Each CUDA kernel of the port against its plain PyTorch version, on
the card. Every test here is marked ``gpu`` and skips where there is no
CUDA device. This file imports no JAX, so the card's machine (which has
none) runs it without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from threedgrut_tpu_torch.ops import binning as t_bin
from threedgrut_tpu_torch.ops.cameras import make_pinhole
from threedgrut_tpu_torch.ops.cuda.expand import (expand_decode_pairs,
                                                  expand_decode_pairs_plain)
from threedgrut_tpu_torch.ops.cuda.fold import fold_pairs, fold_pairs_plain
from threedgrut_tpu_torch.ops.cuda.raster import (
    rasterize_tiles, rasterize_tiles_backward, rasterize_tiles_backward_plain,
    rasterize_tiles_forward, rasterize_tiles_plain)
from threedgrut_tpu_torch.ops.cuda.wmax import (pair_weight_max,
                                                pair_weight_max_plain)
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.render.grt import grt_raster_config, render_grt
from threedgrut_tpu_torch.render.gut import prepare_view, render_gut
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.synthetic import bench_cloud

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
