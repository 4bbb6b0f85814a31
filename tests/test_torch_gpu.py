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
from threedgrut_tpu_torch.ops.cuda.raster import (rasterize_tiles,
                                                  rasterize_tiles_plain)
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.render.gut import prepare_view, render_gut
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.synthetic import bench_cloud

RC = RasterConfig()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _view(device, n=4000, side=200):
    model = bench_cloud(n, seed=1, device=device)
    cam = make_pinhole((side, side + 24), (1.1 * side, 1.1 * side),
                       (side / 2, side / 2 + 12), device=device)
    with torch.no_grad():
        return prepare_view(cam, UTConfig(), RC, model, 3)


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
    got = rasterize_tiles(*args)
    assert rasterize_tiles.launches == before + 1
    ref = rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got[:2], ref[:2]):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=0)
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
    with pytest.raises(RuntimeError, match="no backward"):
        rasterize_tiles(v.table.requires_grad_(), b.pair_particle,
                        b.tile_start, v.ray_d, v.tmin, v.tmax, RC)


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
