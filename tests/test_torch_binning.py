"""Tile binning of the PyTorch port against the JAX package on the CPU.

Both sides bin the same projection (the JAX ``Projection``, handed to
the port as tensors), so every output is an integer computed by the same
fp32 operations: ``pair_particle`` over the valid pairs, ``tile_start``,
``num_pairs`` and ``overflow`` must be EQUAL. The JAX expansion kernel
runs in Pallas interpret mode.
"""

import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from threedgrut_tpu.ops import binning as j_bin
from threedgrut_tpu.ops import ut as j_ut
from threedgrut_tpu_torch.ops import binning as t_bin
from threedgrut_tpu_torch.ops import ut as t_ut
from threedgrut_tpu_torch.ops.cuda.expand import expand_decode_pairs

RES = (64, 48)
GRID = (4, 3)


def _projection(seed, n=96, capacity=None, n_active=None, res=RES):
    cam, state = make_test_scene(n=n, capacity=capacity, n_active=n_active,
                                 seed=seed, res=res)
    return j_ut.unscented_projection(
        cam, j_ut.UTConfig(), state.params.positions, state.params.rotation,
        state.get_scale(), state.get_density()[:, 0], state.active_mask())


def _to_torch(jp):
    return t_ut.Projection(*(torch.tensor(np.asarray(f)) for f in jp))


def _bin_both(jp, max_pairs_jax, max_pairs_torch, tile_culling=True):
    jb = j_bin.bin_particles(jp, GRID, max_pairs_jax,
                             tile_culling=tile_culling, interpret=True)
    tb = t_bin.bin_particles(_to_torch(jp), GRID, max_pairs_torch,
                             tile_culling=tile_culling)
    return jb, tb


def _assert_equal(jb, tb):
    n = int(jb.num_pairs)
    assert int(tb.num_pairs) == n
    assert int(tb.overflow) == int(jb.overflow)
    np.testing.assert_array_equal(tb.tile_start.numpy(),
                                  np.asarray(jb.tile_start))
    np.testing.assert_array_equal(tb.pair_particle[:n].numpy(),
                                  np.asarray(jb.pair_particle)[:n])


@pytest.mark.parametrize("seed,tile_culling", [(0, True), (1, True),
                                               (2, False)])
def test_binning_matches_jax(seed, tile_culling):
    jp = _projection(seed, n=96, capacity=128, n_active=90)
    jb, tb = _bin_both(jp, 2048, None, tile_culling)
    assert int(jb.overflow) == 0 and int(jb.num_pairs) > 0
    _assert_equal(jb, tb)
    # the buffer holds the view's pre-cull pairs; culled ones sort last
    # under the sentinel tile
    n = int(tb.num_pairs)
    assert tb.pair_tile.shape[0] == tb.pair_particle.shape[0] >= n
    assert bool((tb.pair_tile[n:] == GRID[0] * GRID[1]).all())
    # dead capacity rows never produce pairs
    assert int(tb.pair_particle[:int(tb.num_pairs)].max()) < 90


def test_binning_overflow_drops_farthest():
    jp = _projection(3, n=160)
    jb_all, tb_all = _bin_both(jp, 4096, None)
    total = tb_all.pair_particle.shape[0]
    assert total > 256
    jb, tb = _bin_both(jp, 256, 256)
    assert int(tb.overflow) == total - 256 > 0
    _assert_equal(jb, tb)
    # what remains is the nearest particles' pairs
    depth = np.asarray(jp.depth)
    kept = np.unique(tb.pair_particle[:int(tb.num_pairs)].numpy())
    dropped = np.setdiff1d(np.unique(
        tb_all.pair_particle[:int(tb_all.num_pairs)].numpy()), kept)
    assert depth[kept].max() <= depth[dropped].min()


def test_expand_plain_matches_sequential():
    """The vectorised plain version against a per-particle loop written
    the way the CUDA kernel walks its slots."""
    tp = _to_torch(_projection(4))
    s = t_bin.pair_slots(tp, GRID)
    pt, pp = expand_decode_pairs(s.rows, s.order, s.excl, s.counts, s.total,
                                 GRID)
    assert expand_decode_pairs.launches == 0      # CPU: plain version
    ref_t, ref_p = [], []
    for k in range(s.order.shape[0]):
        i = int(s.order[k])
        row = s.rows[i:i + 1]
        w = max(int(row[0, 2]), 1)
        for r in range(int(s.counts[k])):
            tx, ty = int(row[0, 0]) + r % w, int(row[0, 1]) + r // w
            power = t_ut.tile_min_power_response(
                torch.tensor([[tx, ty]], dtype=torch.float32),
                row[:, 3:6], row[:, 6:8])
            ref_t.append(ty * 4 + tx if bool(power[0] < row[0, 8]) else 12)
            ref_p.append(i)
    np.testing.assert_array_equal(pt.numpy(), ref_t)
    np.testing.assert_array_equal(pp.numpy(), ref_p)


def test_wrapper_rejects_bad_inputs():
    rows = torch.zeros((4, 9))
    order = torch.arange(4, dtype=torch.int32)
    cnt = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        expand_decode_pairs(rows.double(), order, cnt, cnt, 0, GRID)
    with pytest.raises(ValueError):
        expand_decode_pairs(rows[:, :8], order, cnt, cnt, 0, GRID)
    with pytest.raises(ValueError):
        expand_decode_pairs(rows.t().contiguous().t(), order, cnt, cnt, 0,
                            GRID)
