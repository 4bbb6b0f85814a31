"""Kernel D's plain paths against the compositions they replace (CPU).

Kernel D (``ops/cuda/fold.py``) reads the inverse of the tile sort,
skips the culled rows past ``n_valid``, and folds trace()'s shared
segment as column sums over the tiles (``fold_shared_segment``). Their
plain versions run here; each is held against what the port computed
before: ``fold_pairs_plain`` through ``perm`` over every row, and
``repeat_fold`` with ``fold_pairs_plain``. The fold metadata of trace()
(``render/grt.py``: ``_particle_fold`` now hands over the sort's indices
as the inverse) against the scatter it replaces, the inversion D's
library makes where no caller has it against ``argsort``, and the backward's
tile-row groups of the shared segment against one group. Runs include
ranks with no slots, runs cut by ``limit``, slots past every run and
runs of hundreds of slots. No JAX. The kernels against these plain
versions on the card: tests/test_torch_gpu.py.

Tolerance: the plain versions sum in float64 and round once, so two
orders agree to the float32 rounding of the result (1e-6 of the largest
row).
"""

import numpy as np
import pytest
import torch

from threedgrut_tpu_torch.ops.cuda import raster
from threedgrut_tpu_torch.ops.cuda.fold import (fold_pairs, fold_pairs_plain,
                                                fold_shared_segment,
                                                fold_shared_segment_plain,
                                                invert_permutation)
from threedgrut_tpu_torch.ops.cuda.raster import FoldMeta, repeat_fold
from threedgrut_tpu_torch.render.grt import (_particle_fold, _segment_fold,
                                             trace)
from threedgrut_tpu_torch.synthetic import bench_cloud

# name -> (ranks, most slots a rank, one long run, slots cut by limit)
CASES = {
    "short": (64, 9, 0, 0),
    "long_run": (40, 6, 700, 0),
    "cut_by_limit": (50, 12, 300, 37),
}


def _fold_inputs(case, width, seed=0):
    """(d_records, perm, inv_perm, order, excl, counts, limit, capacity)
    of random runs: a third of the ranks own no slot, the permutation is
    random, and the rows are standard normal."""
    n, most, long_run, cut = CASES[case]
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, most + 1, n)
    counts[rng.random(n) < 0.33] = 0
    if long_run:
        counts[n // 2] = long_run
    limit = int(counts.sum()) - cut
    excl = np.cumsum(counts) - counts
    perm = rng.permutation(limit).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(limit, dtype=np.int32)
    t = torch.tensor
    return (t(rng.normal(size=(limit, width)).astype(np.float32)),
            t(perm), t(inv), t(rng.permutation(n).astype(np.int32)),
            t(excl.astype(np.int32)), t(counts.astype(np.int32)), limit, n)


def _close(got, ref):
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("width", [16, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_through_inverse_matches_perm(case, width):
    d, perm, inv, order, excl, counts, limit, cap = _fold_inputs(case, width)
    ref = fold_pairs_plain(d, perm, order, excl, counts, limit, cap)
    _close(fold_pairs(d, None, order, excl, counts, limit, cap,
                      inv_perm=inv), ref)
    _close(fold_pairs(d, perm, order, excl, counts, limit, cap,
                      inv_perm=inv), ref)
    # every kept pair lands on its particle: the totals agree
    owned = int(min(counts.sum(), limit))
    torch.testing.assert_close(ref.double().sum(0),
                               d[inv[:owned].long()].double().sum(0),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_skips_rows_past_n_valid(case):
    """Rows at tile-sorted positions >= n_valid are not read: the fold
    equals the fold of the rows with those zeroed (kernel C leaves the
    culled pairs' rows zero)."""
    d, perm, inv, order, excl, counts, limit, cap = _fold_inputs(case, 16, 1)
    n_valid = limit * 3 // 4
    zeroed = d.clone()
    zeroed[n_valid:] = 0.0
    ref = fold_pairs_plain(zeroed, perm, order, excl, counts, limit, cap)
    nv = torch.tensor(n_valid, dtype=torch.int32)
    for p, i in ((perm, None), (None, inv), (perm, inv)):
        _close(fold_pairs(d, p, order, excl, counts, limit, cap, i, nv),
               ref)


def _segment(n_seg, cap, n_active, seed):
    """A shared segment's FoldMeta (_segment_fold's) over a random order."""
    rng = np.random.default_rng(seed)
    order = torch.tensor(rng.permutation(cap).astype(np.int32))
    return _segment_fold(order, n_active, n_seg, cap)


# n_active 170: the runs end before the segment's last slot; 256: at it
@pytest.mark.parametrize("n_active", [170, 256])
@pytest.mark.parametrize("width", [16, 64])
@pytest.mark.parametrize("tiles", [1, 7])
def test_shared_segment_matches_repeat_fold(tiles, width, n_active):
    n_seg, cap = 256, 300
    meta = _segment(n_seg, cap, n_active, tiles)
    rng = np.random.default_rng(width)
    d = torch.tensor(rng.normal(size=(tiles * n_seg, width)).astype(
        np.float32))
    g = repeat_fold(meta, tiles)
    ref = fold_pairs_plain(d, g.perm, g.order, g.excl, g.counts, g.limit,
                           cap + 1)
    got = fold_shared_segment(d, tiles, meta.order, meta.excl, meta.counts,
                              meta.limit, cap + 1)
    _close(got, ref)
    # the dead row and the slots past n_active fold nowhere
    assert float(ref[cap].abs().max()) == 0.0


def test_shared_segment_plain_is_the_column_sum():
    meta = _segment(128, 100, 100, 3)
    d = torch.arange(3 * 128 * 16, dtype=torch.float32).reshape(-1, 16)
    got = fold_shared_segment_plain(d, 3, meta.order, meta.excl, meta.counts,
                                    meta.limit, 101)
    cols = d.reshape(3, 128, 16).sum(0)
    torch.testing.assert_close(got[meta.order[:100].long()], cols[:100])


def test_particle_fold_hands_over_the_inverse():
    """_particle_fold's FoldMeta (the sort's indices as the inverse, no
    perm) folds as the scatter-inverted perm it replaces did."""
    rng = np.random.default_rng(5)
    cap = 300
    pid = rng.integers(0, cap + 1, 4000)
    pid[rng.random(pid.size) < 0.1] = cap          # dead-row pairs
    pair_particle = torch.tensor(pid.astype(np.int32))
    meta = _particle_fold(pair_particle, cap)
    assert meta.perm is None and meta.limit == pid.size
    inv = meta.inv_perm.long()
    perm = torch.empty_like(meta.inv_perm)
    perm[inv] = torch.arange(pid.size, dtype=torch.int32)
    # the runs name each pair's particle in pair order
    owner = torch.repeat_interleave(torch.arange(cap + 1),
                                    meta.counts.long())
    torch.testing.assert_close(
        meta.order[owner].long(), pair_particle.long()[inv[:owner.numel()]])
    d = torch.tensor(rng.normal(size=(pid.size, 16)).astype(np.float32))
    ref = fold_pairs_plain(d, perm, meta.order, meta.excl, meta.counts,
                           meta.limit, cap + 1)
    _close(fold_pairs(d, None, meta.order, meta.excl, meta.counts,
                      meta.limit, cap + 1, meta.inv_perm), ref)
    # the same as a sum by particle id, the dead row's pairs dropped
    direct = torch.zeros((cap + 1, 16), dtype=torch.float64)
    keep = pair_particle < cap
    direct.index_add_(0, pair_particle[keep].long(), d[keep].double())
    _close(ref, direct.float())


def test_segment_fold_is_its_own_inverse():
    """The segment is in rank order: its permutation is the identity, so
    the shared mode reads the slots in place (no inverse is carried)."""
    meta = _segment_fold(torch.arange(90, dtype=torch.int32), 80, 128, 90)
    assert torch.equal(meta.perm, torch.arange(128, dtype=torch.int32))
    assert torch.equal(invert_permutation(meta.perm), meta.perm)
    assert meta.inv_perm is None


def test_fold_wrappers_check_their_arguments():
    d, perm, inv, order, excl, counts, limit, cap = _fold_inputs("short", 16)
    with pytest.raises(ValueError, match="perm or inv_perm"):
        fold_pairs(d, None, order, excl, counts, limit, cap)
    with pytest.raises(ValueError):
        fold_pairs(d, perm, order, excl, counts, limit, cap,
                   n_valid=torch.tensor([3], dtype=torch.int32))
    meta = _segment(128, 100, 90, 0)
    rows = torch.zeros((3 * 128 + 1, 16))
    with pytest.raises(ValueError, match="tiles"):
        fold_shared_segment(rows, 3, meta.order, meta.excl, meta.counts,
                            meta.limit, 101)
    with pytest.raises(ValueError, match="counts"):
        fold_shared_segment(rows[:-1], 3, meta.order, meta.excl,
                            meta.counts[:-1], meta.limit, 101)


def _trace_grads(model, ro, rd):
    for p in model.params().values():
        p.grad = None
    out = trace(model, ro, rd, accelerate=False)
    (out["pred_features"].square().mean()
     + 0.1 * out["pred_opacity"].mean()).backward()
    return {k: p.grad.clone() for k, p in model.params().items()}


def test_shared_backward_tile_row_groups_match_one_group(monkeypatch):
    """trace()'s brute-force backward folds the blocks' rows in groups of
    tile rows when they would pass SHARED_BWD_BYTES, summed in group
    order: three groups against one."""
    model = bench_cloud(100, seed=4)
    rng = np.random.default_rng(4)
    ro = torch.tensor(np.tile([0.0, 0.0, -1.0], (3 * 256, 1)).astype(
        np.float32))
    rd = rng.normal(size=(3 * 256, 3)) * [0.15, 0.15, 0.0]
    rd[:, 2] = 1.0
    rd = torch.tensor(rd.astype(np.float32))
    one = _trace_grads(model, ro, rd)
    # the rays are a [48, 16] image: 3 tile rows of one block each; a
    # block's rows take n_seg x 16 floats
    n_seg = -(-model.capacity // 128) * 128
    monkeypatch.setattr(raster, "SHARED_BWD_BYTES", n_seg * 16 * 4)
    assert len(list(raster._tile_row_groups(48, 16, n_seg, 16))) == 3
    three = _trace_grads(model, ro, rd)
    assert any(float(g.abs().max()) > 0 for g in one.values())
    for k in one:
        torch.testing.assert_close(three[k], one[k], rtol=1e-5,
                                   atol=1e-6 * float(one[k].abs().max())
                                   + 1e-30)


@pytest.mark.parametrize("n", [1, 1000, 65_537])
def test_invert_permutation_plain_is_argsort(n):
    perm = torch.tensor(np.random.default_rng(n).permutation(n).astype(
        np.int32))
    inv = invert_permutation(perm)
    assert inv.dtype == torch.int32
    assert torch.equal(inv.long(), torch.argsort(perm.long()))
    assert torch.equal(perm[inv.long()], torch.arange(n, dtype=torch.int32))
