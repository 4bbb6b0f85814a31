"""Kernel D wrappers: fold per-pair record gradients into the table.

Replaces threedgrut_tpu/ops/pallas/fold.py:_fold_wide_kernel (through
``fold_sorted_intervals_wide``) and _fold_kernel, together with the
un-permute and the rank -> particle map of render/gut.py:_grf_bwd. The
CUDA kernel is ``csrc/fold.cu``; its header says what bounds it, how it
is laid out and why it is deterministic. It folds rows of the RGB records
(16 wide) or of the NHT records (64 wide); the two count their launches
apart, in ``fold_pairs.launches`` and ``launches_wide``. Where the caller
has no inverse of the tile sort, D's library inverts it in one kernel
(``invert_permutation``). ``fold_shared_segment`` folds the per-tile rows of
trace()'s shared segment (the TPU's kernel 7) without repeating the
segment's fold per tile (``fold_shared_segment.launches``). On CPU
tensors the wrappers run the plain versions ``fold_pairs_plain``,
``invert_permutation_plain`` and ``fold_shared_segment_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

# the record widths kernel D is built for: RGB and NHT records
WIDTHS = (16, 64)


def fold_pairs(d_records: torch.Tensor, perm: Optional[torch.Tensor],
               order: torch.Tensor, excl: torch.Tensor, counts: torch.Tensor,
               limit: int, capacity: int,
               inv_perm: Optional[torch.Tensor] = None,
               n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum each particle's pair gradients.

    Args:
        d_records: [P, R] f32 per-pair record gradients, tile-sorted; the
            kernel takes R = 16 or 64, the plain version any R.
        perm: [P] i32 tile-sorted position -> pre-sort pair slot; may be
            None where ``inv_perm`` is given.
        order: [N] i32 depth rank -> particle (N == capacity).
        excl: [N] i32 first pre-sort slot of each depth rank; the runs
            are consecutive from slot 0 (the exclusive scan of counts).
        counts: [N] i32 slot count of each depth rank.
        limit: number of pair slots (P); slots >= limit were dropped,
            and so are slots that no rank's run covers.
        capacity: rows of the table.
        inv_perm: [P] i32 pre-sort slot -> tile-sorted position, the
            inverse of ``perm``; computed from ``perm`` if not given.
        n_valid: [] i32 on the device: rows at tile-sorted positions
            >= n_valid are not read (the tile cull's pairs, past
            tile_start[-1], whose rows kernel C leaves zero). None: all.

    Returns d_table [capacity, R] f32; a particle with no pairs gets 0.
    """
    p, width = d_records.shape
    n = order.shape[0]
    dev = d_records.device
    check = build.check_tensor
    check("d_records", d_records, torch.float32, (p, width), dev)
    if perm is None and inv_perm is None:
        raise ValueError("fold_pairs: give perm or inv_perm")
    for name, t in (("perm", perm), ("inv_perm", inv_perm)):
        if t is not None:
            check(name, t, torch.int32, (p,), dev)
    if n_valid is not None:
        check("n_valid", n_valid, torch.int32, (), dev)
    for name, t in (("order", order), ("excl", excl), ("counts", counts)):
        check(name, t, torch.int32, (capacity,), dev)
    if limit != p:
        raise ValueError(f"limit {limit} != pairs {p}")
    if dev.type == "cpu":
        return fold_pairs_plain(d_records, perm, order, excl, counts, limit,
                                capacity, inv_perm, n_valid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if width not in WIDTHS:
        raise ValueError(f"d_records width {width}: kernel D folds {WIDTHS}")
    if inv_perm is None:
        inv_perm = invert_permutation(perm)
    lib = _lib()
    d_table = torch.empty((capacity, width), dtype=torch.float32,
                          device=dev)   # the kernel writes every row
    err = lib.fold_launch(
        d_records.data_ptr(), inv_perm.data_ptr(), order.data_ptr(),
        excl.data_ptr(), counts.data_ptr(), n, limit, width,
        lanes_per_rank(width, limit, n),
        None if n_valid is None else n_valid.data_ptr(), d_table.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("fold", err, lib)
    if width == 16:
        fold_pairs.launches += 1
    else:
        fold_pairs.launches_wide += 1
    return d_table


fold_pairs.launches = 0
fold_pairs.launches_wide = 0


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """``inv`` [P] i32 with inv[perm[i]] = i, for a permutation ``perm``
    [P] i32 (the tile sort's: tile-sorted position -> pre-sort slot).
    On the card one kernel of D's library (``fold_invert_launch``); on the
    CPU ``invert_permutation_plain``."""
    p = perm.shape[0]
    dev = perm.device
    build.check_tensor("perm", perm, torch.int32, (p,), dev)
    if dev.type == "cpu":
        return invert_permutation_plain(perm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    inv = torch.empty_like(perm)
    lib = _lib()
    err = lib.fold_invert_launch(perm.data_ptr(), p, inv.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("fold_invert", err, lib)
    invert_permutation.launches += 1
    return inv


invert_permutation.launches = 0


def invert_permutation_plain(perm):
    """Plain PyTorch version of ``invert_permutation``: one scatter."""
    inv = torch.empty_like(perm)
    inv[perm.to(torch.int64)] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                             device=perm.device)
    return inv


def fold_shared_segment(d_records: torch.Tensor, n_tiles: int,
                        order: torch.Tensor, excl: torch.Tensor,
                        counts: torch.Tensor, limit: int,
                        capacity: int) -> torch.Tensor:
    """Fold the per-tile gradient rows of a shared segment: row t P + j of
    ``d_records`` [n_tiles P, R] is tile t's gradient of the segment's
    slot j, and the segment's own fold (``order``, ``excl``, ``counts``,
    ``limit`` = P, as ``fold_pairs`` takes them, the runs consecutive from
    slot 0; the segment is in rank order, so its permutation is the
    identity: ``render/grt.py:_segment_fold``) maps the slots to
    particles. Each slot's rows are summed over the tiles in tile order,
    then by rank (``repeat_fold`` followed by ``fold_pairs`` computes the
    same, over a permutation of n_tiles P slots). Returns [capacity, R]
    f32."""
    rows, width = d_records.shape
    dev = d_records.device
    check = build.check_tensor
    check("d_records", d_records, torch.float32, (rows, width), dev)
    for name, t in (("order", order), ("excl", excl), ("counts", counts)):
        check(name, t, torch.int32, (capacity,), dev)
    if n_tiles < 1 or rows != n_tiles * limit:
        raise ValueError(f"d_records rows {rows} != {n_tiles} tiles x "
                         f"{limit} slots")
    if dev.type == "cpu":
        return fold_shared_segment_plain(d_records, n_tiles, order, excl,
                                         counts, limit, capacity)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if width not in WIDTHS:
        raise ValueError(f"d_records width {width}: kernel D folds {WIDTHS}")
    lib = _lib()
    cols = torch.empty((limit, width), dtype=torch.float32, device=dev)
    d_table = torch.empty((capacity, width), dtype=torch.float32,
                          device=dev)
    err = lib.fold_segment_launch(
        d_records.data_ptr(), order.data_ptr(), excl.data_ptr(),
        counts.data_ptr(), capacity, limit, n_tiles, limit,
        width, cols.data_ptr(), d_table.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("fold_segment", err, lib)
    fold_shared_segment.launches += 1
    return d_table


fold_shared_segment.launches = 0


def lanes_per_rank(width: int, slots: int, ranks: int) -> int:
    """The lanes kernel D gives a rank, from the mean run (slots / ranks,
    host values: no read from the device): 8 for runs of a few slots (a
    16-wide 800x800 or 1920x1280 view's 7-17), a warp for the grid
    trace's (73), and at least the width / 4 lanes that hold a row. A
    rank's run longer than 4 groups of its lanes is taken by the warp."""
    lanes = 32 if slots / max(ranks, 1) > 48 else 8
    return max(lanes, width // 4)


def _lib() -> ctypes.CDLL:
    lib = build.load("fold")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (
            ("fold_launch", [p, p, p, p, p, i, i, i, i, p, p, p]),
            ("fold_invert_launch", [p, i, p, p]),
            ("fold_segment_launch", [p, p, p, p, i, i, i, i, i, p, p,
                                     p])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def fold_pairs_plain(d_records, perm, order, excl, counts, limit, capacity,
                     inv_perm=None, n_valid=None):
    """Plain PyTorch version of ``fold_pairs``: the particle of every
    tile-sorted pair from the slot runs, then ``index_add`` in float64.
    The runs are consecutive from slot 0; slots past them belong to no
    rank (trace's dead rows) and are dropped, as kernel D never reads
    them. With ``inv_perm``, each owned slot's row is gathered through it
    (``perm`` is not read); with ``n_valid``, rows at positions >= n_valid
    are dropped, as kernel D does not read them."""
    dev = d_records.device
    n = order.shape[0]
    owner = torch.repeat_interleave(
        torch.arange(n, device=dev), counts.to(torch.int64))[:limit]
    slot_particle = order.to(torch.int64)[owner]
    if inv_perm is not None:
        pos = inv_perm.to(torch.int64)[:slot_particle.shape[0]]
        particle = slot_particle
    else:
        pos = torch.arange(d_records.shape[0], device=dev)
        slot = perm.to(torch.int64)
        keep = slot < slot_particle.shape[0]
        pos, particle = pos[keep], slot_particle[slot[keep]]
    if n_valid is not None:
        keep = pos < n_valid.to(torch.int64)
        pos, particle = pos[keep], particle[keep]
    out = torch.zeros((capacity, d_records.shape[1]), dtype=torch.float64,
                      device=dev)
    out.index_add_(0, particle, d_records[pos].double())
    return out.to(torch.float32)


def fold_shared_segment_plain(d_records, n_tiles, order, excl, counts, limit,
                              capacity):
    """Plain PyTorch version of ``fold_shared_segment``: the tiles' rows of
    each segment slot summed in float64, then the segment's fold."""
    cols = d_records.double().reshape(n_tiles, limit, -1).sum(dim=0)
    ident = torch.arange(limit, dtype=torch.int32, device=cols.device)
    return fold_pairs_plain(cols, ident, order, excl, counts, limit,
                            capacity)
