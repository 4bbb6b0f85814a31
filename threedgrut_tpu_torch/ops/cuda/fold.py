"""Kernel D wrapper: fold per-pair record gradients into the table.

Replaces threedgrut_tpu/ops/pallas/fold.py:_fold_wide_kernel (through
``fold_sorted_intervals_wide``) together with the un-permute and the
rank -> particle map of render/gut.py:_grf_bwd. The CUDA kernel is
``csrc/fold.cu``; its header says what bounds it and why it is
deterministic. It folds rows of the RGB records (16 wide) or of the NHT
records (64 wide); the two count their launches apart, in ``launches``
and ``launches_wide``. On CPU tensors the wrapper runs
``fold_pairs_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# the record widths kernel D is built for: RGB and NHT records
WIDTHS = (16, 64)


def fold_pairs(d_records: torch.Tensor, perm: torch.Tensor,
               order: torch.Tensor, excl: torch.Tensor, counts: torch.Tensor,
               limit: int, capacity: int) -> torch.Tensor:
    """Sum each particle's pair gradients.

    Args:
        d_records: [P, R] f32 per-pair record gradients, tile-sorted; the
            kernel takes R = 16 or 64, the plain version any R.
        perm: [P] i32 tile-sorted position -> pre-sort pair slot.
        order: [N] i32 depth rank -> particle (N == capacity).
        excl: [N] i32 first pre-sort slot of each depth rank.
        counts: [N] i32 slot count of each depth rank.
        limit: number of pair slots (P); slots >= limit were dropped,
            and so are slots that no rank's run covers.
        capacity: rows of the table.

    Returns d_table [capacity, R] f32; a particle with no pairs gets 0.
    """
    p, width = d_records.shape
    n = order.shape[0]
    dev = d_records.device
    check = build.check_tensor
    check("d_records", d_records, torch.float32, (p, width), dev)
    check("perm", perm, torch.int32, (p,), dev)
    for name, t in (("order", order), ("excl", excl), ("counts", counts)):
        check(name, t, torch.int32, (capacity,), dev)
    if limit != p:
        raise ValueError(f"limit {limit} != pairs {p}")
    if dev.type == "cpu":
        return fold_pairs_plain(d_records, perm, order, excl, counts, limit,
                                capacity)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if width not in WIDTHS:
        raise ValueError(f"d_records width {width}: kernel D folds {WIDTHS}")
    # pre-sort slot -> tile-sorted position: one scatter
    inv_perm = torch.empty_like(perm)
    inv_perm[perm.to(torch.int64)] = torch.arange(p, dtype=torch.int32,
                                                  device=dev)
    d_table = torch.empty((capacity, width), dtype=torch.float32,
                          device=dev)   # the kernel writes every row
    lib = _lib()
    err = lib.fold_launch(
        d_records.data_ptr(), inv_perm.data_ptr(), order.data_ptr(),
        excl.data_ptr(), counts.data_ptr(), n, limit, width,
        d_table.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("fold", err, lib)
    if width == 16:
        fold_pairs.launches += 1
    else:
        fold_pairs.launches_wide += 1
    return d_table


fold_pairs.launches = 0
fold_pairs.launches_wide = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("fold")
    fn = lib.fold_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def fold_pairs_plain(d_records, perm, order, excl, counts, limit, capacity):
    """Plain PyTorch version of ``fold_pairs``: the particle of every
    tile-sorted pair from the slot runs, then ``index_add`` in float64.
    The runs are consecutive from slot 0; slots past them belong to no
    rank (trace's dead rows) and are dropped, as kernel D never reads
    them."""
    dev = d_records.device
    n = order.shape[0]
    owner = torch.repeat_interleave(
        torch.arange(n, device=dev), counts.to(torch.int64))[:limit]
    slot_particle = order.to(torch.int64)[owner]
    slot = perm.to(torch.int64)
    keep = slot < slot_particle.shape[0]
    out = torch.zeros((capacity, d_records.shape[1]), dtype=torch.float64,
                      device=dev)
    out.index_add_(0, slot_particle[slot[keep]], d_records[keep].double())
    return out.to(torch.float32)
