"""Kernel A wrapper: tile-pair expansion + decode + conic cull.

Replaces threedgrut_tpu/ops/pallas/expand.py:_bin_decode_kernel (through
``expand_decode_pairs``). The CUDA kernel is ``csrc/bin_decode.cu``; its
header says what bounds it and how it is laid out. On a CPU tensor the
wrapper runs ``expand_decode_pairs_plain``, the same function in plain
PyTorch, whose integer outputs the kernel reproduces exactly.
"""

from __future__ import annotations

import ctypes

import torch

from ..ut import tile_min_power_response
from . import build

ROW_DIM = 9  # lo_x, lo_y, width, conic a b c, center x y, max_power


def expand_decode_pairs(rows: torch.Tensor, order: torch.Tensor,
                        excl: torch.Tensor, counts: torch.Tensor, limit: int,
                        grid, tile_culling: bool = True):
    """Expand depth-sorted particles over their pair slots.

    Args:
        rows: [N, 9] f32 per-particle row (particle order): tile bbox
            origin lo_x, lo_y, bbox width, conic (a, b, c), center (x, y)
            and max_power = ln(opacity / alpha_threshold).
        order: [N] i32 depth rank -> particle.
        excl: [N] i32 first pair slot of each depth rank (exclusive scan).
        counts: [N] i32 pair count of each depth rank.
        limit: number of pair slots (slots >= limit are dropped).
        grid: (gx, gy) tile grid.

    Returns (pair_tile, pair_particle), [limit] i32 each, in slot order.
    Culled slots carry the sentinel tile gx * gy.
    """
    n = order.shape[0]
    dev = rows.device
    build.check_tensor("rows", rows, torch.float32, (n, ROW_DIM), dev)
    for name, t in (("order", order), ("excl", excl), ("counts", counts)):
        build.check_tensor(name, t, torch.int32, (n,), dev)
    if dev.type == "cpu":
        return expand_decode_pairs_plain(rows, order, excl, counts, limit,
                                         grid, tile_culling)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    gx, gy = grid
    pair_tile = torch.empty(limit, dtype=torch.int32, device=dev)
    pair_particle = torch.empty(limit, dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.bin_decode_launch(
        rows.data_ptr(), order.data_ptr(), excl.data_ptr(),
        counts.data_ptr(), n, limit, gx, gx * gy, int(tile_culling),
        pair_tile.data_ptr(), pair_particle.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("bin_decode", err, lib)
    expand_decode_pairs.launches += 1
    return pair_tile, pair_particle


expand_decode_pairs.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("bin_decode")
    fn = lib.bin_decode_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def expand_decode_pairs_plain(rows, order, excl, counts, limit, grid,
                              tile_culling=True):
    """Plain PyTorch version of ``expand_decode_pairs`` (same outputs)."""
    gx, gy = grid
    dev = rows.device
    n = order.shape[0]
    owner = torch.repeat_interleave(
        torch.arange(n, device=dev), counts.to(torch.int64))[:limit]
    slot = torch.arange(owner.shape[0], device=dev)
    rank = slot - excl.to(torch.int64)[owner]
    particle = order[owner]
    r = rows[particle.to(torch.int64)]
    width = torch.clamp(r[:, 2].to(torch.int64), min=1)
    tx = r[:, 0].to(torch.int64) + rank % width
    ty = r[:, 1].to(torch.int64) + rank // width
    keep = torch.ones_like(tx, dtype=torch.bool)
    if tile_culling:
        power = tile_min_power_response(
            torch.stack([tx, ty], dim=-1).to(torch.float32), r[:, 3:6],
            r[:, 6:8])
        keep = power < r[:, 8]
    pair_tile = torch.where(keep, ty * gx + tx,
                            torch.full_like(tx, gx * gy)).to(torch.int32)
    return pair_tile, particle.to(torch.int32)
