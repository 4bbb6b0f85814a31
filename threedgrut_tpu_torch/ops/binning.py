"""Tile binning: per-tile depth-ordered (tile, particle) pair lists
(port of threedgrut_tpu/ops/binning.py:39-45, 52-184).

The reference's pipeline (gutRenderer.cu:241-421): count the tiles each
particle covers, depth-sort the particles, exclusive scan, expand every
particle over its tiles with the per-tile conic cull (kernel A,
``ops/cuda/expand.py``), then a stable sort of the pairs by tile. The
stable sorts keep global depth order inside every tile.

The pair buffer is sized per view from the scan total: one host read of
that total per view, as the reference does (gutRenderer.cu:314-323).
``max_pairs`` stays an optional cap: over it the farthest particles'
pairs are dropped and counted in ``overflow``.

The binning is structural (no gradient flows through it), and it also
returns the fold metadata of the JAX package's ``carry_perm``: the
tile-sort permutation and the depth-rank slot runs, with which the
backward maps each tile-sorted pair back to its particle
(``ops/cuda/fold.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .cuda.expand import expand_decode_pairs
from .ut import TILE_X, TILE_Y, Projection


class Binning(NamedTuple):
    pair_particle: torch.Tensor  # [P] i32 particle index, tile-sorted
    pair_tile: torch.Tensor      # [P] i32 tile index, sorted (T = culled)
    tile_start: torch.Tensor     # [T+1] i32 segment boundaries
    num_pairs: torch.Tensor      # [] i32 pairs that survived the cull
    overflow: torch.Tensor       # [] i32 pairs dropped by max_pairs
    # fold metadata (the arguments of ops/cuda/fold.py:fold_pairs)
    perm: torch.Tensor           # [P] i32 tile-sorted position -> pre slot
    order: torch.Tensor          # [N] i32 depth rank -> particle
    excl: torch.Tensor           # [N] i32 first pre slot per depth rank
    counts: torch.Tensor         # [N] i32 slot count per depth rank
    limit: int                   # pair slots kept (P)


class PairSlots(NamedTuple):
    """Kernel A's inputs: depth-sorted particles and their slot runs."""
    rows: torch.Tensor    # [N, 9] f32 lo_x, lo_y, width, conic, center, max_power
    order: torch.Tensor   # [N] i32 depth rank -> particle
    excl: torch.Tensor    # [N] i32 first slot per depth rank
    counts: torch.Tensor  # [N] i32 slot count per depth rank
    total: int            # pre-cull pairs of the view (host value)


def pair_slots(proj: Projection, tile_grid,
               alpha_threshold: float = 1.0 / 255.0) -> PairSlots:
    """Tile counts, stable depth sort and exclusive scan of the pairs."""
    gx, gy = tile_grid
    center = proj.center.detach()
    extent = proj.extent.detach()

    # tile bbox + counts; invalid particles have extent 0 and count 0.
    # counts are float products truncated to int, as in the JAX package.
    inv_tx = 1.0 / TILE_X
    inv_ty = 1.0 / TILE_Y
    lo_x = torch.clamp(torch.floor((center[:, 0] - 0.5 - extent[:, 0])
                                   * inv_tx), 0, gx)
    lo_y = torch.clamp(torch.floor((center[:, 1] - 0.5 - extent[:, 1])
                                   * inv_ty), 0, gy)
    hi_x = torch.clamp(torch.ceil((center[:, 0] - 0.5 + extent[:, 0])
                                  * inv_tx), 0, gx)
    hi_y = torch.clamp(torch.ceil((center[:, 1] - 0.5 + extent[:, 1])
                                  * inv_ty), 0, gy)
    width = torch.clamp(hi_x - lo_x, min=0.0)
    counts = torch.where(proj.valid, width * torch.clamp(hi_y - lo_y, min=0.0),
                         torch.zeros_like(width)).to(torch.int32)

    # STABLE depth sort: pair emission order == global Z order
    depth_key = torch.where(proj.valid, proj.depth.detach(),
                            torch.full_like(width, math.inf))
    order = torch.argsort(depth_key, stable=True)
    counts_sorted = counts[order]
    offsets = torch.cumsum(counts_sorted, dim=0, dtype=torch.int64)
    total = int(offsets[-1]) if offsets.numel() else 0   # host read
    excl = (offsets - counts_sorted).to(torch.int32)

    max_power = torch.log(torch.clamp(proj.opacity.detach(), min=1e-30)
                          / alpha_threshold)
    conic = proj.conic.detach()
    rows = torch.stack([lo_x, lo_y, width, conic[:, 0], conic[:, 1],
                        conic[:, 2], center[:, 0], center[:, 1], max_power],
                       dim=1).contiguous()
    return PairSlots(rows, order.to(torch.int32), excl, counts_sorted, total)


def sort_pairs(pair_tile: torch.Tensor, pair_particle: torch.Tensor,
               num_tiles: int):
    """STABLE sort of the pairs by tile (keeps the depth order within
    each tile): (pair_tile, pair_particle, tile_start, perm), with perm
    [P] i32 the pre-sort slot of each sorted position."""
    pair_tile, perm = torch.sort(pair_tile, stable=True)
    pair_particle = pair_particle[perm]
    tile_start = torch.searchsorted(
        pair_tile, torch.arange(num_tiles + 1, dtype=torch.int32,
                                device=pair_tile.device),
        side="left").to(torch.int32)
    return pair_tile, pair_particle, tile_start, perm.to(torch.int32)


def bin_particles(proj: Projection, tile_grid, max_pairs: Optional[int] = None,
                  tile_culling: bool = True,
                  alpha_threshold: float = 1.0 / 255.0) -> Binning:
    """Bin projected particles into per-tile depth-ordered pair lists."""
    gx, gy = tile_grid
    slots = pair_slots(proj, tile_grid, alpha_threshold)
    limit = slots.total if max_pairs is None else min(slots.total,
                                                      int(max_pairs))
    pair_tile, pair_particle = expand_decode_pairs(
        slots.rows, slots.order, slots.excl, slots.counts, limit, tile_grid,
        tile_culling)
    pair_tile, pair_particle, tile_start, perm = sort_pairs(
        pair_tile, pair_particle, gx * gy)
    return Binning(
        pair_particle=pair_particle, pair_tile=pair_tile,
        tile_start=tile_start, num_pairs=tile_start[-1].clone(),
        overflow=torch.tensor(slots.total - limit, dtype=torch.int32,
                              device=tile_start.device),
        perm=perm, order=slots.order, excl=slots.excl, counts=slots.counts,
        limit=limit)
