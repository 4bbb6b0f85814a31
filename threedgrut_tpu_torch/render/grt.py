"""3DGRT: primary-ray rendering and ``trace`` of arbitrary rays
(port of threedgrut_tpu/render/grt.py).

The 3DGRT renderer of camera rays is the 3DGUT pipeline with the 3DGRT
settings of configs/render/3dgrt.yaml: the degree-4 particle kernel,
min_transmittance 1e-3, and sorted compositing, in which every ray
re-sorts each window of ``sort_window`` depth-consecutive candidates by
its own hit distance before compositing them (the analogue of the
reference's k = 16 hit buffer).

``trace`` composites rays in any layout (the playground's secondary
rays) against the mixture, in blocks of 256 rays: one 16x16 tile of the
raster kernels, the rays laid out as a [16 blocks, 16] image. Every
candidate list is ranked by the particles' distance to the mean ray
origin and re-sorted per ray in windows of 128 (JAX's CHUNK). Two
regimes, as in JAX:

- brute force (capacity <= 8192, or ``accelerate=False``): every block
  walks the same segment of all slots in rank order, the shared-segment
  mode of kernels B and C (the TPU's kernel 7); its backward writes each
  block's gradient rows apart and kernel D sums each slot's rows over
  the blocks, then folds the slots
  (``ops/cuda/fold.py:fold_shared_segment``);
- the uniform grid (``build_grid``, ``GridAccel``): each block keeps the
  ``max_cells`` nearest cells its rays cross, gathers up to ``cell_cap``
  particles of each plus the global list of large particles, sorts them
  by rank and replaces duplicates with a dead row; then the ordinary
  per-tile segments. Its backward folds the pairs by particle through
  kernel D. The grid is structural: no gradient flows through it.

Differentiable in the model's parameters either way. Normals
(``raster_cfg.enable_normals``) come out as ``pred_normals``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..models.gaussians import GaussianModel
from ..ops.cameras import CameraModel
from ..ops.cuda.raster import FoldMeta, rasterize_tiles
from ..ops.sh import eval_sh_radiance
from ..ops.ut import TILE_PIXELS, TILE_X, UTConfig
from ..utils.timer import ScopedTimer
from .common import RasterConfig
from .gut import particle_table, render_gut

# JAX's CHUNK (ops/pallas/raster.py): trace's sort window and the granule
# of its segments
CHUNK = 128
# blocks of the grid's cell selection handled at once (bounds its [blocks,
# 256, cells, 3] slab test)
_SELECT_BLOCKS = 32


def grt_raster_config(base: Optional[RasterConfig] = None) -> RasterConfig:
    """3DGRT rendering defaults (configs/render/3dgrt.yaml)."""
    base = base or RasterConfig()
    return base.replace(kernel_degree=4, min_transmittance=1e-3,
                        sorted_compositing=True)


def render_grt(cam: CameraModel, ut_cfg: UTConfig, raster_cfg: RasterConfig,
               model: GaussianModel, sh_degree: int, rays=None):
    """Primary-ray 3DGRT render (camera view, or the world-space
    ``rays`` = (ray_o, ray_d) given), differentiable in the model's
    parameters."""
    return render_gut(cam, ut_cfg, grt_raster_config(raster_cfg), model,
                      sh_degree, rays=rays)


@dataclasses.dataclass
class GridAccel:
    """World-space uniform grid over the active particles (JAX
    grt.py:58-81): per-cell particle lists in (cell, rank) order and a
    global list of particles larger than a cell. Build once and reuse
    across calls through ``trace(accel=...)``."""
    lo: torch.Tensor               # [3] grid origin
    cs: torch.Tensor               # [3] cell size
    dims: int                      # G (G^3 cells)
    pair_particle: torch.Tensor    # [8 C] i64, (cell, rank)-sorted
    pair_rank: torch.Tensor        # [8 C] f32
    seg_start: torch.Tensor        # [G^3 + 2] i64 cell segments
    global_particle: torch.Tensor  # [global_cap] i64 (-1: none)
    global_rank: torch.Tensor      # [global_cap] f32
    rank_origin: torch.Tensor      # [3] ordering reference point
    overflow: torch.Tensor         # [] i64 large particles dropped


@torch.no_grad()
def build_grid(model: GaussianModel, rank_origin, grid_dims: int = 8,
               global_cap: int = 1024) -> GridAccel:
    """The uniform grid over the active particles (JAX grt.py:84-159).

    A particle no wider than a cell (6 sigma of its largest scale) goes
    to the <= 8 cells of its 2x2x2 corner lattice, a larger one to the
    global list; past ``global_cap`` they are dropped and counted in
    ``overflow``."""
    g = grid_dims
    cap = model.capacity
    dev = model.device
    active = model.active_mask()
    pos = model.positions.detach()
    r3 = 3.0 * torch.amax(model.get_scale().detach(), dim=-1)    # [C]
    big = torch.full_like(pos, 3e37)
    lo = torch.amin(torch.where(active[:, None], pos - r3[:, None], big), 0)
    hi = torch.amax(torch.where(active[:, None], pos + r3[:, None], -big), 0)
    cs = torch.clamp((hi - lo) / g, min=1e-6)

    small = active & (2.0 * r3 <= torch.amin(cs))
    base = torch.clamp(torch.floor((pos - r3[:, None] - lo) / cs), 0,
                       g - 1).to(torch.int64)
    top = torch.clamp(torch.floor((pos + r3[:, None] - lo) / cs), 0,
                      g - 1).to(torch.int64)
    n_cells = g * g * g
    cells = []
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                cx = torch.minimum(base[:, 0] + ox, top[:, 0])
                cy = torch.minimum(base[:, 1] + oy, top[:, 1])
                cz = torch.minimum(base[:, 2] + oz, top[:, 2])
                cells.append((cx * g + cy) * g + cz)
    cells = torch.stack(cells, dim=1)                            # [C, 8]
    # repeated cells (axes spanning one cell) go to the sentinel cell
    dup = torch.zeros_like(cells, dtype=torch.bool)
    for i in range(1, 8):
        dup[:, i] = (cells[:, i:i + 1] == cells[:, :i]).any(dim=1)
    cells = torch.where(small[:, None] & ~dup, cells,
                        torch.full_like(cells, n_cells))

    origin = torch.as_tensor(rank_origin, dtype=torch.float32, device=dev)
    rank = torch.where(active, torch.linalg.norm(pos - origin, dim=1),
                       torch.full_like(r3, math.inf))
    pid = torch.arange(cap, device=dev)[:, None].expand(cap, 8).reshape(-1)
    cell_f = cells.reshape(-1)
    rank_f = rank[:, None].expand(cap, 8).reshape(-1)
    # lexicographic (cell, rank): a stable sort by rank, then by cell
    by_rank = torch.sort(rank_f, stable=True).indices
    by_cell = by_rank[torch.sort(cell_f[by_rank], stable=True).indices]
    cell_s = cell_f[by_cell]
    seg_start = torch.searchsorted(
        cell_s, torch.arange(n_cells + 2, device=dev), side="left")

    # the large particles: the rank-sorted global list, capped
    over = active & ~small
    order = torch.sort(rank, stable=True).indices
    order = order[torch.sort((~over[order]).to(torch.int8),
                             stable=True).indices]
    n_over = int(over.sum())
    take = min(global_cap, cap)
    keep = torch.arange(take, device=dev) < n_over
    g_particle = torch.full((global_cap,), -1, dtype=torch.int64, device=dev)
    g_rank = torch.full((global_cap,), math.inf, dtype=torch.float32,
                        device=dev)
    g_particle[:take] = torch.where(keep, order[:take],
                                    torch.full_like(order[:take], -1))
    g_rank[:take] = torch.where(keep, rank[order[:take]],
                                torch.full_like(rank[:take], math.inf))
    return GridAccel(lo, cs, g, pid[by_cell], rank_f[by_cell], seg_start,
                     g_particle, g_rank, origin,
                     torch.tensor(max(n_over - global_cap, 0), device=dev))


def _per_ray(t, n_rays: int, dev) -> torch.Tensor:
    """A scalar or per-ray t bound as [n_rays] f32."""
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    return t.expand(n_rays) if t.ndim == 0 else t.reshape(-1)


def _select_cells(accel: GridAccel, ro, rd, tmin, tmax, k_sel: int):
    """Per 256-ray block, the ``k_sel`` cells with the nearest entry over
    its rays (JAX grt.py:309-324): (cell ids [B, K], entry t [B, K], inf
    where no ray of the block crosses the cell). Ties keep the lower cell
    id first, as lax.top_k does."""
    g = accel.dims
    dev = ro.device
    ci = torch.arange(g * g * g, device=dev)
    ijk = torch.stack([ci // (g * g), (ci // g) % g, ci % g],
                      dim=1).to(torch.float32)
    cell_lo = accel.lo + ijk * accel.cs
    cell_hi = cell_lo + accel.cs
    sel, sel_t = [], []
    for b0 in range(0, ro.shape[0], _SELECT_BLOCKS):
        o, d = ro[b0:b0 + _SELECT_BLOCKS], rd[b0:b0 + _SELECT_BLOCKS]
        bt0 = tmin[b0:b0 + _SELECT_BLOCKS, :, None]
        bt1 = tmax[b0:b0 + _SELECT_BLOCKS, :, None]
        inv = 1.0 / torch.where(torch.abs(d) < 1e-12,
                                torch.full_like(d, 1e-12), d)
        t0 = (cell_lo - o[:, :, None]) * inv[:, :, None]   # [b, 256, M, 3]
        t1 = (cell_hi - o[:, :, None]) * inv[:, :, None]
        tn = torch.amax(torch.minimum(t0, t1), dim=-1)
        tf = torch.amin(torch.maximum(t0, t1), dim=-1)
        hit = (tf >= torch.maximum(tn, bt0)) & (tn <= bt1)
        tkey = torch.amin(torch.where(hit, torch.clamp(tn, min=0.0),
                                      torch.full_like(tn, math.inf)), dim=1)
        srt = torch.sort(tkey, dim=1, stable=True)
        sel.append(srt.indices[:, :k_sel])
        sel_t.append(srt.values[:, :k_sel])
    return torch.cat(sel), torch.cat(sel_t)


def _grid_candidates(accel: GridAccel, ro, rd, tmin, tmax, cap: int,
                     max_cells: int, cell_cap: int):
    """Each block's candidate list (JAX grt.py:293-369): particle ids
    [B, L] in rank order, duplicates and empty slots the dead row ``cap``,
    L a multiple of CHUNK; and the cell-list overflow."""
    g = accel.dims
    n_blocks = ro.shape[0]
    k_sel = min(max_cells, g * g * g)
    sel, sel_t = _select_cells(accel, ro, rd, tmin, tmax, k_sel)
    sel_hit = torch.isfinite(sel_t)
    seg_s = accel.seg_start[sel]                                  # [B, K]
    seg_n = accel.seg_start[sel + 1] - seg_s
    within = torch.arange(cell_cap, device=ro.device)
    rows = seg_s[:, :, None] + within
    valid = ((within < torch.clamp(seg_n, max=cell_cap)[:, :, None])
             & sel_hit[:, :, None]).reshape(n_blocks, -1)
    rows = torch.clamp(rows, 0, accel.pair_particle.shape[0] - 1
                       ).reshape(n_blocks, -1)
    pid = torch.where(valid, accel.pair_particle[rows],
                      torch.full_like(rows, cap))
    rnk = torch.where(valid, accel.pair_rank[rows],
                      torch.full(rows.shape, math.inf, device=ro.device))
    cell_overflow = torch.sum(torch.where(
        sel_hit, torch.clamp(seg_n - cell_cap, min=0),
        torch.zeros_like(seg_n)))
    # every block composites the global list of large particles too
    g_pid = torch.where(accel.global_particle >= 0, accel.global_particle,
                        torch.full_like(accel.global_particle, cap))
    pid = torch.cat([pid, g_pid.expand(n_blocks, -1)], dim=1)
    rnk = torch.cat([rnk, accel.global_rank.expand(n_blocks, -1)], dim=1)
    pad = -pid.shape[1] % CHUNK
    if pad:
        pid = torch.nn.functional.pad(pid, (0, pad), value=cap)
        rnk = torch.nn.functional.pad(rnk, (0, pad), value=math.inf)
    # the brute-force sequence minus the unselected cells, then the
    # copies of particles emitted to several selected cells. Ties of rank
    # go by particle id, as the brute force's stable argsort orders them,
    # so a particle's copies always sit together (JAX sorts by rank alone
    # and keeps both copies of two particles tied in rank where they
    # interleave; float32 distances tie a few times in 10^4 particles)
    idx = torch.sort(pid, dim=1, stable=True).indices
    pid, rnk = pid.gather(1, idx), rnk.gather(1, idx)
    idx = torch.sort(rnk, dim=1, stable=True).indices
    pid = pid.gather(1, idx)
    dup = torch.zeros_like(pid, dtype=torch.bool)
    dup[:, 1:] = pid[:, 1:] == pid[:, :-1]
    pid = torch.where(dup, torch.full_like(pid, cap), pid)
    return pid, cell_overflow


def _particle_fold(pair_particle: torch.Tensor, cap: int) -> FoldMeta:
    """FoldMeta of pairs naming particles [0, cap] directly (cap: the dead
    row): rank r is particle r, owning its pairs in pair order (a stable
    sort); the dead row's pairs, last, belong to no rank. The sort's
    indices are the inverse permutation (pre-sort slot -> pair), which
    kernel D reads as they are."""
    n = pair_particle.shape[0]
    dev = pair_particle.device
    key = pair_particle.to(torch.int64)
    pre = torch.sort(key, stable=True).indices      # pre-sort slot -> pair
    counts = torch.bincount(key, minlength=cap + 1)
    counts[cap] = 0
    excl = torch.cumsum(counts, 0) - counts
    return FoldMeta(None, torch.arange(cap + 1, dtype=torch.int32,
                                       device=dev),
                    excl.to(torch.int32), counts.to(torch.int32), n,
                    inv_perm=pre.to(torch.int32))


def _segment_fold(order: torch.Tensor, n_active: int, n_seg: int,
                  cap: int) -> FoldMeta:
    """FoldMeta of the brute-force segment: slot j < n_active holds
    particle order[j]; the rest, and the dead row, fold nowhere."""
    dev = order.device
    r = torch.arange(cap + 1, dtype=torch.int32, device=dev)
    return FoldMeta(
        torch.arange(n_seg, dtype=torch.int32, device=dev),
        torch.cat([order.to(torch.int32),
                   torch.tensor([cap], dtype=torch.int32, device=dev)]),
        torch.clamp(r, max=n_active), (r < n_active).to(torch.int32), n_seg)


class TraceInputs(NamedTuple):
    """What the raster kernels take for one ``trace`` call: the table
    (the dead row last), its pairs and segments, and the rays as a [16
    blocks, 16] image (tile b is block b); ``fold`` is set where the
    table needs a gradient."""
    table: torch.Tensor
    pair_particle: torch.Tensor
    tile_start: torch.Tensor
    ray_o: torch.Tensor
    ray_d: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    cfg: RasterConfig
    shared: bool
    fold: Optional[FoldMeta]
    accel_overflow: Optional[torch.Tensor]
    lead: tuple
    n_rays: int

    def args(self):
        """The positional arguments of ``rasterize_tiles_forward`` (and
        the plain version): table ... tmax, cfg, ray_o, shared."""
        return (self.table, self.pair_particle, self.tile_start, self.ray_d,
                self.tmin, self.tmax, self.cfg, self.ray_o, self.shared)

    def unpack(self, x: torch.Tensor) -> torch.Tensor:
        """A kernel output [16 blocks, 16, C] in the rays' leading shape."""
        return x.reshape(-1, x.shape[-1])[:self.n_rays].reshape(
            *self.lead, x.shape[-1])


def prepare_trace(model: GaussianModel, rays_o: torch.Tensor,
                  rays_d: torch.Tensor, sh_degree: int = 3,
                  raster_cfg: Optional[RasterConfig] = None, t_min=1e-4,
                  t_max=1e7, accelerate: Optional[bool] = None,
                  accel: Optional[GridAccel] = None, grid_dims: int = 8,
                  max_cells: int = 24, cell_cap: int = 256,
                  global_cap: int = 1024,
                  _sorted: bool = True) -> TraceInputs:
    """The kernels' inputs of ``trace`` (its arguments, JAX
    grt.py:203-393): the table with autograd, the rest without."""
    cfg = grt_raster_config(raster_cfg).replace(
        sorted_compositing=_sorted, sort_window=CHUNK)
    dev = model.device
    lead = tuple(rays_o.shape[:-1])
    n_rays = math.prod(lead)
    n_blocks = max(-(-n_rays // TILE_PIXELS), 1)
    pad = n_blocks * TILE_PIXELS - n_rays
    with torch.no_grad():   # rays and t-ranges carry no gradient
        ro = torch.nn.functional.pad(
            rays_o.detach().reshape(-1, 3).to(torch.float32), (0, 0, 0, pad))
        rd = torch.nn.functional.pad(
            rays_d.detach().reshape(-1, 3).to(torch.float32), (0, 0, 0, pad),
            value=1.0)
        rd = rd / torch.clamp(torch.linalg.norm(rd, dim=-1, keepdim=True),
                              min=1e-12)
        tmin = torch.nn.functional.pad(_per_ray(t_min, n_rays, dev), (0, pad))
        tmax = torch.nn.functional.pad(_per_ray(t_max, n_rays, dev), (0, pad),
                                       value=-1.0)
        center = torch.mean(ro[:max(n_rays, 1)], dim=0)
    active = model.active_mask()
    cap = model.capacity
    if accelerate is None:
        accelerate = accel is not None or cap > 8192

    # per-particle SH radiance from the mean-origin direction, clamped
    with ScopedTimer("grut.sh"):
        view_dir = model.positions - center
        view_dir = view_dir / torch.clamp(
            torch.linalg.norm(view_dir, dim=1, keepdim=True), min=1e-12)
        feats = torch.clamp(eval_sh_radiance(model.sh_coeffs(), view_dir,
                                             sh_degree), min=0.0)
    with ScopedTimer("grut.table"):
        table = particle_table(model, None, feats)
        table = torch.cat([table[:, :12], table[:, 12:13] * active[:, None],
                           table[:, 13:]], dim=1)
        # the dead row: identity geometry at the origin, zero density
        dead = torch.zeros((1, table.shape[1]), dtype=torch.float32,
                           device=dev)
        dead[0, [3, 7, 11]] = 1.0
        table = torch.cat([table, dead]).contiguous()
    needs_grad = torch.is_grad_enabled() and table.requires_grad

    def image(x):   # tile b of the [16 n_blocks, 16] image is block b
        return x.reshape(n_blocks * TILE_X, TILE_X, *x.shape[1:]).contiguous()

    overflow = None
    with torch.no_grad():
        if accelerate:
            if accel is None:
                accel = build_grid(model, center, grid_dims, global_cap)
            blocks = (ro.reshape(n_blocks, TILE_PIXELS, 3),
                      rd.reshape(n_blocks, TILE_PIXELS, 3),
                      tmin.reshape(n_blocks, TILE_PIXELS),
                      tmax.reshape(n_blocks, TILE_PIXELS))
            pid, cell_overflow = _grid_candidates(accel, *blocks, cap,
                                                  max_cells, cell_cap)
            overflow = cell_overflow + accel.overflow
            pair_particle = pid.reshape(-1).to(torch.int32)
            tile_start = (torch.arange(n_blocks + 1, dtype=torch.int32,
                                       device=dev) * pid.shape[1])
            fold = (_particle_fold(pair_particle, cap) if needs_grad
                    else None)
        else:
            dist = torch.linalg.norm(model.positions.detach() - center, dim=1)
            order = torch.argsort(torch.where(
                active, dist, torch.full_like(dist, math.inf)), stable=True)
            n_active = int(active.sum())
            n_seg = -(-cap // CHUNK) * CHUNK
            pair_particle = torch.full((n_seg,), cap, dtype=torch.int32,
                                       device=dev)
            pair_particle[:n_active] = order[:n_active].to(torch.int32)
            tile_start = torch.tensor([0, n_seg], dtype=torch.int32,
                                      device=dev)
            fold = (_segment_fold(order, n_active, n_seg, cap)
                    if needs_grad else None)
    return TraceInputs(table, pair_particle, tile_start, image(ro), image(rd),
                       image(tmin), image(tmax), cfg, not accelerate, fold,
                       overflow, lead, n_rays)


def trace(model: GaussianModel, rays_o: torch.Tensor, rays_d: torch.Tensor,
          sh_degree: int = 3, raster_cfg: Optional[RasterConfig] = None,
          t_min=1e-4, t_max=1e7, accelerate: Optional[bool] = None,
          accel: Optional[GridAccel] = None, grid_dims: int = 8,
          max_cells: int = 24, cell_cap: int = 256, global_cap: int = 1024,
          _sorted: bool = True):
    """Trace world-space rays [..., 3] against the mixture (JAX
    grt.py:162-409); returns a dict of the rays' leading shape:
    ``pred_features`` [..., 3], ``pred_opacity``, ``pred_dist``,
    ``hits_count`` [..., 1], with the grid ``accel_overflow`` (cell lists
    cut at ``cell_cap`` plus large particles past ``global_cap``), with
    ``raster_cfg.enable_normals`` ``pred_normals`` [..., 3].

    ``t_min`` and ``t_max`` are scalars or per-ray arrays. The grid is
    the default above 8192 slots (or with ``accel`` given). ``_sorted``
    is test plumbing, as in JAX: False composites in rank order (window
    0) instead of per-ray windows of 128."""
    inp = prepare_trace(model, rays_o, rays_d, sh_degree, raster_cfg, t_min,
                        t_max, accelerate, accel, grid_dims, max_cells,
                        cell_cap, global_cap, _sorted)
    a = inp.args()
    out = rasterize_tiles(*a[:7], inp.fold, inp.ray_o, inp.shared)
    result = {k: inp.unpack(x) for k, x in zip(
        ("pred_features", "pred_opacity", "pred_dist", "hits_count"), out)}
    if inp.accel_overflow is not None:
        result["accel_overflow"] = inp.accel_overflow
    if inp.cfg.enable_normals:
        result["pred_normals"] = inp.unpack(out[4])
    return result
