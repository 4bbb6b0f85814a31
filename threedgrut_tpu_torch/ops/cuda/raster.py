"""Kernel B and C wrappers: tile compositing and its backward.

Kernel B (``csrc/raster_fwd.cu``) replaces
threedgrut_tpu/ops/pallas/raster.py:_fwd_strip_kernel and kernel C
(``csrc/raster_bwd.cu``) replaces its _bwd_strip_kernel, both in the
training and serving mode: shared ray origin, constant RGB, exact kill,
kernel degree 2 (3DGUT) or 4 (3DGRT), unsorted global-Z order or the
sorted mode (``cfg.sorted_compositing``: per-ray windows of
``cfg.sort_window`` = 16 candidates, the 3DGRT k-buffer; raster.py
bitonic_sort_by_key, bitonic_replay_unsort, _bwd_chunk_fast_sorted).
Their headers say what bounds them and how they are laid out. On CPU
tensors the wrappers run the plain PyTorch versions
``rasterize_tiles_plain`` and ``rasterize_tiles_backward_plain``.

``rasterize_tiles`` is differentiable in ``table`` (the JAX
``rasterize_tiles`` custom_vjp, raster.py:2477-2519): its backward runs
kernel C, then kernel D (``ops/cuda/fold.py``) to fold the per-pair
gradients into the table. Rays, t-ranges and the binning get none.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ..hit import _GG_SCALE, particle_response
from ..ut import TILE_PIXELS, TILE_X, TILE_Y
from . import build
from .fold import fold_pairs

RECORD_DIM = 16  # a = M(o - p) (3), M = diag(1/s) R^T (9), density, rgb(3)


class FoldMeta(NamedTuple):
    """The binning's map from tile-sorted pairs back to particles
    (``ops/binning.py:Binning``; the arguments of ``fold_pairs``)."""
    perm: torch.Tensor     # [P] i32 tile-sorted position -> pre-sort slot
    order: torch.Tensor    # [N] i32 depth rank -> particle
    excl: torch.Tensor     # [N] i32 first pre-sort slot per depth rank
    counts: torch.Tensor   # [N] i32 slot count per depth rank
    limit: int             # pair slots kept (P)


# the kernels are built for these degrees and sorted-mode windows: every
# shipped sorted config (3DGRT and the paper's sorted 3DGUT) composes
# sort_window 16 from configs/render/3dgrt.yaml
DEGREES = (2, 4)
WINDOWS = (16,)


def _thresholds(cfg):
    """(s, ln(min_response)/s, ln(min_alpha)) of the squared-distance
    acceptance test (raster.py:_sq_accept_threshold)."""
    if cfg.kernel_degree not in DEGREES:
        raise NotImplementedError(
            f"kernel_degree {cfg.kernel_degree}: the raster kernels take "
            f"degrees {DEGREES}")
    s = _GG_SCALE[cfg.kernel_degree]
    return s, math.log(cfg.min_response) / s, math.log(cfg.min_alpha)


def _window(cfg) -> int:
    """The kernels' window: 0 in global-Z order, else cfg.sort_window."""
    if not cfg.sorted_compositing:
        return 0
    if cfg.sort_window not in WINDOWS:
        raise NotImplementedError(
            f"sort_window {cfg.sort_window}: the raster kernels are built "
            f"for {WINDOWS}")
    return cfg.sort_window


def _mode(cfg):
    """The launch arguments (degree, window, then the float parameters)
    shared by kernels B, C and E."""
    s, thr_resp, log_min_alpha = _thresholds(cfg)
    return ((cfg.kernel_degree, _window(cfg)),
            (cfg.min_transmittance, cfg.max_alpha, thr_resp, log_min_alpha,
             s))


def _grid(h, w):
    return (w + TILE_X - 1) // TILE_X, (h + TILE_Y - 1) // TILE_Y


def _check_inputs(table, pair_particle, tile_start, ray_d, tmin, tmax):
    h, w = ray_d.shape[:2]
    gx, gy = _grid(h, w)
    dev = table.device
    check = build.check_tensor
    check("table", table, torch.float32, (table.shape[0], RECORD_DIM), dev)
    check("pair_particle", pair_particle, torch.int32,
          (pair_particle.shape[0],), dev)
    check("tile_start", tile_start, torch.int32, (gx * gy + 1,), dev)
    check("ray_d", ray_d, torch.float32, (h, w, 3), dev)
    check("tmin", tmin, torch.float32, (h, w), dev)
    check("tmax", tmax, torch.float32, (h, w), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return h, w, gx, gy, dev


def rasterize_tiles(table: torch.Tensor, pair_particle: torch.Tensor,
                    tile_start: torch.Tensor, ray_d: torch.Tensor,
                    tmin: torch.Tensor, tmax: torch.Tensor, cfg,
                    fold: Optional[FoldMeta] = None):
    """Composite each tile's depth-ordered pairs front to back.

    Args:
        table: [C, 16] f32 per-particle record (a, M, density, rgb).
        pair_particle: [P] i32 particle of each pair, tile-sorted.
        tile_start: [T + 1] i32 pair-segment boundaries per tile.
        ray_d: [H, W, 3] f32 unit world ray directions (shared origin).
        tmin, tmax: [H, W] f32 per-ray t-range.
        cfg: RasterConfig.
        fold: the binning's FoldMeta; needed when ``table`` requires
            grad, for the backward's fold into the table.

    Returns (features [H,W,3], opacity [H,W,1], depth [H,W,1],
    hits [H,W,1]), all f32; hits carries no gradient.
    """
    if torch.is_grad_enabled() and table.requires_grad:
        if fold is None:
            raise ValueError("table requires grad: pass the binning's "
                             "FoldMeta, which the backward needs")
        return _Rasterize.apply(table, pair_particle, tile_start, ray_d,
                                tmin, tmax, cfg, fold)
    return rasterize_tiles_forward(table, pair_particle, tile_start, ray_d,
                                   tmin, tmax, cfg)[:4]


# kernel B launches (by rasterize_tiles and rasterize_tiles_forward)
rasterize_tiles.launches = 0


def rasterize_tiles_forward(table, pair_particle, tile_start, ray_d, tmin,
                            tmax, cfg):
    """Kernel B: (features, opacity, depth, hits, T_final), the last four
    [H, W, 1]. No autograd."""
    h, w, gx, gy, dev = _check_inputs(table, pair_particle, tile_start,
                                      ray_d, tmin, tmax)
    ints, floats = _mode(cfg)
    if dev.type == "cpu":
        return rasterize_tiles_plain(table, pair_particle, tile_start,
                                     ray_d, tmin, tmax, cfg)
    feat = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    opacity, depth, hits, t_final = (
        torch.empty((h, w, 1), dtype=torch.float32, device=dev)
        for _ in range(4))
    lib = _lib("raster_fwd")
    err = lib.raster_fwd_launch(
        table.data_ptr(), pair_particle.data_ptr(), tile_start.data_ptr(),
        ray_d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), w, h, gx,
        gx * gy, *ints, *floats, feat.data_ptr(), opacity.data_ptr(),
        depth.data_ptr(), hits.data_ptr(), t_final.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("raster_fwd", err, lib)
    rasterize_tiles.launches += 1
    return feat, opacity, depth, hits, t_final


def rasterize_tiles_backward(table, pair_particle, tile_start, ray_d, tmin,
                             tmax, feat, depth, t_final, g_feat, g_opacity,
                             g_depth, cfg) -> torch.Tensor:
    """Kernel C: per-pair record gradients d_records [P, 16] f32 in
    tile-sorted pair order, from the saved forward outputs (features
    [H,W,3], depth and T_final [H,W,1]) and the upstream gradients of
    features [H,W,3], opacity and depth [H,W,1]. Pairs past the last tile
    (culled) and pairs behind every pixel's kill read zero."""
    h, w, gx, gy, dev = _check_inputs(table, pair_particle, tile_start,
                                      ray_d, tmin, tmax)
    for name, t, c in (("feat", feat, 3), ("depth", depth, 1),
                       ("t_final", t_final, 1), ("g_feat", g_feat, 3),
                       ("g_opacity", g_opacity, 1), ("g_depth", g_depth, 1)):
        build.check_tensor(name, t, torch.float32, (h, w, c), dev)
    ints, floats = _mode(cfg)
    if dev.type == "cpu":
        return rasterize_tiles_backward_plain(
            table, pair_particle, tile_start, ray_d, tmin, tmax, feat, depth,
            t_final, g_feat, g_opacity, g_depth, cfg)
    p = pair_particle.shape[0]
    d_records = torch.zeros((p, RECORD_DIM), dtype=torch.float32, device=dev)
    lib = _lib("raster_bwd")
    err = lib.raster_bwd_launch(
        table.data_ptr(), pair_particle.data_ptr(), tile_start.data_ptr(),
        ray_d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), feat.data_ptr(),
        depth.data_ptr(), t_final.data_ptr(), g_feat.data_ptr(),
        g_opacity.data_ptr(), g_depth.data_ptr(), w, h, gx, gx * gy,
        *ints, *floats, d_records.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("raster_bwd", err, lib)
    rasterize_tiles_backward.launches += 1
    return d_records


rasterize_tiles_backward.launches = 0


class _Rasterize(torch.autograd.Function):
    """Kernel B forward; kernel C then kernel D backward, giving the
    gradient of ``table`` only (raster.py:_rasterize_fwd/_rasterize_bwd
    with render/gut.py:_grf_bwd)."""

    @staticmethod
    def forward(ctx, table, pair_particle, tile_start, ray_d, tmin, tmax,
                cfg, fold):
        feat, opacity, depth, hits, t_final = rasterize_tiles_forward(
            table, pair_particle, tile_start, ray_d, tmin, tmax, cfg)
        ctx.save_for_backward(table, pair_particle, tile_start, ray_d, tmin,
                              tmax, feat, depth, t_final)
        ctx.cfg = cfg
        ctx.fold = fold
        ctx.mark_non_differentiable(hits)
        return feat, opacity, depth, hits

    @staticmethod
    def backward(ctx, g_feat, g_opacity, g_depth, _g_hits):
        (table, pair_particle, tile_start, ray_d, tmin, tmax, feat, depth,
         t_final) = ctx.saved_tensors

        def grad_or_zeros(g, like):
            return (torch.zeros_like(like) if g is None
                    else g.to(torch.float32).contiguous())

        d_records = rasterize_tiles_backward(
            table, pair_particle, tile_start, ray_d, tmin, tmax, feat, depth,
            t_final, grad_or_zeros(g_feat, feat),
            grad_or_zeros(g_opacity, depth), grad_or_zeros(g_depth, depth),
            ctx.cfg)
        f = ctx.fold
        d_table = fold_pairs(d_records, f.perm, f.order, f.excl, f.counts,
                             f.limit, table.shape[0])
        return d_table, None, None, None, None, None, None, None


_SIGNATURES = {
    # ptrs, ints, floats, ptrs (outputs), stream
    "raster_fwd": (6, 6, 5, 5),
    "raster_bwd": (12, 6, 5, 1),
    "wmax": (6, 6, 5, 1),      # kernel E, ops/cuda/wmax.py
}


def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        n_in, n_int, n_float, n_out = _SIGNATURES[name]
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * n_in + [i] * n_int + [f] * n_float + \
            [p] * n_out + [p]
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

# pairs per group of tiles in the plain versions: bounds their [pairs,
# 256] temporaries (~1 GB in the forward at this size; the backward keeps
# ~25 float64 arrays for autograd, so it takes smaller groups)
_PLAIN_GROUP_PAIRS = 1 << 17
_PLAIN_BWD_GROUP_PAIRS = 1 << 14


class _Tiled(NamedTuple):
    """Per-tile views of the rays ([T, 256, .]) and the tile grid."""
    rd: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    gx: int
    gy: int


def _tilize_rays(ray_d, tmin, tmax) -> _Tiled:
    h, w = ray_d.shape[:2]
    gx, gy = _grid(h, w)
    return _Tiled(_tilize(ray_d, gx, gy, 1.0),
                  _tilize(tmin[..., None], gx, gy, 0.0)[..., 0],
                  _tilize(tmax[..., None], gx, gy, -1.0)[..., 0],  # empty
                  gx, gy)


def _tilize(a, gx, gy, fill):
    """[H, W, c] -> [T, 256, c], padding with fill."""
    h, w, c = a.shape
    full = torch.full((gy * TILE_Y, gx * TILE_X, c), fill, dtype=a.dtype,
                      device=a.device)
    full[:h, :w] = a
    return full.reshape(gy, TILE_Y, gx, TILE_X, c).permute(
        0, 2, 1, 3, 4).reshape(gx * gy, TILE_PIXELS, c)


def _untile(a, gx, gy, h, w):
    """[T, 256, c] -> [H, W, c]."""
    c = a.shape[-1]
    img = a.reshape(gy, gx, TILE_Y, TILE_X, c).permute(0, 2, 1, 3, 4)
    return img.reshape(gy * TILE_Y, gx * TILE_X, c)[:h, :w]


def _tile_groups(starts, n_tiles, max_pairs):
    """Consecutive tile ranges [t0, t1) of at most ``max_pairs`` pairs
    (a larger single tile forms its own group)."""
    t0 = 0
    while t0 < n_tiles:
        t1 = t0 + 1
        base = int(starts[t0])
        while t1 < n_tiles and int(starts[t1 + 1]) - base <= max_pairs:
            t1 += 1
        yield t0, t1
        t0 = t1


def _hit_terms(rec, d):
    """(sq, hit_t) [P, 256] of records [P, 16] on ray dirs [P, 256, 3],
    in the fp32 operation order of common.cuh:eval_hit."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    def col(i):
        return rec[:, i:i + 1]

    ax, ay, az = col(0), col(1), col(2)
    bx = col(3) * dx + col(4) * dy + col(5) * dz
    by = col(6) * dx + col(7) * dy + col(8) * dz
    bz = col(9) * dx + col(10) * dy + col(11) * dz
    cx = ay * bz - az * by
    cy = az * bx - ax * bz
    cz = ax * by - ay * bx
    inv_m = 1.0 / torch.clamp(bx * bx + by * by + bz * bz, min=1e-30)
    sq = (cx * cx + cy * cy + cz * cz) * inv_m
    hit_t = -(ax * bx + ay * by + az * bz) * inv_m
    return sq, hit_t


def _window_order(keep, hit_t, p0, tile, window):
    """[P, 256] per-pixel composite order of the sorted mode: the group's
    pairs (global index p0 + i, tile ``tile``) in windows of ``window``
    aligned on the global index and cut to each tile, each window in
    ascending hit_t of its accepted candidates (rejected ones last); equal
    keys keep pair order. Entry [k, px] is the pair composited k-th."""
    dev = hit_t.device
    n = hit_t.shape[0]
    gidx = torch.arange(n, device=dev) + p0
    seg = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     ((tile[1:] != tile[:-1])
                      | (gidx[1:] // window != gidx[:-1] // window)
                      ).to(torch.int64)]).cumsum(0)
    key = torch.where(keep, hit_t, torch.full_like(hit_t, 3.0e38))
    by_key = torch.sort(key, dim=0, stable=True).indices
    by_seg = torch.sort(seg[by_key], dim=0, stable=True).indices
    return by_key.gather(0, by_seg)


def _composite_group(rec, starts, t0, t1, rays: _Tiled, cfg, rec64=None,
                     pair_weights=False):
    """Composite tiles [t0, t1) of pair records ``rec`` [P_g, 16] (the
    group's pairs, f32). Returns (acc [G, 256, 5] = rgb, depth, hits;
    T_final [G, 256]) in float64, and with ``pair_weights`` also the
    weights w = alpha T [P_g, 256] of each (pair, pixel).

    Accept and kill decisions come from ``rec`` in fp32. The values
    (alpha, hit distance, rgb) do too, rounded to float64 afterwards,
    unless ``rec64`` (the same records in float64) is given: then they are
    computed from it in float64, and autograd can differentiate the
    result with respect to ``rec64``. In the sorted mode each pixel's
    candidates are permuted into ``_window_order`` first (the sort key is
    the fp32 hit distance), composited in that order, and the weights put
    back in pair order."""
    s, thr_resp, log_min_alpha = _thresholds(cfg)
    dev = rec.device
    p0, p1 = int(starts[t0]), int(starts[t1])
    counts = (starts[t0 + 1:t1 + 1] - starts[t0:t1]).to(dev)
    local = torch.repeat_interleave(torch.arange(t1 - t0, device=dev), counts)
    tile = local + t0                                      # [P]
    d = rays.rd[tile]                                      # [P, 256, 3]
    sq, hit_t = _hit_terms(rec, d)
    dens = rec[:, 12:13]
    thr = torch.clamp((log_min_alpha - torch.log(torch.clamp(dens, min=1e-30)))
                      / s, max=thr_resp)
    if cfg.kernel_degree == 4:
        thr = torch.sqrt(torch.clamp(thr, min=0.0))
    keep = (sq < thr) & (hit_t > rays.tmin[tile]) & (hit_t < rays.tmax[tile])
    order = (_window_order(keep, hit_t, p0, tile, _window(cfg))
             if cfg.sorted_compositing else None)
    if rec64 is None:
        alpha = torch.clamp(particle_response(sq, cfg.kernel_degree) * dens,
                            max=cfg.max_alpha)
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha)).double()
        hit_t, rgb = hit_t.double(), rec[:, 13:16].double()
    else:
        sq64, hit_t = _hit_terms(rec64, d.double())
        alpha = torch.clamp(particle_response(sq64, cfg.kernel_degree)
                            * rec64[:, 12:13], max=cfg.max_alpha)
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        rgb = rec64[:, 13:16]
    if order is None:
        rgb = [rgb[:, c:c + 1] for c in range(3)]
    else:
        alpha, hit_t = alpha.gather(0, order), hit_t.gather(0, order)
        rgb = [rgb[:, c][order] for c in range(3)]

    # exclusive transmittance within each tile segment, in log space
    log1m = torch.log1p(-alpha)
    incl = torch.cumsum(log1m, dim=0)
    excl = incl - log1m
    # (an empty tile's clamped index is never read back)
    seg_first = torch.clamp(starts[t0:t1] - p0, max=p1 - p0 - 1).to(dev)
    seg_last = torch.clamp(starts[t0 + 1:t1 + 1] - p0 - 1, min=0).to(dev)
    base = excl[seg_first]                                 # [G, 256]
    t_prev = torch.exp(excl - base[local])
    alive = t_prev >= cfg.min_transmittance
    wgt = torch.where(alive, alpha * t_prev, torch.zeros_like(t_prev))

    contrib = torch.stack([
        wgt * rgb[0], wgt * rgb[1], wgt * rgb[2],
        wgt * hit_t, (wgt > 0.0).double()], dim=-1)        # [P, 256, 5]
    acc = torch.zeros((t1 - t0, TILE_PIXELS, 5), dtype=torch.float64,
                      device=dev).index_add(0, local, contrib)

    # final T: frozen at the first dead candidate, else the segment's end
    dead_t = torch.where(alive, torch.full_like(t_prev, -1.0), t_prev)
    frozen = torch.full((t1 - t0, TILE_PIXELS), -1.0, dtype=torch.float64,
                        device=dev).scatter_reduce(
        0, local[:, None].expand_as(dead_t), dead_t, "amax")
    nonempty = (counts > 0)[:, None]
    t_end = torch.where(nonempty, torch.exp(incl[seg_last] - base),
                        torch.ones_like(base))
    t_final = torch.where(frozen >= 0.0, frozen, t_end)
    if not pair_weights:
        return acc, t_final
    if order is not None:
        wgt = torch.zeros_like(wgt).scatter(0, order, wgt)
    return acc, t_final, wgt


def rasterize_tiles_plain(table, pair_particle, tile_start, ray_d, tmin,
                          tmax, cfg):
    """Plain PyTorch version of ``rasterize_tiles_forward``.

    Vectorised over (pair, pixel): per-pair alpha for the 256 pixels of
    the pair's tile, then the transmittance as an exclusive log-space
    prefix sum (float64) within each tile's segment, the exact kill as a
    mask on it, and ``index_add`` into the pixels. Tiles are processed in
    groups so the temporaries stay bounded.
    """
    h, w = ray_d.shape[:2]
    rays = _tilize_rays(ray_d, tmin, tmax)
    n_tiles = rays.gx * rays.gy
    out = torch.zeros((n_tiles, TILE_PIXELS, 6), dtype=torch.float64,
                      device=table.device)   # rgb, depth, hits, final T
    out[..., 5] = 1.0
    starts = tile_start.to(torch.int64).cpu()
    for t0, t1 in _tile_groups(starts, n_tiles, _PLAIN_GROUP_PAIRS):
        p0, p1 = int(starts[t0]), int(starts[t1])
        if p1 == p0:
            continue
        rec = table[pair_particle[p0:p1].to(torch.int64)]
        acc, t_final = _composite_group(rec, starts, t0, t1, rays, cfg)
        out[t0:t1, :, 0:5] = acc
        out[t0:t1, :, 5] = t_final
    img = _untile(out, rays.gx, rays.gy, h, w).to(torch.float32)
    t_fin = img[..., 5:6].contiguous()
    return (img[..., 0:3].contiguous(), 1.0 - t_fin,
            img[..., 3:4].contiguous(), img[..., 4:5].contiguous(), t_fin)


def rasterize_tiles_backward_plain(table, pair_particle, tile_start, ray_d,
                                   tmin, tmax, feat, depth, t_final, g_feat,
                                   g_opacity, g_depth, cfg):
    """Plain PyTorch version of ``rasterize_tiles_backward``: autograd
    through the float64 compositing of ``_composite_group``, with each
    group's gathered records as the leaf, tile group by tile group. The
    accept and kill decisions are the fp32 ones of the forward; the saved
    outputs (feat, depth, t_final) are not needed, the group recomputes
    them."""
    del feat, depth, t_final
    rays = _tilize_rays(ray_d, tmin, tmax)
    n_tiles = rays.gx * rays.gy
    gx, gy = rays.gx, rays.gy
    g_rgb = _tilize(g_feat.double(), gx, gy, 0.0)             # [T, 256, 3]
    g_dep = _tilize(g_depth.double(), gx, gy, 0.0)[..., 0]     # [T, 256]
    g_t = -_tilize(g_opacity.double(), gx, gy, 0.0)[..., 0]    # d/d T_final
    d_records = torch.zeros((pair_particle.shape[0], RECORD_DIM),
                            dtype=torch.float32, device=table.device)
    starts = tile_start.to(torch.int64).cpu()
    for t0, t1 in _tile_groups(starts, n_tiles, _PLAIN_BWD_GROUP_PAIRS):
        p0, p1 = int(starts[t0]), int(starts[t1])
        if p1 == p0:
            continue
        rec = table[pair_particle[p0:p1].to(torch.int64)].detach()
        with torch.enable_grad():
            rec64 = rec.double().requires_grad_(True)
            acc, t_fin = _composite_group(rec, starts, t0, t1, rays, cfg,
                                          rec64=rec64)
            loss = ((acc[..., 0:3] * g_rgb[t0:t1]).sum()
                    + (acc[..., 3] * g_dep[t0:t1]).sum()
                    + (t_fin * g_t[t0:t1]).sum())
            (grad,) = torch.autograd.grad(loss, rec64)
        d_records[p0:p1] = grad.to(torch.float32)
    return d_records
