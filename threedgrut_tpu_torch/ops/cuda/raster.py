"""Kernel B wrapper: forward tile compositing.

Replaces threedgrut_tpu/ops/pallas/raster.py:_fwd_strip_kernel (through
``rasterize_tiles``) in the serving mode: shared ray origin, constant
RGB, unsorted, exact kill, kernel degree 2. The CUDA kernel is
``csrc/raster_fwd.cu``; its header says what bounds it and how it is laid
out. On CPU tensors the wrapper runs ``rasterize_tiles_plain``.

There is no gradient yet (the backward is the next slice's work): the
wrapper raises if any input requires grad rather than return a result
whose gradient would be wrong or missing.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..hit import _GG_SCALE
from ..ut import TILE_PIXELS, TILE_X, TILE_Y
from . import build

RECORD_DIM = 16  # a = M(o - p) (3), M = diag(1/s) R^T (9), density, rgb(3)


def _thresholds(cfg):
    """(s, ln(min_response)/s, ln(min_alpha)) of the squared-distance
    acceptance test (raster.py:_sq_accept_threshold, degree 2)."""
    if cfg.kernel_degree != 2:
        raise NotImplementedError(
            f"kernel_degree {cfg.kernel_degree}: only degree 2 is ported")
    s = _GG_SCALE[2]
    return s, math.log(cfg.min_response) / s, math.log(cfg.min_alpha)


def rasterize_tiles(table: torch.Tensor, pair_particle: torch.Tensor,
                    tile_start: torch.Tensor, ray_d: torch.Tensor,
                    tmin: torch.Tensor, tmax: torch.Tensor, cfg):
    """Composite each tile's depth-ordered pairs front to back.

    Args:
        table: [C, 16] f32 per-particle record (a, M, density, rgb).
        pair_particle: [P] i32 particle of each pair, tile-sorted.
        tile_start: [T + 1] i32 pair-segment boundaries per tile.
        ray_d: [H, W, 3] f32 unit world ray directions (shared origin).
        tmin, tmax: [H, W] f32 per-ray t-range.
        cfg: RasterConfig.

    Returns (features [H,W,3], opacity [H,W,1], depth [H,W,1],
    hits [H,W,1]), all f32.
    """
    h, w = ray_d.shape[:2]
    gx = (w + TILE_X - 1) // TILE_X
    gy = (h + TILE_Y - 1) // TILE_Y
    dev = table.device
    check = build.check_tensor
    check("table", table, torch.float32, (table.shape[0], RECORD_DIM), dev)
    check("pair_particle", pair_particle, torch.int32,
          (pair_particle.shape[0],), dev)
    check("tile_start", tile_start, torch.int32, (gx * gy + 1,), dev)
    check("ray_d", ray_d, torch.float32, (h, w, 3), dev)
    check("tmin", tmin, torch.float32, (h, w), dev)
    check("tmax", tmax, torch.float32, (h, w), dev)
    s, thr_resp, log_min_alpha = _thresholds(cfg)
    if dev.type == "cpu":
        return rasterize_tiles_plain(table, pair_particle, tile_start,
                                     ray_d, tmin, tmax, cfg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    feat = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    opacity = torch.empty((h, w, 1), dtype=torch.float32, device=dev)
    depth = torch.empty((h, w, 1), dtype=torch.float32, device=dev)
    hits = torch.empty((h, w, 1), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.raster_fwd_launch(
        table.data_ptr(), pair_particle.data_ptr(), tile_start.data_ptr(),
        ray_d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), w, h, gx,
        gx * gy, cfg.min_transmittance, cfg.max_alpha, thr_resp,
        log_min_alpha, s, feat.data_ptr(), opacity.data_ptr(),
        depth.data_ptr(), hits.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("raster_fwd", err, lib)
    rasterize_tiles.launches += 1
    return feat, opacity, depth, hits


rasterize_tiles.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("raster_fwd")
    fn = lib.raster_fwd_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p] * 6 + [i] * 4 + [f] * 5 + [p] * 4 + [p])
        fn.restype = ctypes.c_int
    return lib


# pairs per group of tiles in the plain version: bounds its [pairs, 256]
# temporaries (~1 GB at this size) while keeping the group count small
_PLAIN_GROUP_PAIRS = 1 << 17


def rasterize_tiles_plain(table, pair_particle, tile_start, ray_d, tmin,
                          tmax, cfg):
    """Plain PyTorch version of ``rasterize_tiles``.

    Vectorised over (pair, pixel): per-pair alpha for the 256 pixels of
    the pair's tile, then the transmittance as an exclusive log-space
    prefix sum (float64) within each tile's segment, the exact kill as a
    mask on it, and ``index_add`` into the pixels. Tiles are processed in
    groups so the temporaries stay bounded.
    """
    s, thr_resp, log_min_alpha = _thresholds(cfg)
    h, w = ray_d.shape[:2]
    gx = (w + TILE_X - 1) // TILE_X
    gy = (h + TILE_Y - 1) // TILE_Y
    n_tiles = gx * gy
    dev = table.device
    hp, wp = gy * TILE_Y, gx * TILE_X

    def tilize(a, fill):   # [H, W, c] -> [T, 256, c], padding with fill
        c = a.shape[-1]
        full = torch.full((hp, wp, c), fill, dtype=a.dtype, device=dev)
        full[:h, :w] = a
        return full.reshape(gy, TILE_Y, gx, TILE_X, c).permute(
            0, 2, 1, 3, 4).reshape(n_tiles, TILE_PIXELS, c)

    rd_t = tilize(ray_d, 1.0)
    tmin_t = tilize(tmin[..., None], 0.0)[..., 0]
    tmax_t = tilize(tmax[..., None], -1.0)[..., 0]   # padding: empty range

    out = torch.zeros((n_tiles, TILE_PIXELS, 6), dtype=torch.float64,
                      device=dev)   # rgb, depth, hits, final T
    out[..., 5] = 1.0
    starts = tile_start.to(torch.int64).cpu()
    t0 = 0
    while t0 < n_tiles:
        t1 = t0 + 1
        base = int(starts[t0])
        while t1 < n_tiles and int(starts[t1 + 1]) - base <= _PLAIN_GROUP_PAIRS:
            t1 += 1
        _composite_group(table, pair_particle, starts, t0, t1, rd_t, tmin_t,
                         tmax_t, cfg, s, thr_resp, log_min_alpha, out)
        t0 = t1

    def untile(a):          # [T, 256, c] -> [H, W, c]
        c = a.shape[-1]
        img = a.reshape(gy, gx, TILE_Y, TILE_X, c).permute(0, 2, 1, 3, 4)
        return img.reshape(hp, wp, c)[:h, :w].to(torch.float32).contiguous()

    img = untile(out)
    return (img[..., 0:3].contiguous(), (1.0 - img[..., 5:6]),
            img[..., 3:4].contiguous(), img[..., 4:5].contiguous())


def _composite_group(table, pair_particle, starts, t0, t1, rd_t, tmin_t,
                     tmax_t, cfg, s, thr_resp, log_min_alpha, out):
    """Composite tiles [t0, t1) into ``out`` [T, 256, 6] (float64)."""
    dev = table.device
    p0, p1 = int(starts[t0]), int(starts[t1])
    if p1 == p0:
        return
    counts = (starts[t0 + 1:t1 + 1] - starts[t0:t1]).to(dev)
    local = torch.repeat_interleave(torch.arange(t1 - t0, device=dev), counts)
    tile = local + t0                                      # [P]
    rec = table[pair_particle[p0:p1].to(torch.int64)]      # [P, 16]
    d = rd_t[tile]                                         # [P, 256, 3]
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
    dens = col(12)
    thr = torch.clamp((log_min_alpha - torch.log(torch.clamp(dens, min=1e-30)))
                      / s, max=thr_resp)
    alpha = torch.clamp(torch.exp(s * sq) * dens, max=cfg.max_alpha)
    keep = (sq < thr) & (hit_t > tmin_t[tile]) & (hit_t < tmax_t[tile])
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha)).double()

    # exclusive transmittance within each tile segment, in log space
    log1m = torch.log1p(-alpha)
    incl = torch.cumsum(log1m, dim=0)
    excl = incl - log1m
    # (an empty tile's clamped index is never read back)
    seg_first = torch.clamp(starts[t0:t1] - p0, max=p1 - p0 - 1).to(dev)
    seg_last = (starts[t0 + 1:t1 + 1] - p0 - 1).to(dev)
    base = excl[seg_first]                                 # [G, 256]
    t_prev = torch.exp(excl - base[local])
    alive = t_prev >= cfg.min_transmittance
    wgt = torch.where(alive, alpha * t_prev, torch.zeros_like(t_prev))

    contrib = torch.stack([
        wgt * rec[:, 13:14].double(), wgt * rec[:, 14:15].double(),
        wgt * rec[:, 15:16].double(), wgt * hit_t.double(),
        (wgt > 0.0).double()], dim=-1)                     # [P, 256, 5]
    acc = torch.zeros((t1 - t0, TILE_PIXELS, 5), dtype=torch.float64,
                      device=dev)
    acc.index_add_(0, local, contrib)

    # final T: frozen at the first dead candidate, else the segment's end
    dead_t = torch.where(alive, torch.full_like(t_prev, -1.0), t_prev)
    frozen = torch.full((t1 - t0, TILE_PIXELS), -1.0, dtype=torch.float64,
                        device=dev)
    frozen.scatter_reduce_(0, local[:, None].expand_as(dead_t), dead_t,
                           "amax")
    nonempty = counts > 0
    t_end = torch.ones_like(frozen)
    t_end[nonempty] = torch.exp(incl[seg_last[nonempty]]
                                - base[nonempty])
    out[t0:t1, :, 0:5] = acc
    out[t0:t1, :, 5] = torch.where(frozen >= 0.0, frozen, t_end)
