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

Kernel B in these modes (and kernel E, ``ops/cuda/wmax.py``) tests only
the (pair, pixel) candidates a conservative cull keeps: each warp of 8x4
pixels forms the pyramid of its rays, and the thread that stages a pair
tests the particle's acceptance ellipsoid (degree 2 in global-Z order)
or sphere (elsewhere) against it (common.cuh, "kernels B and E in their
RGB modes"); B at degree 4 in global-Z order, whose rays die within a
few dozen pairs, walks every pair as before. A culled candidate is one the exact test rejects, so the
outputs are those of testing every pair. ``cull_plain`` is this cull,
and trace's below, in the kernels' fp32 operation order, held against
the exact test; ``rasterize_tiles_plain(..., cull=True)`` composites as
the kernels walk.

The general-geometry mode (``ray_o`` given; raster.py chunk_hits_general
and the general pullback of _bwd_chunk_grads, the TPU's kernel 5) takes
a per-pixel ray origin: a rolling-shutter camera, or a caller's own rays.
Its table holds the particle position p in slots 0-2 instead of
a = M (o - p), and each (pixel, pair) forms a = M (o_pix - p); the rest
of the record, the walk, the windows and the reduction are the
shared-origin mode's. Its launches count apart, in ``launches_general``.

The NHT mode (a 64-wide ``table``: raster.py's NHT mode, the TPU's
kernel 8; always general, global-Z order) carries 4 x 12 tetrahedron
control features per particle in place of rgb and composites 24 ray
features per pixel, (sin, cos) of the control features' barycentric
blend at the canonical hit point (``ops/hit.py:nht_hit_features``). Its
launches count in ``launches_nht``. Kernel C takes those sines and
cosines by ``nht_sincos`` (a Cody-Waite step and the SFU); kernel B
keeps the accurate ``sincosf``.

The shared-segment mode (``shared=True``; raster.py shared_segments, the
TPU's kernel 7, which ``render/grt.py:trace`` takes by brute force):
``tile_start`` is [2] and every tile composites the one segment
[tile_start[0], tile_start[1]). Kernel C then writes tile t's gradient
of slot j to row t n + j, n the segment's length: one writer per row,
and kernel D sums each slot's rows over the tiles, then folds the slots
(``fold_shared_segment``; ``repeat_fold`` with ``fold_pairs`` is the
same function over n_tiles n slots). trace
runs it, and windows of 128 (``sort_window`` = 128), in the general mode
at degree 4 only; their launches count in ``launches_shared_segment``
and ``launches_window128``. In windows of 128 the kernels test only the
candidates a conservative cull keeps (common.cuh: each warp's bundle of
rays, then each ray's sphere) and sort each ray's window in a register
k-buffer of TRACE_K keys, with extra passes for a window that accepts
more (``window_overflows`` counts them).

With ``cfg.enable_normals`` kernel B also blends each hit's world normal
(raster.py compute_normals; ``ops/hit.py:hit_normal``) into a sixth
output [H, W, 3], forward only. Not in the NHT mode, as in JAX. Its
launches count in ``launches_normals``.

Each launch counts in one counter: normals, else NHT, else a shared
segment, else windows of 128, else the shared-origin or the general
mode.

``rasterize_tiles`` is differentiable in ``table`` (the JAX
``rasterize_tiles`` custom_vjp, raster.py:2477-2519): its backward runs
kernel C, then kernel D (``ops/cuda/fold.py``) to fold the per-pair
gradients into the table. Rays, t-ranges and the binning get none.
``rasterize_tiles_table`` (JAX's table-gradient variant,
raster.py:2526-2572) computes the same forward and gradient, but its
backward sums kernel C's rows by particle id with kernel F
(``ops/cuda/scatter.py``) instead of D's depth-rank fold, so it needs no
FoldMeta. No render path of the port takes it, as none of JAX's does
(render/gut.py:268).

Kernels B and C also serve the TPU's flat-grid kernels
(raster.py:_fwd_flat_kernel, _bwd_flat_kernel): those compute the same
function on another schedule, one grid step per (tile, chunk) visit with
the compositing state carried in VMEM between a tile's visits, and B and
C already walk each tile's pairs in order inside one block.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ...utils.timer import ScopedTimer
from ..hit import _GG_SCALE, nht_hit_features, particle_response
from ..ut import TILE_PIXELS, TILE_X, TILE_Y
from . import build
from .fold import fold_pairs, fold_shared_segment
from .scatter import scatter_accumulate_rows

# a = M(o - p) (general mode: p) (3), M = diag(1/s) R^T (9), density, rgb(3)
RECORD_DIM = 16
# the NHT record: p (3), M (9), density, 4 x d control features, 3 pad;
# the kernels are built for d = 12 (64 floats, 24 ray features), the
# plain versions take any d
NHT_RECORD_DIM = 64
NHT_FEAT_SLOT = 13


class FoldMeta(NamedTuple):
    """The binning's map from tile-sorted pairs back to particles
    (``ops/binning.py:Binning``; the arguments of ``fold_pairs``). At
    least one of ``perm`` and ``inv_perm`` is given; kernel D reads the
    inverse, and inverts ``perm`` itself where it is missing (a shared
    segment's ``perm`` is the identity, which D's shared mode reads
    neither)."""
    perm: Optional[torch.Tensor]  # [P] i32 tile-sorted position -> pre slot
    order: torch.Tensor    # [N] i32 depth rank -> particle
    excl: torch.Tensor     # [N] i32 first pre-sort slot per depth rank
    counts: torch.Tensor   # [N] i32 slot count per depth rank
    limit: int             # pair slots kept (P)
    # [P] i32 pre-sort slot -> tile-sorted position
    inv_perm: Optional[torch.Tensor] = None
    # [] i32 pairs before the culled ones (tile_start[-1]); rows past it
    # are zero and are not read
    n_valid: Optional[torch.Tensor] = None


# the kernels are built for these degrees and sorted-mode windows: every
# shipped sorted config (3DGRT and the paper's sorted 3DGUT) composes
# sort_window 16 from configs/render/3dgrt.yaml; trace() composes windows
# of 128 (its TRACE_DEGREE, general mode only; common.cuh:launch_raster)
DEGREES = (2, 4)
WINDOWS = (16,)
TRACE_WINDOW = 128
TRACE_DEGREE = 4
# per-tile gradient rows of the shared-segment backward held at once: the
# tiles fold in groups of at most this many bytes of d_records
SHARED_BWD_BYTES = 1 << 30


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
    return cfg.sort_window if cfg.sorted_compositing else 0


def _mode(cfg, general: bool, shared: bool = False):
    """The launch arguments (degree, window, general, then the float
    parameters) shared by kernels B, C and E; raises for a mode kernels B
    and C are not built for (kernel E refuses windows of 128 itself)."""
    s, thr_resp, log_min_alpha = _thresholds(cfg)
    win = _window(cfg)
    trace_ok = general and cfg.kernel_degree == TRACE_DEGREE
    if win and win not in WINDOWS and not (trace_ok and win == TRACE_WINDOW):
        raise NotImplementedError(
            f"sort_window {win}: the raster kernels are built for {WINDOWS}"
            f" ({TRACE_WINDOW} in the general degree-{TRACE_DEGREE} mode)")
    if shared and not (trace_ok and win in (0, TRACE_WINDOW)):
        raise NotImplementedError(
            "shared segments: built for trace()'s mode only (general, "
            f"degree {TRACE_DEGREE}, window 0 or {TRACE_WINDOW})")
    return ((cfg.kernel_degree, win, int(general)),
            (cfg.min_transmittance, cfg.max_alpha, thr_resp, log_min_alpha,
             s))


def _grid(h, w):
    return (w + TILE_X - 1) // TILE_X, (h + TILE_Y - 1) // TILE_Y


def _is_nht(table, cfg, ray_o) -> bool:
    """Whether ``table`` holds NHT records (16 + 4 d floats, d >= 1);
    raises for a mode the kernels do not have (NHT runs in the general
    mode, in global-Z order) and, on the card, for d != 12."""
    width = table.shape[1] if table.ndim == 2 else 0
    if width == RECORD_DIM:
        return False
    if width <= RECORD_DIM or width % 4:
        raise ValueError(f"table {tuple(table.shape)}: records of "
                         f"{RECORD_DIM} floats, or 16 + 4 d for NHT")
    if ray_o is None or cfg.sorted_compositing:
        raise NotImplementedError("the NHT mode is general-geometry "
                                  "(ray_o given) and unsorted only")
    if table.device.type == "cuda" and width != NHT_RECORD_DIM:
        raise NotImplementedError(
            f"NHT records of {width} floats: the kernels are built for "
            f"{NHT_RECORD_DIM} (12 control features per vertex)")
    return True


def nht_control_dim(table) -> int:
    """The control features of an NHT table's records (4 d)."""
    return table.shape[1] - RECORD_DIM


def feature_dim(table) -> int:
    """The ray features a table composites: 3 (rgb), or 2 d for NHT."""
    if table.shape[1] == RECORD_DIM:
        return 3
    return nht_control_dim(table) // 2


def _check_inputs(table, pair_particle, tile_start, ray_d, tmin, tmax,
                  ray_o=None, shared=False):
    h, w = ray_d.shape[:2]
    gx, gy = _grid(h, w)
    dev = table.device
    check = build.check_tensor
    check("table", table, torch.float32, (table.shape[0], table.shape[1]),
          dev)
    check("pair_particle", pair_particle, torch.int32,
          (pair_particle.shape[0],), dev)
    check("tile_start", tile_start, torch.int32,
          (2,) if shared else (gx * gy + 1,), dev)
    check("ray_d", ray_d, torch.float32, (h, w, 3), dev)
    if ray_o is not None:
        check("ray_o", ray_o, torch.float32, (h, w, 3), dev)
    check("tmin", tmin, torch.float32, (h, w), dev)
    check("tmax", tmax, torch.float32, (h, w), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return h, w, gx, gy, dev


def rasterize_tiles(table: torch.Tensor, pair_particle: torch.Tensor,
                    tile_start: torch.Tensor, ray_d: torch.Tensor,
                    tmin: torch.Tensor, tmax: torch.Tensor, cfg,
                    fold: Optional[FoldMeta] = None,
                    ray_o: Optional[torch.Tensor] = None,
                    shared: bool = False):
    """Composite each tile's depth-ordered pairs front to back.

    Args:
        table: [C, 16] f32 per-particle record (a, M, density, rgb; in
            the general mode p, M, density, rgb), or [C, 64] NHT records
            (p, M, density, 48 control features, 3 pad; ``ray_o`` given).
        pair_particle: [P] i32 particle of each pair, tile-sorted.
        tile_start: [T + 1] i32 pair-segment boundaries per tile; with
            ``shared``, [2]: the one segment every tile composites.
        ray_d: [H, W, 3] f32 world ray directions (unit length for a
            shared origin; the general mode's hit distance scales with
            |d|, as JAX's does).
        tmin, tmax: [H, W] f32 per-ray t-range.
        cfg: RasterConfig.
        fold: the binning's FoldMeta; needed when ``table`` requires
            grad, for the backward's fold into the table. With
            ``shared``, the FoldMeta of the one segment (its P slots),
            which the backward applies to each slot's sum over the tiles
            (``fold_shared_segment``).
        ray_o: [H, W, 3] f32 per-pixel world ray origins: the general
            mode. None: every ray starts at the origin the table's a was
            built from.
        shared: every tile composites the one segment of ``tile_start``.

    Returns (features [H,W,F], opacity [H,W,1], depth [H,W,1],
    hits [H,W,1]), all f32, F = 3 or 24 (NHT); hits carries no gradient.
    With ``cfg.enable_normals`` a fifth, normals [H,W,3], no gradient.
    """
    if fold is None and torch.is_grad_enabled() and table.requires_grad:
        raise ValueError("table requires grad: pass the binning's "
                         "FoldMeta, which the backward needs")
    with ScopedTimer("grut.raster"):
        return _rasterize(table, pair_particle, tile_start, ray_d, tmin,
                          tmax, cfg, fold, ray_o, shared)


def _rasterize(table, pair_particle, tile_start, ray_d, tmin, tmax, cfg,
               fold, ray_o, shared):
    """``_Rasterize`` where ``table`` takes a gradient, else kernel B
    alone; the outputs without t_final."""
    if torch.is_grad_enabled() and table.requires_grad:
        out = _Rasterize.apply(table, pair_particle, tile_start, ray_d,
                               tmin, tmax, cfg, fold, ray_o, shared)
    else:
        out = rasterize_tiles_forward(table, pair_particle, tile_start,
                                      ray_d, tmin, tmax, cfg, ray_o, shared)
    return out[:4] + out[5:]


# kernel B launches (by rasterize_tiles and rasterize_tiles_forward), in
# the shared-origin, the general, the NHT mode, trace()'s shared segments
# and windows of 128, and the normals mode
rasterize_tiles.launches = 0
rasterize_tiles.launches_general = 0
rasterize_tiles.launches_nht = 0
rasterize_tiles.launches_shared_segment = 0
rasterize_tiles.launches_window128 = 0
rasterize_tiles.launches_normals = 0


def _count(fn, cfg, ray_o, nht=False, shared=False, normals=False):
    """Count one launch of ``fn`` in the counter of its mode."""
    if normals:
        fn.launches_normals += 1
    elif nht:
        fn.launches_nht += 1
    elif shared:
        fn.launches_shared_segment += 1
    elif cfg.sorted_compositing and cfg.sort_window == TRACE_WINDOW:
        fn.launches_window128 += 1
    elif ray_o is None:
        fn.launches += 1
    else:
        fn.launches_general += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _normals_on(cfg, nht) -> bool:
    if cfg.enable_normals and nht:
        raise NotImplementedError("normals with NHT records: JAX blends "
                                  "normals for constant features only")
    return cfg.enable_normals


def rasterize_tiles_forward(table, pair_particle, tile_start, ray_d, tmin,
                            tmax, cfg, ray_o=None, shared=False):
    """Kernel B: (features [H, W, F], opacity, depth, hits, T_final), the
    last four [H, W, 1], and with ``cfg.enable_normals`` normals
    [H, W, 3]. No autograd."""
    h, w, gx, gy, dev = _check_inputs(table, pair_particle, tile_start,
                                      ray_d, tmin, tmax, ray_o, shared)
    nht = _is_nht(table, cfg, ray_o)
    normals = _normals_on(cfg, nht)
    ints, floats = _mode(cfg, ray_o is not None, shared)
    if dev.type == "cpu":
        return rasterize_tiles_plain(table, pair_particle, tile_start,
                                     ray_d, tmin, tmax, cfg, ray_o, shared)
    feat = torch.empty((h, w, feature_dim(table)), dtype=torch.float32,
                       device=dev)
    opacity, depth, hits, t_final = (
        torch.empty((h, w, 1), dtype=torch.float32, device=dev)
        for _ in range(4))
    nrm = (torch.empty((h, w, 3), dtype=torch.float32, device=dev)
           if normals else None)
    lib = _lib("raster_fwd")
    err = lib.raster_fwd_launch(
        table.data_ptr(), pair_particle.data_ptr(), tile_start.data_ptr(),
        _ptr(ray_o), ray_d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        w, h, gx, gx * gy, *ints, int(nht), int(shared), int(normals),
        *floats, feat.data_ptr(), opacity.data_ptr(), depth.data_ptr(),
        hits.data_ptr(), t_final.data_ptr(), _ptr(nrm),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("raster_fwd", err, lib)
    _count(rasterize_tiles, cfg, ray_o, nht, shared, normals)
    out = (feat, opacity, depth, hits, t_final)
    return out + (nrm,) if normals else out


def rasterize_tiles_backward(table, pair_particle, tile_start, ray_d, tmin,
                             tmax, feat, depth, t_final, g_feat, g_opacity,
                             g_depth, cfg, ray_o=None,
                             shared=False) -> torch.Tensor:
    """Kernel C: per-pair record gradients d_records [P, R] f32 (R the
    table's width) in tile-sorted pair order, from the saved forward
    outputs (features [H,W,F], depth and T_final [H,W,1]) and the
    upstream gradients of features [H,W,F], opacity and depth [H,W,1].
    Pairs past the last tile (culled) and pairs behind every pixel's kill
    read zero. In the general mode (``ray_o``) rows 0-2 are d/dp and 3-11
    d/dM of the general table; the NHT mode adds the 48 control
    features' rows (its 3 padding rows read zero). With ``shared``,
    [T n, R]: row t n + j is tile t's gradient of slot j of the segment
    (n = tile_start[1] - tile_start[0]). ``cfg.enable_normals`` changes
    nothing here: normals carry no cotangent."""
    h, w, gx, gy, dev = _check_inputs(table, pair_particle, tile_start,
                                      ray_d, tmin, tmax, ray_o, shared)
    nht = _is_nht(table, cfg, ray_o)
    nf = feature_dim(table)
    for name, t, c in (("feat", feat, nf), ("depth", depth, 1),
                       ("t_final", t_final, 1), ("g_feat", g_feat, nf),
                       ("g_opacity", g_opacity, 1), ("g_depth", g_depth, 1)):
        build.check_tensor(name, t, torch.float32, (h, w, c), dev)
    ints, floats = _mode(cfg, ray_o is not None, shared)
    if dev.type == "cpu":
        return rasterize_tiles_backward_plain(
            table, pair_particle, tile_start, ray_d, tmin, tmax, feat, depth,
            t_final, g_feat, g_opacity, g_depth, cfg, ray_o, shared)
    p = (gx * gy * int(tile_start[1] - tile_start[0]) if shared
         else pair_particle.shape[0])
    d_records = torch.zeros((p, table.shape[1]), dtype=torch.float32,
                            device=dev)
    lib = _lib("raster_bwd")
    err = lib.raster_bwd_launch(
        table.data_ptr(), pair_particle.data_ptr(), tile_start.data_ptr(),
        _ptr(ray_o), ray_d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        feat.data_ptr(), depth.data_ptr(), t_final.data_ptr(),
        g_feat.data_ptr(), g_opacity.data_ptr(), g_depth.data_ptr(), w, h,
        gx, gx * gy,
        *ints, int(nht), int(shared), *floats, d_records.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("raster_bwd", err, lib)
    _count(rasterize_tiles_backward, cfg, ray_o, nht, shared)
    return d_records


rasterize_tiles_backward.launches = 0
rasterize_tiles_backward.launches_general = 0
rasterize_tiles_backward.launches_nht = 0
rasterize_tiles_backward.launches_shared_segment = 0
rasterize_tiles_backward.launches_window128 = 0


def repeat_fold(fold: FoldMeta, n_tiles: int) -> FoldMeta:
    """The FoldMeta of a shared segment's per-tile gradient rows: ``fold``
    describes the segment's P slots once; kernel C's row t P + j is tile
    t's copy of slot j. Slot s of ``fold`` becomes the pre-sort slots
    s T + t, so each depth rank owns its slots' T tiles in tile order.
    With ``fold_pairs_plain`` it is the plain composition that
    ``fold_shared_segment`` is held against; no render path builds it."""
    p = fold.perm.shape[0]
    tiles = torch.arange(n_tiles, dtype=torch.int32, device=fold.perm.device)
    perm = (fold.perm[None, :] * n_tiles + tiles[:, None]).reshape(-1)
    return FoldMeta(perm, fold.order, fold.excl * n_tiles,
                    fold.counts * n_tiles, fold.limit * n_tiles)


def _tile_row_groups(h, w, n_seg, width):
    """[r0, r1) image rows of tile-row groups whose shared-segment gradient
    rows stay within SHARED_BWD_BYTES."""
    gx, gy = _grid(h, w)
    per_row = gx * n_seg * width * 4
    step = max(1, SHARED_BWD_BYTES // max(per_row, 1))
    for t0 in range(0, gy, step):
        yield t0 * TILE_Y, min((t0 + step) * TILE_Y, h)


class _Rasterize(torch.autograd.Function):
    """Kernel B forward; kernel C then kernel D backward, giving the
    gradient of ``table`` only (raster.py:_rasterize_fwd/_rasterize_bwd
    with render/gut.py:_grf_bwd). With no ``fold``, the table route:
    kernel C then kernel F by ``pair_particle``
    (raster.py:_rasterize_table_bwd)."""

    @staticmethod
    def forward(ctx, table, pair_particle, tile_start, ray_d, tmin, tmax,
                cfg, fold, ray_o, shared):
        out = rasterize_tiles_forward(table, pair_particle, tile_start,
                                      ray_d, tmin, tmax, cfg, ray_o, shared)
        feat, opacity, depth, hits, t_final = out[:5]
        ctx.save_for_backward(table, pair_particle, tile_start, ray_d, tmin,
                              tmax, feat, depth, t_final, ray_o)
        ctx.cfg = cfg
        ctx.fold = fold
        ctx.shared = shared
        ctx.mark_non_differentiable(hits, t_final, *out[5:])
        return out

    @staticmethod
    def backward(ctx, g_feat, g_opacity, g_depth, _g_hits, _g_tfinal,
                 *_g_normals):
        (table, pair_particle, tile_start, ray_d, tmin, tmax, feat, depth,
         t_final, ray_o) = ctx.saved_tensors

        def grad_or_zeros(g, like):
            return (torch.zeros_like(like) if g is None
                    else g.to(torch.float32).contiguous())

        ups = (grad_or_zeros(g_feat, feat), grad_or_zeros(g_opacity, depth),
               grad_or_zeros(g_depth, depth))
        f = ctx.fold
        if not ctx.shared:
            d_records = rasterize_tiles_backward(
                table, pair_particle, tile_start, ray_d, tmin, tmax, feat,
                depth, t_final, *ups, ctx.cfg, ray_o)
            if f is None:
                d_table = scatter_accumulate_rows(d_records, pair_particle,
                                                  table.shape[0])
            else:
                d_table = fold_pairs(d_records, f.perm, f.order, f.excl,
                                     f.counts, f.limit, table.shape[0],
                                     f.inv_perm, f.n_valid)
            return (d_table,) + (None,) * 9
        # shared segment: the tiles' gradient rows fold in groups of tile
        # rows, summed in group order
        h, w = ray_d.shape[:2]
        n_seg = int(tile_start[1] - tile_start[0])
        d_table = None
        for r0, r1 in _tile_row_groups(h, w, n_seg, table.shape[1]):
            def rows(t):
                return None if t is None else t[r0:r1].contiguous()
            d_records = rasterize_tiles_backward(
                table, pair_particle, tile_start, rows(ray_d), rows(tmin),
                rows(tmax), rows(feat), rows(depth), rows(t_final),
                *(rows(u) for u in ups), ctx.cfg, rows(ray_o), shared=True)
            part = fold_shared_segment(
                d_records, d_records.shape[0] // n_seg, f.order, f.excl,
                f.counts, f.limit, table.shape[0])
            d_table = part if d_table is None else d_table + part
        return (d_table,) + (None,) * 9


def rasterize_tiles_table(table: torch.Tensor, pair_particle: torch.Tensor,
                          tile_start: torch.Tensor, ray_d: torch.Tensor,
                          tmin: torch.Tensor, tmax: torch.Tensor, cfg,
                          ray_o: Optional[torch.Tensor] = None):
    """``rasterize_tiles`` whose table gradient is a sum of the per-pair
    gradients by particle id (raster.py:rasterize_tiles_table): forward
    kernel B; backward kernel C, then kernel F on ``pair_particle``.

    Takes the 16-wide records only (degrees 2 and 4, global-Z order or
    windows, shared or per-pixel origins); NHT records raise, as kernel F
    takes at most 16 floats. Pairs past the last tile (culled) reach F
    with a zero gradient and their own, valid particle id, as JAX zeroes
    the chunks past the last segment before its scatter
    (raster.py:2559-2566). Returns what ``rasterize_tiles`` returns."""
    if table.ndim != 2 or table.shape[1] != RECORD_DIM:
        raise ValueError(f"table {tuple(table.shape)}: the table route takes "
                         f"{RECORD_DIM}-float records (NHT folds with kernel "
                         "D through rasterize_tiles)")
    return _rasterize(table, pair_particle, tile_start, ray_d, tmin, tmax,
                      cfg, None, ray_o, False)


_SIGNATURES = {
    # ptrs, ints, floats, ptrs (outputs), stream
    "raster_fwd": (7, 10, 5, 6),
    "raster_bwd": (13, 9, 5, 1),
    "wmax": (7, 7, 5, 1),      # kernel E, ops/cuda/wmax.py
}


def nht_kernel_attributes():
    """{nht2, nht4: {registers, local_bytes, shared_bytes,
    dynamic_shared_bytes}} of kernel C's NHT mode at degree 2 and 4."""
    att = build.attributes("raster_bwd", _BWD_ATTRIBUTES)
    return {k: att[k] for k in ("nht2", "nht4")}


# the kernels raster_bwd_attributes and raster_fwd_attributes list: C's
# NHT and trace modes, then its RGB modes by degree, window and geometry
# (rgb_<degree>_w<window>[_general]; rgb_4_w0_shared: trace()'s brute force
# in rank order); B's trace and NHT modes, then its RGB modes (without
# normals) as C's
_RGB_MODES = ("rgb_2_w0", "rgb_4_w0", "rgb_2_w16", "rgb_4_w16",
              "rgb_2_w0_general", "rgb_4_w0_general", "rgb_2_w16_general",
              "rgb_4_w16_general")
_BWD_ATTRIBUTES = ("nht2", "nht4", "trace_grid", "trace_shared") + \
    _RGB_MODES + ("rgb_4_w0_shared",)
_FWD_ATTRIBUTES = ("trace_grid", "trace_shared", "nht2", "nht4") + _RGB_MODES


def rgb_kernel_attributes(kernel: str = "raster_bwd"):
    """{rgb_<degree>_w<window>[_general|_shared]: {registers, local_bytes,
    shared_bytes, dynamic_shared_bytes}} of kernel C's RGB modes
    (raster_bwd.cu:raster_bwd_kernel), or with ``kernel="raster_fwd"``
    kernel B's (raster_fwd.cu:raster_fwd_rgb_kernel, without normals)."""
    att = build.attributes(kernel, _BWD_ATTRIBUTES if kernel == "raster_bwd"
                           else _FWD_ATTRIBUTES)
    return {k: v for k, v in att.items() if k.startswith("rgb_")}


def nht_fwd_kernel_attributes():
    """{nht2, nht4: {registers, ...}} of kernel B's NHT mode
    (raster_fwd.cu:raster_fwd_nht_kernel) at degree 2 and 4."""
    att = build.attributes("raster_fwd", _FWD_ATTRIBUTES)
    return {k: att[k] for k in ("nht2", "nht4")}


def trace_kernel_attributes():
    """{B grid, B shared, C grid, C shared: {registers, local_bytes,
    shared_bytes, dynamic_shared_bytes}} of kernels B and C in trace()'s
    windows of 128 over per-block segments (the grid) and over a shared
    segment (kernel 7)."""
    fwd = build.attributes("raster_fwd", _FWD_ATTRIBUTES)
    bwd = build.attributes("raster_bwd", _BWD_ATTRIBUTES)
    return {"B grid": fwd["trace_grid"], "B shared": fwd["trace_shared"],
            "C grid": bwd["trace_grid"], "C shared": bwd["trace_shared"]}


def window_overflows(reset: bool = False):
    """{raster_fwd, raster_bwd: the k-buffer's extra passes} of kernels B
    and C in trace()'s windows of 128 since the last reset: one for each
    time a ray accepted more than TRACE_K candidates of a window it
    reached alive (common.cuh:g_window_overflows). ``reset`` zeroes them
    after reading. Needs the card."""
    out = {}
    for name in ("raster_fwd", "raster_bwd"):
        lib = build.load(name)
        fn = lib.window_overflows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        n = ctypes.c_ulonglong(0)
        build.check_launch("window_overflows",
                           fn(ctypes.addressof(n), int(reset)), lib)
        out[name] = int(n.value)
    return out


# kernels B and C take their NHT fast sine and cosine for |x| up to this
# (common.cuh:kTrigFastMax, 2^20), the accurate sincosf past it
NHT_TRIG_FAST_MAX = 1048576.0


def nht_sincos(x: torch.Tensor):
    """(sin x, cos x) as kernels B and C compute an NHT hit's (common.cuh:
    sincos_fast within NHT_TRIG_FAST_MAX), for a float32 tensor; on the
    CPU ``nht_sincos_plain``. Measures the function; no path calls it."""
    build.check_tensor("x", x, torch.float32, tuple(x.shape), x.device)
    if x.device.type == "cpu":
        return nht_sincos_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    s, c = torch.empty_like(x), torch.empty_like(x)
    lib = _lib("raster_bwd")
    fn = lib.nht_sincos_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p]
        fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), x.numel(), s.data_ptr(), c.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("nht_sincos", err, lib)
    return s, c


def nht_sincos_plain(x: torch.Tensor):
    """Plain version of ``nht_sincos``: its Cody-Waite step in float32
    (each FMA as the float64 sum of its exact product, rounded), then sin
    and cos of the reduced argument in float64 for the SFU's, rounded to
    float32; past NHT_TRIG_FAST_MAX sin and cos of x itself."""
    x32 = x.to(torch.float32)
    j = torch.round(x32 * 0.159154937).to(torch.float32)
    jd, xd = j.double(), x32.double()
    r = (xd - jd * float(torch.tensor(6.28318548, dtype=torch.float32))
         ).to(torch.float32).double()
    r = (r - jd * float(torch.tensor(-1.74845553e-07, dtype=torch.float32))
         ).to(torch.float32).double()
    far = x32.abs() > NHT_TRIG_FAST_MAX
    r = torch.where(far, xd, r)
    return torch.sin(r).to(torch.float32), torch.cos(r).to(torch.float32)


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
# ~25 float64 arrays for autograd, so it takes smaller groups). NHT's
# temporaries are [pairs, 256, 12-24]: 8x smaller groups.
_PLAIN_GROUP_PAIRS = 1 << 17
_PLAIN_BWD_GROUP_PAIRS = 1 << 14
_NHT_GROUP_SHRINK = 8


class _Tiled(NamedTuple):
    """Per-tile views of the rays ([T, 256, .]) and the tile grid; ``ro``
    is None in the shared-origin mode."""
    rd: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    gx: int
    gy: int
    ro: Optional[torch.Tensor] = None


def _tilize_rays(ray_d, tmin, tmax, ray_o=None) -> _Tiled:
    h, w = ray_d.shape[:2]
    gx, gy = _grid(h, w)
    return _Tiled(_tilize(ray_d, gx, gy, 1.0),
                  _tilize(tmin[..., None], gx, gy, 0.0)[..., 0],
                  _tilize(tmax[..., None], gx, gy, -1.0)[..., 0],  # empty
                  gx, gy,
                  None if ray_o is None else _tilize(ray_o, gx, gy, 0.0))


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


def _canonical_hit(rec, d, o=None):
    """(a, b, inv_m, sq, q) of records [P, R] on ray dirs [P, 256, 3] in
    the fp32 operation order of common.cuh:eval_hit (``Hit``): a and b
    triples of [P, 256] components, a from the record, or with per-pixel
    origins ``o`` [P, 256, 3] the general mode's (eval_hit_general) a =
    M (o - p) from the position p in slots 0-2; b = M d; inv_m = 1 / |b|^2;
    sq = |a x b|^2 inv_m; q = a . b."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    def col(i):
        return rec[:, i:i + 1]

    if o is None:
        ax, ay, az = col(0), col(1), col(2)
    else:
        ex, ey, ez = o[..., 0] - col(0), o[..., 1] - col(1), \
            o[..., 2] - col(2)
        ax = col(3) * ex + col(4) * ey + col(5) * ez
        ay = col(6) * ex + col(7) * ey + col(8) * ez
        az = col(9) * ex + col(10) * ey + col(11) * ez
    bx = col(3) * dx + col(4) * dy + col(5) * dz
    by = col(6) * dx + col(7) * dy + col(8) * dz
    bz = col(9) * dx + col(10) * dy + col(11) * dz
    cx = ay * bz - az * by
    cy = az * bx - ax * bz
    cz = ax * by - ay * bx
    inv_m = 1.0 / torch.clamp(bx * bx + by * by + bz * bz, min=1e-30)
    sq = (cx * cx + cy * cy + cz * cz) * inv_m
    return (ax, ay, az), (bx, by, bz), inv_m, sq, ax * bx + ay * by + az * bz


def _hit_terms(rec, d, o=None, canonical=False):
    """(sq, hit_t) [P, 256] of ``_canonical_hit``, hit_t = -q inv_m (with
    origins ``o``, eval_hit_general: scaled by |d|). With ``canonical``
    also the canonical hit point [P, 256, 3], a + b tc with tc the
    unscaled hit distance (common.cuh:nht_hit)."""
    a, b, inv_m, sq, q = _canonical_hit(rec, d, o)
    tc = -q * inv_m
    hit_t = tc
    if o is not None:
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        hit_t = tc * torch.sqrt(dx * dx + dy * dy + dz * dz)
    if not canonical:
        return sq, hit_t
    return sq, hit_t, torch.stack([a[i] + b[i] * tc for i in range(3)],
                                  dim=-1)


# the cull of kernels B and E in their RGB modes and of trace's B and C
# (common.cuh): fp32's unit roundoff and trace's k-buffer size
_EPS = 2.0 ** -24
TRACE_K = 8
_BUNDLE_PLANES, _BUNDLE_NONE, _BUNDLE_ALL = 0, 1, 2


def _row_norms_plain(rec):
    """[3] x [P]: |M row i|^2 of records [P, 16] (common.cuh:cull_radius's
    m[i])."""
    return [rec[:, 3 + 3 * i] * rec[:, 3 + 3 * i]
            + rec[:, 4 + 3 * i] * rec[:, 4 + 3 * i]
            + rec[:, 5 + 3 * i] * rec[:, 5 + 3 * i] for i in range(3)]


def _cull_radii_plain(rec, thr):
    """(a, b, a2, b2) [P] of records [P, 16] and their thresholds [P]:
    common.cuh:cull_radius and stage_cull in their fp32 operation order."""
    m = _row_norms_plain(rec)
    mn = torch.minimum(torch.minimum(m[0], m[1]), m[2])
    mx = torch.maximum(torch.maximum(m[0], m[1]), m[2])
    kap = torch.sqrt(mx / mn)
    k1 = 1.0 + kap
    a = torch.sqrt(thr / mn) * (1.0001 + (16.0 * _EPS) * kap)
    b = (64.0 * _EPS) * k1 * k1
    return a, b, 1.0625 * a * a, 17.0 * b * b


def _cull_centres_plain(rec, general):
    """[P, 3] common.cuh:cull_sphere's centres: the general mode's p, or a
    shared-origin record's p - o = -M^T diag(1 / |M row i|^2) a."""
    if general:
        return rec[:, 0:3]
    m = _row_norms_plain(rec)
    u = [rec[:, i] / m[i] for i in range(3)]
    return torch.stack([-(rec[:, 3 + j] * u[0] + rec[:, 6 + j] * u[1]
                          + rec[:, 9 + j] * u[2]) for j in range(3)], dim=1)


def _warp_bundles_plain(o, d, tmin, tmax, dn=None):
    """common.cuh:warp_bundle of rays [G, 32, 3] (origins, directions) and
    t-ranges [G, 32], group by group, in its fp32 operation order: (mode
    [G], apex c [G, 3], rho [G], unit plane normals [G, 5, 3]). ``dn``
    [G, 32]: the kernels' |d| (1 in the shared-origin mode), by default
    computed from d."""
    g = o.shape[0]
    dev = o.device
    valid = tmax > tmin
    l0 = torch.argmax(valid.to(torch.int32), dim=1)
    rows = torch.arange(g, device=dev)
    c = o[rows, l0]
    a = d[rows, l0]
    an = 1.0 / torch.sqrt(a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1]
                          + a[:, 2] * a[:, 2])
    a = a * an[:, None]
    oo = o - c[:, None]
    rho = torch.where(valid, torch.sqrt(oo[..., 0] * oo[..., 0]
                                        + oo[..., 1] * oo[..., 1]
                                        + oo[..., 2] * oo[..., 2]),
                      torch.zeros_like(oo[..., 0])).amax(1)
    ax, ay, az = a[:, None, 0], a[:, None, 1], a[:, None, 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    da = dx * ax + dy * ay + dz * az
    q = torch.stack([dx - da * ax, dy - da * ay, dz - da * az], dim=-1)
    q2 = q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1] + q[..., 2] * q[..., 2]
    if dn is None:
        dn = torch.sqrt(dx * dx + dy * dy + dz * dz)
    off = (valid & ((tmin < 0.0) | ~(da >= 0.2 * dn))).any(1)
    key = torch.where(valid, q2, torch.full_like(q2, -1.0))
    lu = torch.argmax((key == key.amax(1, keepdim=True)).to(torch.int32),
                      dim=1)
    u = q[rows, lu]
    flat = ~(q2[rows, lu] > 1e-12)
    fa = a.abs()
    ex = (fa[:, 0] <= fa[:, 1]) & (fa[:, 0] <= fa[:, 2])
    ey = ~ex & (fa[:, 1] <= fa[:, 2])
    axis = torch.stack([ex, ey, ~ex & ~ey], dim=1).to(a.dtype)
    u = torch.where(flat[:, None], axis, u)
    ua = u[:, 0] * a[:, 0] + u[:, 1] * a[:, 1] + u[:, 2] * a[:, 2]
    u = u - ua[:, None] * a
    un = 1.0 / torch.sqrt(u[:, 0] * u[:, 0] + u[:, 1] * u[:, 1]
                          + u[:, 2] * u[:, 2])
    u = u * un[:, None]
    v = torch.stack([a[:, 1] * u[:, 2] - a[:, 2] * u[:, 1],
                     a[:, 2] * u[:, 0] - a[:, 0] * u[:, 2],
                     a[:, 0] * u[:, 1] - a[:, 1] * u[:, 0]], dim=1)
    gx = (dx * u[:, None, 0] + dy * u[:, None, 1] + dz * u[:, None, 2]) / da
    gy = (dx * v[:, None, 0] + dy * v[:, None, 1] + dz * v[:, None, 2]) / da
    inf = torch.full_like(gx, math.inf)
    bounds = []
    for gv in (gx, gy):
        hi = torch.where(valid, gv, -inf).amax(1)
        lo = torch.where(valid, gv, inf).amin(1)
        bounds += [hi + 1e-5 * (1.0 + hi.abs()), lo - 1e-5 * (1.0 + lo.abs())]
    xmax, xmin, ymax, ymin = (x[:, None] for x in bounds)
    pl = torch.stack([u - xmax * a, xmin * a - u, v - ymax * a, ymin * a - v,
                      -a], dim=1)                             # [G, 5, 3]
    s = 1.0 / torch.sqrt(pl[..., 0] * pl[..., 0] + pl[..., 1] * pl[..., 1]
                         + pl[..., 2] * pl[..., 2])
    mode = torch.where(off, _BUNDLE_ALL, _BUNDLE_PLANES)
    mode = torch.where(valid.any(1), mode, _BUNDLE_NONE)
    return mode, c, rho, pl * s[..., None]


def _bundle_keeps_plain(bundle, p, a, b):
    """[P] common.cuh:bundle_keeps of particles at p [P, 3] with radii
    (a, b) [P] in bundles indexed per particle (mode [P], c [P, 3], rho
    [P], n [P, 5, 3])."""
    mode, c, rho, n = bundle
    x = p - c
    length = torch.sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
                        + x[:, 2] * x[:, 2])
    reach = a + 2.0 * b * (length + rho) + rho
    dots = (x[:, None, 0] * n[..., 0] + x[:, None, 1] * n[..., 1]
            + x[:, None, 2] * n[..., 2])
    inside = ~(dots > reach[:, None]).any(1)
    return torch.where(mode == _BUNDLE_PLANES, inside, mode == _BUNDLE_ALL)


def _sphere_keeps_plain(e, d, a2, b2):
    """[P, 256] common.cuh:sphere_keeps of e = o - p and directions d
    [P, 256, 3] with squared radii (a2, b2) [P, 1]."""
    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    cx = ey * dz - ez * dy
    cy = ez * dx - ex * dz
    cz = ex * dy - ey * dx
    c2 = cx * cx + cy * cy + cz * cz
    e2 = ex * ex + ey * ey + ez * ez
    dd = dx * dx + dy * dy + dz * dz
    return ~(c2 >= (a2 + b2 * e2) * dd)


def _plane_quads_plain(n):
    """[..., 4, 6] common.cuh:plane_quads of unit plane normals [..., 5,
    3]: the four side planes' nx^2, ny^2, nz^2, 2 nx ny, 2 nx nz,
    2 ny nz."""
    nx, ny, nz = n[..., :4, 0], n[..., :4, 1], n[..., :4, 2]
    return torch.stack([nx * nx, ny * ny, nz * nz, 2.0 * nx * ny,
                        2.0 * nx * nz, 2.0 * ny * nz], dim=-1)


def _cull_quadric_plain(rec, thr):
    """[P, 6] common.cuh:cull_quadric of records [P, 16] with thresholds
    [P]: the acceptance ellipsoid's quadric (q00, q11, q22, q01, q02,
    q12), in its fp32 operation order."""
    m = _row_norms_plain(rec)
    w = [(1.0 / m[k]) * (1.0 / m[k]) for k in range(3)]
    mn = torch.minimum(torch.minimum(m[0], m[1]), m[2])
    mx = torch.maximum(torch.maximum(m[0], m[1]), m[2])
    g = thr * (1.0003 + (256.0 * _EPS) * (mx / mn))

    def entry(j, k):
        return (rec[:, 3 + j] * rec[:, 3 + k] * w[0]
                + rec[:, 6 + j] * rec[:, 6 + k] * w[1]
                + rec[:, 9 + j] * rec[:, 9 + k] * w[2]) * g

    return torch.stack([entry(0, 0), entry(1, 1), entry(2, 2), entry(0, 1),
                        entry(0, 2), entry(1, 2)], dim=1)


def _ellipsoid_keeps_plain(bundle, quads, p, a, b, q):
    """[P] common.cuh:ellipsoid_keeps (with stage_rgb_row's slack) of
    particles centred at p [P, 3] with sphere radius a, b [P] and
    quadrics q [P, 6] in bundles and side-plane monomials [P, 4, 6]
    indexed per particle."""
    mode, c, rho, n = bundle
    x = p - c
    length = torch.sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
                        + x[:, 2] * x[:, 2])
    base = 2.0 * b * (length + rho) + rho
    dots = (x[:, None, 0] * n[..., 0] + x[:, None, 1] * n[..., 1]
            + x[:, None, 2] * n[..., 2])                        # [P, 5]
    out = dots[:, 4] > a + base
    a2 = a * a
    for i in range(4):
        m = quads[:, i]
        e2 = (q[:, 0] * m[:, 0] + q[:, 1] * m[:, 1] + q[:, 2] * m[:, 2]
              + q[:, 3] * m[:, 3] + q[:, 4] * m[:, 4] + q[:, 5] * m[:, 5])
        d = dots[:, i] - base
        out |= (d > 0.0) & (d * d > torch.fmin(e2, a2))
    return torch.where(mode == _BUNDLE_PLANES, ~out, mode == _BUNDLE_ALL)


def _warp_of_pixel(trace):
    """[256] the warp of each pixel of a tile (row-major 16 x 16): trace's
    kernels give warp w the rows 2w and 2w + 1; kernels B and E in their
    RGB modes the 8x4 block (w % 2, w / 2) (common.cuh:warp_block_x)."""
    t = torch.arange(TILE_PIXELS)
    if trace:
        return t // 32
    x, y = t % TILE_X, t // TILE_X
    return (y // 4) * 2 + x // 8


class _Cull(NamedTuple):
    """The cull's per-view set-up (``_cull_setup``): the kernels' warp of
    each pixel, each warp's bundle ([T, 8, ...] of
    ``_warp_bundles_plain``) and, where B and E test the ellipsoid (their
    RGB modes at degree 2 in global-Z order), its side planes' monomials
    ([T, 8, 4, 6])."""
    trace: bool
    general: bool
    warp_of: torch.Tensor
    bundles: tuple
    quads: Optional[torch.Tensor]


def _cull_setup(rays: _Tiled, cfg, shared) -> _Cull:
    """The warps' bundles of a launch on ``rays``: trace's kernels
    (windows of 128, or a shared segment) or B's and E's RGB modes."""
    trace = shared or _window(cfg) == TRACE_WINDOW
    general = rays.ro is not None
    warp_of = _warp_of_pixel(trace).to(rays.rd.device)
    by_warp = torch.argsort(warp_of, stable=True)     # warp-major pixels
    rd = rays.rd[:, by_warp]
    ro = rays.ro[:, by_warp] if general else torch.zeros_like(rd)
    bundles = _warp_bundles_plain(
        ro.reshape(-1, 32, 3), rd.reshape(-1, 32, 3),
        rays.tmin[:, by_warp].reshape(-1, 32),
        rays.tmax[:, by_warp].reshape(-1, 32),
        None if general else torch.ones_like(rd[..., 0]).reshape(-1, 32))
    bundles = tuple(x.reshape(rays.rd.shape[0], 8, *x.shape[1:])
                    for x in bundles)
    ellipsoid = (not trace and not cfg.sorted_compositing
                 and cfg.kernel_degree == 2)
    return _Cull(trace, general, warp_of, bundles,
                 _plane_quads_plain(bundles[3]) if ellipsoid else None)


def _cull_keeps(cull: _Cull, rec, tile, d, o, thr):
    """(pyramid, sphere) [P, 256]: the (pair, pixel) each test keeps, for
    records ``rec`` [P, 16] of tiles ``tile`` [P] with thresholds ``thr``
    [P] (rays d, o [P, 256, 3]). Trace's kernels test each warp's pyramid
    against the sphere, then each ray's sphere; B's and E's RGB modes the
    pyramid against the ellipsoid (degree 2 in global-Z order) or the
    sphere (common.cuh:stage_rgb_row), with no per-ray test (all kept)."""
    a, b, a2, b2 = _cull_radii_plain(rec, thr)
    if not cull.general:
        b = b + 64.0 * _EPS
    centre = _cull_centres_plain(rec, cull.general)
    if cull.quads is None:     # the sphere: bundle_keeps
        keep = torch.stack([_bundle_keeps_plain(
            tuple(x[tile, w] for x in cull.bundles), centre, a, b)
            for w in range(8)], dim=1)
    else:
        q = _cull_quadric_plain(rec, thr)
        keep = torch.stack([_ellipsoid_keeps_plain(
            tuple(x[tile, w] for x in cull.bundles), cull.quads[tile, w],
            centre, a, b, q) for w in range(8)], dim=1)
    keep = keep[:, cull.warp_of]                                # [P, 256]
    if not cull.trace:
        return keep, torch.ones_like(keep)
    return keep, _sphere_keeps_plain(o - rec[:, None, 0:3], d, a2[:, None],
                                     b2[:, None])


def _sq_thresholds(rec, cfg):
    """[P] common.cuh:sq_threshold of records [P, R]."""
    s, thr_resp, log_min_alpha = _thresholds(cfg)
    thr = torch.clamp((log_min_alpha - torch.log(
        torch.clamp(rec[:, 12], min=1e-30))) / s, max=thr_resp)
    if cfg.kernel_degree == 4:
        thr = torch.sqrt(torch.clamp(thr, min=0.0))
    return thr


def cull_plain(table, pair_particle, tile_start, ray_d, tmin, tmax, cfg,
               ray_o=None, shared=False):
    """Hold the cull of a kernel launch against the exact test, on the
    kernels' arguments: kernels B and E in their RGB modes (each warp of
    8x4 pixels tests the particle's ellipsoid, at degree 2 in global-Z
    order, or its sphere against its pyramid, then the exact test; a
    shared-origin record's centre re-derived from a,
    common.cuh:stage_rgb_row; B at degree 4 in global-Z order tests every
    pair, and E's cull is what this counts there), or
    trace's B and C (windows of 128 or a shared segment: warps of 16x2
    pixels, each ray's sphere test after the pyramid's). The cull runs in
    the kernels' fp32 operation order, the accept test is ``_hit_terms``'.
    Returns a dict of counts over every (pair, pixel) of the tiles:
    ``tests``; ``bundle_culled`` (outside the warp's pyramid),
    ``sphere_culled`` (in it, but the ray's line misses the sphere: trace
    only); ``accepted``; ``culled_accepted`` (culled but accepted: must
    be 0); per ray and window (windows of 128, 16, or single pairs in
    global-Z order) ``over_k`` (windows with more than TRACE_K accepted,
    for trace an upper bound of the k-buffer's extra first passes: the
    kill may stop the ray before) and ``max_window`` (the most accepted in
    one). And the work the kernels need, where a ray walks its windows up
    to the one in which it is killed (T at the window's start, in float64
    over the accepted alphas, at least ``cfg.min_transmittance``):
    ``staged`` (pairs some ray of their block walks, each staging the cull
    once), ``bundle_tests`` (those pairs times their block's warps with a
    pyramid, which test them), ``sphere_tests`` (walked (pair, pixel) in
    the warp's list, trace only) and ``exact_tests`` (those the cull
    keeps)."""
    rays = _tilize_rays(ray_d, tmin, tmax, ray_o)
    n_tiles = rays.gx * rays.gy
    if shared:
        pair_particle, tile_start = _unshare(pair_particle, tile_start,
                                             n_tiles)
    cull = _cull_setup(rays, cfg, shared)
    window = (TRACE_WINDOW if cull.trace and cfg.sorted_compositing
              else max(_window(cfg), 1))
    planes = (cull.bundles[0] == _BUNDLE_PLANES).sum(1)         # [T]
    out = dict(tests=0, bundle_culled=0, sphere_culled=0, accepted=0,
               culled_accepted=0, over_k=0, max_window=0, staged=0,
               bundle_tests=0, sphere_tests=0, exact_tests=0)
    starts = tile_start.to(torch.int64).cpu()
    dev = table.device
    for t0, t1 in _tile_groups(starts, n_tiles, _PLAIN_GROUP_PAIRS):
        p0, p1 = int(starts[t0]), int(starts[t1])
        if p1 == p0:
            continue
        rec = table[pair_particle[p0:p1].to(torch.int64)]
        counts = (starts[t0 + 1:t1 + 1] - starts[t0:t1]).to(dev)
        tile = torch.repeat_interleave(torch.arange(t0, t1, device=dev),
                                       counts)
        d = rays.rd[tile]
        o = rays.ro[tile] if cull.general else None
        sq, hit_t = _hit_terms(rec, d, o)
        thr = _sq_thresholds(rec, cfg)
        acc = ((sq < thr[:, None]) & (hit_t > rays.tmin[tile])
               & (hit_t < rays.tmax[tile]))
        keep, sphere = _cull_keeps(cull, rec, tile, d, o, thr)
        out["tests"] += keep.numel()
        out["bundle_culled"] += int((~keep).sum())
        out["sphere_culled"] += int((keep & ~sphere).sum())
        out["accepted"] += int(acc.sum())
        out["culled_accepted"] += int((acc & ~(keep & sphere)).sum())
        # accepted per (ray, window): windows on the pair index
        win = torch.arange(p0, p1, device=dev) // window
        per = torch.zeros((int(win[-1] - win[0]) + 1, TILE_PIXELS),
                          dtype=torch.int64, device=dev).index_add_(
            0, win - win[0], acc.to(torch.int64))
        out["over_k"] += int((per > TRACE_K).sum())
        out["max_window"] = max(out["max_window"], int(per.max()))
        # the windows each ray walks: T at a window's start (the windows
        # cut to tiles) at least min_transmittance
        alpha = torch.clamp(particle_response(sq, cfg.kernel_degree)
                            * rec[:, 12:13], max=cfg.max_alpha)
        log1m = torch.log1p(-torch.where(acc, alpha,
                                         torch.zeros_like(alpha)).double())
        excl = torch.cumsum(log1m, dim=0) - log1m
        head = torch.ones(p1 - p0, dtype=torch.bool, device=dev)
        head[1:] = (tile[1:] != tile[:-1]) | (win[1:] != win[:-1])
        pos = torch.arange(p1 - p0, device=dev)
        w_first = torch.cummax(torch.where(head, pos, 0), dim=0).values
        t_first = (starts[t0:t1] - p0).to(dev)[tile - t0]
        walk = (torch.exp(excl[w_first] - excl[t_first])
                >= cfg.min_transmittance)
        staged = walk.any(1)
        out["staged"] += int(staged.sum())
        out["bundle_tests"] += int(planes[tile][staged].sum())
        if cull.trace:
            out["sphere_tests"] += int((keep & walk).sum())
        out["exact_tests"] += int((keep & sphere & walk).sum())
    return out


def _nht_features(rec, d, o):
    """[P, 256, 2 d] ray features of NHT records [P, 16 + 4 d] (float64
    in, out) at the canonical hit points of rays d from o [P, 256, 3]."""
    _, _, canon = _hit_terms(rec, d, o, canonical=True)
    return nht_hit_features(
        rec[:, None, NHT_FEAT_SLOT:NHT_FEAT_SLOT + nht_control_dim(rec)],
        canon)


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


def _normal_terms(rec, d, o=None):
    """[P, 256, 3] world normals (common.cuh:hit_normal) of records [P, R]
    on ray dirs [P, 256, 3] (origins ``o``: the general mode), in the
    kernel's fp32 operation order, as float64."""
    a, b, inv_m, sq, q = _canonical_hit(rec, d, o)
    rs = [0.0, 0.0, 0.0]
    for i in range(3):
        m = [rec[:, 3 + 3 * i + j:4 + 3 * i + j] for j in range(3)]
        s2 = 1.0 / torch.clamp(m[0] * m[0] + m[1] * m[1] + m[2] * m[2],
                               min=1e-24)
        rs = [rs[j] + m[j] * s2 for j in range(3)]
    inv_b = torch.sqrt(inv_m)
    t_entry = -q * inv_b - torch.sqrt(torch.clamp(9.0 - sq, min=0.0))
    n = [(a[j] + b[j] * inv_b * t_entry) * rs[j] for j in range(3)]
    inv_n = 1.0 / torch.sqrt(torch.clamp(n[0] * n[0] + n[1] * n[1]
                                         + n[2] * n[2], min=1e-24))
    return torch.stack([c * inv_n for c in n], dim=-1).double()


def _composite_group(rec, starts, t0, t1, rays: _Tiled, cfg, rec64=None,
                     pair_weights=False, cull: Optional[_Cull] = None):
    """Composite tiles [t0, t1) of pair records ``rec`` [P_g, R] (the
    group's pairs, f32). Returns (acc [G, 256, F + 2] = features, depth,
    hits, and with ``cfg.enable_normals`` 3 more channels of the blended
    normals; T_final [G, 256]) in float64, and with ``pair_weights`` also
    the weights w = alpha T [P_g, 256] of each (pair, pixel).

    Accept and kill decisions come from ``rec`` in fp32. The values
    (alpha, hit distance, rgb) do too, rounded to float64 afterwards,
    unless ``rec64`` (the same records in float64) is given: then they are
    computed from it in float64, and autograd can differentiate the
    result with respect to ``rec64``. NHT records (R = 16 + 4 d) get
    their 2 d features from the float64 records (``rec64``, or ``rec``
    rounded up) at the float64 canonical hit point. In the sorted mode
    each pixel's
    candidates are permuted into ``_window_order`` first (the sort key is
    the fp32 hit distance), composited in that order, and the weights put
    back in pair order. With ``cull`` (``_cull_setup``) a candidate the
    kernels' cull drops is rejected too, as the kernels walk."""
    dev = rec.device
    p0, p1 = int(starts[t0]), int(starts[t1])
    counts = (starts[t0 + 1:t1 + 1] - starts[t0:t1]).to(dev)
    local = torch.repeat_interleave(torch.arange(t1 - t0, device=dev), counts)
    tile = local + t0                                      # [P]
    d = rays.rd[tile]                                      # [P, 256, 3]
    o = None if rays.ro is None else rays.ro[tile]
    sq, hit_t = _hit_terms(rec, d, o)
    dens = rec[:, 12:13]
    thr = _sq_thresholds(rec, cfg)
    keep = ((sq < thr[:, None]) & (hit_t > rays.tmin[tile])
            & (hit_t < rays.tmax[tile]))
    if cull is not None:
        pyramid, sphere = _cull_keeps(cull, rec, tile, d, o, thr)
        keep = keep & pyramid & sphere
    order = (_window_order(keep, hit_t, p0, tile, _window(cfg))
             if cfg.sorted_compositing else None)
    nht = rec.shape[1] != RECORD_DIM
    o64 = None if o is None else o.double()
    if rec64 is None:
        alpha = torch.clamp(particle_response(sq, cfg.kernel_degree) * dens,
                            max=cfg.max_alpha)
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha)).double()
        hit_t, rgb = hit_t.double(), rec[:, 13:16].double()
        if nht:
            feats = _nht_features(rec.double(), d.double(), o64)
    else:
        sq64, hit_t = _hit_terms(rec64, d.double(), o64)
        alpha = torch.clamp(particle_response(sq64, cfg.kernel_degree)
                            * rec64[:, 12:13], max=cfg.max_alpha)
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        rgb = rec64[:, 13:16]
        if nht:
            feats = _nht_features(rec64, d.double(), o64)
    # weighted sums per pixel: features, then (normals) the hit normals
    if nht:
        rgb = list(feats.unbind(-1))
    else:
        rgb = [rgb[:, c:c + 1] for c in range(3)]
    if cfg.enable_normals:
        rgb += list(_normal_terms(rec, d, o).unbind(-1))
    if order is not None:
        alpha, hit_t = alpha.gather(0, order), hit_t.gather(0, order)
        rgb = [f.expand_as(order).gather(0, order) for f in rgb]

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

    nf = len(rgb) - (3 if cfg.enable_normals else 0)
    contrib = torch.stack([wgt * f for f in rgb[:nf]] + [
        wgt * hit_t, (wgt > 0.0).double()] + [wgt * f for f in rgb[nf:]],
        dim=-1)                                   # [P, 256, F + 2 (+ 3)]
    acc = torch.zeros((t1 - t0, TILE_PIXELS, contrib.shape[-1]),
                      dtype=torch.float64, device=dev).index_add(0, local,
                                                                 contrib)

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


def _unshare(pair_particle, tile_start, n_tiles):
    """A shared segment as the disjoint segments of ``n_tiles`` tiles: the
    segment's pairs repeated per tile (tile t's copy of slot j at
    t n + j, kernel C's shared-mode row)."""
    s0, s1 = int(tile_start[0]), int(tile_start[1])
    seg = pair_particle[s0:s1]
    starts = torch.arange(n_tiles + 1, dtype=torch.int32,
                          device=tile_start.device) * (s1 - s0)
    return seg.repeat(n_tiles), starts


def rasterize_tiles_plain(table, pair_particle, tile_start, ray_d, tmin,
                          tmax, cfg, ray_o=None, shared=False, cull=False):
    """Plain PyTorch version of ``rasterize_tiles_forward``.

    Vectorised over (pair, pixel): per-pair alpha for the 256 pixels of
    the pair's tile, then the transmittance as an exclusive log-space
    prefix sum (float64) within each tile's segment, the exact kill as a
    mask on it, and ``index_add`` into the pixels. Tiles are processed in
    groups so the temporaries stay bounded. A shared segment runs as its
    copies per tile (``_unshare``). ``cull``: the kernels' cull rejects
    what it drops (``_composite_group``); it drops nothing the exact test
    accepts, so the result is the same.
    """
    h, w = ray_d.shape[:2]
    nht = _is_nht(table, cfg, ray_o)
    normals = _normals_on(cfg, nht)
    nf = feature_dim(table)
    rays = _tilize_rays(ray_d, tmin, tmax, ray_o)
    n_tiles = rays.gx * rays.gy
    if shared:
        pair_particle, tile_start = _unshare(pair_particle, tile_start,
                                             n_tiles)
    # features, depth, hits, final T (, normals)
    out = torch.zeros((n_tiles, TILE_PIXELS, nf + 3 + 3 * normals),
                      dtype=torch.float64, device=table.device)
    out[..., nf + 2] = 1.0
    starts = tile_start.to(torch.int64).cpu()
    group = _PLAIN_GROUP_PAIRS // (_NHT_GROUP_SHRINK if nht else 1)
    setup = _cull_setup(rays, cfg, shared) if cull else None
    for t0, t1 in _tile_groups(starts, n_tiles, group):
        p0, p1 = int(starts[t0]), int(starts[t1])
        if p1 == p0:
            continue
        rec = table[pair_particle[p0:p1].to(torch.int64)]
        acc, t_final = _composite_group(rec, starts, t0, t1, rays, cfg,
                                        cull=setup)
        out[t0:t1, :, 0:nf + 2] = acc[..., 0:nf + 2]
        out[t0:t1, :, nf + 2] = t_final
        out[t0:t1, :, nf + 3:] = acc[..., nf + 2:]
    img = _untile(out, rays.gx, rays.gy, h, w).to(torch.float32)
    t_fin = img[..., nf + 2:nf + 3].contiguous()
    res = (img[..., 0:nf].contiguous(), 1.0 - t_fin,
           img[..., nf:nf + 1].contiguous(),
           img[..., nf + 1:nf + 2].contiguous(), t_fin)
    return res + (img[..., nf + 3:].contiguous(),) if normals else res


def rasterize_tiles_backward_plain(table, pair_particle, tile_start, ray_d,
                                   tmin, tmax, feat, depth, t_final, g_feat,
                                   g_opacity, g_depth, cfg, ray_o=None,
                                   shared=False):
    """Plain PyTorch version of ``rasterize_tiles_backward``: autograd
    through the float64 compositing of ``_composite_group``, with each
    group's gathered records as the leaf, tile group by tile group. The
    accept and kill decisions are the fp32 ones of the forward; the saved
    outputs (feat, depth, t_final) are not needed, the group recomputes
    them."""
    del feat, depth, t_final
    nht = _is_nht(table, cfg, ray_o)
    nf = feature_dim(table)
    # normals carry no cotangent: composite without them
    cfg = cfg.replace(enable_normals=False)
    rays = _tilize_rays(ray_d, tmin, tmax, ray_o)
    n_tiles = rays.gx * rays.gy
    gx, gy = rays.gx, rays.gy
    if shared:
        pair_particle, tile_start = _unshare(pair_particle, tile_start,
                                             n_tiles)
    g_rgb = _tilize(g_feat.double(), gx, gy, 0.0)             # [T, 256, F]
    g_dep = _tilize(g_depth.double(), gx, gy, 0.0)[..., 0]     # [T, 256]
    g_t = -_tilize(g_opacity.double(), gx, gy, 0.0)[..., 0]    # d/d T_final
    d_records = torch.zeros((pair_particle.shape[0], table.shape[1]),
                            dtype=torch.float32, device=table.device)
    starts = tile_start.to(torch.int64).cpu()
    group = _PLAIN_BWD_GROUP_PAIRS // (_NHT_GROUP_SHRINK if nht else 1)
    for t0, t1 in _tile_groups(starts, n_tiles, group):
        p0, p1 = int(starts[t0]), int(starts[t1])
        if p1 == p0:
            continue
        rec = table[pair_particle[p0:p1].to(torch.int64)].detach()
        with torch.enable_grad():
            rec64 = rec.double().requires_grad_(True)
            acc, t_fin = _composite_group(rec, starts, t0, t1, rays, cfg,
                                          rec64=rec64)
            loss = ((acc[..., 0:nf] * g_rgb[t0:t1]).sum()
                    + (acc[..., nf] * g_dep[t0:t1]).sum()
                    + (t_fin * g_t[t0:t1]).sum())
            (grad,) = torch.autograd.grad(loss, rec64)
        d_records[p0:p1] = grad.to(torch.float32)
    return d_records
