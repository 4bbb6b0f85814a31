"""Kernel E wrapper: blend-weight telemetry for GS weight pruning.

Kernel E (``csrc/wmax.cu``) replaces
threedgrut_tpu/ops/pallas/raster.py:_wmax_kernel (through
``rasterize_weight_telemetry``): the max over each pair's tile pixels of
the blend weight w = alpha * T, with kernel B's hit math, kill,
(sorted mode) windows and (``ray_o`` given) general-geometry mode. Its
header says what bounds it and how it is laid out. On CPU tensors the
wrapper runs ``pair_weight_max_plain``, which takes the weights from the
plain compositing of ``ops/cuda/raster.py``.

``particle_weight_max`` folds the per-pair maxima into a per-particle max
(render/gut.py:295-297: ``segment_max`` clamped at 0).
"""

from __future__ import annotations

import torch

from . import build
from .raster import (_PLAIN_GROUP_PAIRS, WINDOWS, _check_inputs,
                     _composite_group, _count, _cull_setup, _is_nht, _lib,
                     _mode, _ptr, _tile_groups, _tilize_rays, _window)


def pair_weight_max(table: torch.Tensor, pair_particle: torch.Tensor,
                    tile_start: torch.Tensor, ray_d: torch.Tensor,
                    tmin: torch.Tensor, tmax: torch.Tensor,
                    cfg, ray_o=None) -> torch.Tensor:
    """Kernel E: [P] f32 max over the pair's tile pixels of alpha * T
    (the arguments of ``rasterize_tiles_forward``, ``ray_o`` selecting
    the general mode). Pairs no live pixel reaches, and culled pairs past
    the last tile, read 0. No autograd."""
    h, w, gx, gy, dev = _check_inputs(table, pair_particle, tile_start,
                                      ray_d, tmin, tmax, ray_o)
    if _is_nht(table, cfg, ray_o):
        raise NotImplementedError("kernel E has no NHT mode (JAX's weight "
                                  "telemetry is GS only)")
    if _window(cfg) not in (0,) + WINDOWS:
        raise NotImplementedError(f"sort_window {_window(cfg)}: kernel E "
                                  f"is built for {WINDOWS}")
    ints, floats = _mode(cfg, ray_o is not None)
    if dev.type == "cpu":
        return pair_weight_max_plain(table, pair_particle, tile_start, ray_d,
                                     tmin, tmax, cfg, ray_o)
    wpair = torch.zeros(pair_particle.shape[0], dtype=torch.float32,
                        device=dev)
    lib = _lib("wmax")
    err = lib.wmax_launch(
        table.data_ptr(), pair_particle.data_ptr(), tile_start.data_ptr(),
        _ptr(ray_o), ray_d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        w, h, gx, gx * gy, *ints, *floats, wpair.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("wmax", err, lib)
    _count(pair_weight_max, cfg, ray_o)
    return wpair


pair_weight_max.launches = 0
pair_weight_max.launches_general = 0


def pair_weight_max_plain(table, pair_particle, tile_start, ray_d, tmin,
                          tmax, cfg, ray_o=None, cull=False) -> torch.Tensor:
    """Plain PyTorch version of ``pair_weight_max``: the float64 weights
    of ``_composite_group`` in pair order, maxed over the pixels (with
    ``cull``, what the kernels' cull drops rejected too: the same)."""
    rays = _tilize_rays(ray_d, tmin, tmax, ray_o)
    setup = _cull_setup(rays, cfg, False) if cull else None
    wpair = torch.zeros(pair_particle.shape[0], dtype=torch.float32,
                        device=table.device)
    starts = tile_start.to(torch.int64).cpu()
    for t0, t1 in _tile_groups(starts, rays.gx * rays.gy, _PLAIN_GROUP_PAIRS):
        p0, p1 = int(starts[t0]), int(starts[t1])
        if p1 == p0:
            continue
        rec = table[pair_particle[p0:p1].to(torch.int64)]
        _, _, wgt = _composite_group(rec, starts, t0, t1, rays, cfg,
                                     pair_weights=True, cull=setup)
        wpair[p0:p1] = wgt.amax(dim=1).to(torch.float32)
    return wpair


def particle_weight_max(wpair: torch.Tensor, pair_particle: torch.Tensor,
                        capacity: int) -> torch.Tensor:
    """[capacity] f32 per-particle max of the per-pair maxima, 0 for
    particles without a pair (``segment_max`` clamped at 0)."""
    out = torch.zeros(capacity, dtype=torch.float32, device=wpair.device)
    return out.scatter_reduce(0, pair_particle.to(torch.int64), wpair,
                              "amax")
