"""Plain PyTorch 3DGUT renderer: the benchmark's reference.

The semantics of the port's global-Z 3DGUT path, written again in plain
PyTorch (fp32, TF32 off) with no kernel and nothing of the port:

- the unscented projection of each particle through a global-shutter
  pinhole (7 sigma points, mip-scaled opacity, tight opacity bounding),
- the tile bounding boxes and the per-tile conic cull,
- for every (pair, pixel) of a 16x16 tile, the particle's maximum
  response along the pixel's ray in its canonical frame (degree-2
  kernel), alpha = min(response * opacity, max_alpha), accepted above
  ``min_response`` and ``min_alpha`` and inside the scene box's ray range,
- front-to-back compositing in global depth order with the exact kill:
  a hit counts while the transmittance before it is at least
  ``min_transmittance``; the pixel's final transmittance is the first
  one below it, else the last.

The compositing runs over blocks of tiles so that it fits: each block's
(pair, pixel) evaluations are one [pairs, 256] tensor, the transmittance
an exclusive sum of log(1 - alpha) in float64 inside each tile's run of
pairs. ``render_backward`` recomputes each block with autograd against
the image's cotangent, so the graph of one block is alive at a time.

``precision="tf32"`` rounds both operands of every product-sum (the
sigma points' pose transform, the particle frames, the per-pixel
canonical directions, the SH dot products, the blend of colours) to
TF32's 10-bit mantissa: the control of the benchmark's correctness
check, the reference computed one step below the configuration's fp32.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

# fp32 products stay fp32: no TF32 in matmuls or cuDNN convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TILE = 16
TILE_PIXELS = TILE * TILE

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """TF32 rounding of a product's operand; its cotangent, an operand of
    the backward's products, is rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to nearest on TF32's 10-bit mantissa, ties
    away from zero (the card's ``cvt.rna.tf32.f32``)."""
    return _RoundTF32.apply(x)


class Camera(NamedTuple):
    """A global-shutter pinhole: world -> camera x_c = R(q) x_w + t."""
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    t: torch.Tensor    # [3]
    q: torch.Tensor    # [4] wxyz, unit


class Settings(NamedTuple):
    """The render settings the configuration states (render/3dgut.yaml)."""
    ut_alpha: float = 1.0
    ut_beta: float = 2.0
    ut_kappa: float = 0.0
    image_margin_factor: float = 0.1
    min_sensor_z: float = 0.2
    covariance_dilation: float = 0.3
    alpha_threshold: float = 1.0 / 255.0
    min_response: float = 0.0113
    max_alpha: float = 0.99
    min_transmittance: float = 1e-4


def settings_from(conf: dict) -> Settings:
    """Settings from a configuration file's ``render`` block."""
    r = conf["render"]
    return Settings(
        ut_alpha=r["ut_alpha"], ut_beta=r["ut_beta"], ut_kappa=r["ut_kappa"],
        image_margin_factor=r["ut_in_image_margin_factor"],
        alpha_threshold=r["particle_kernel_min_alpha"],
        min_response=r["particle_kernel_min_response"],
        max_alpha=r["particle_kernel_max_alpha"],
        min_transmittance=r["min_transmittance"])


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] unit wxyz -> [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def unit_quat(q: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(n, min=1e-12)


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """[..., 3] unit directions -> [..., (degree + 1)^2] real SH basis."""
    x, y, z = d.unbind(-1)
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                SH_C2[4] * (xx - yy)]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, -1)


def sensor_position(cam: Camera) -> torch.Tensor:
    return -(quat_to_rotmat(cam.q).T @ cam.t)


class Projection(NamedTuple):
    valid: torch.Tensor    # [N] bool
    center: torch.Tensor   # [N, 2]
    conic: torch.Tensor    # [N, 3]
    opacity: torch.Tensor  # [N] mip-scaled
    extent: torch.Tensor   # [N, 2]
    depth: torch.Tensor    # [N] camera z, inf where invalid


@torch.no_grad()
def project(cam: Camera, s: Settings, pos, quat, scale, opac,
            precision: str = "fp32") -> Projection:
    """Unscented projection of every particle (global shutter, pinhole
    without distortion); nothing here carries a gradient."""
    rnd = round_tf32 if precision == "tf32" else (lambda v: v)
    lam = s.ut_alpha ** 2 * (3 + s.ut_kappa) - 3
    w0 = lam / (3 + lam)
    wi = 1.0 / (2 * (3 + lam))
    w0c = w0 + (1 - s.ut_alpha ** 2 + s.ut_beta)
    delta = math.sqrt(s.ut_alpha ** 2 * (3 + s.ut_kappa))
    rot = quat_to_rotmat(unit_quat(quat))
    axes = (rot * scale[:, None, :]).transpose(1, 2) * delta  # [N, axis, 3]
    p = pos[:, None, :]
    pts = torch.cat([p, p + axes, p - axes], 1)                # [N, 7, 3]
    r_wc = quat_to_rotmat(cam.q)
    pc = torch.einsum("ij,nkj->nki", rnd(r_wc), rnd(pts)) + cam.t
    z = pc[..., 2]
    ok_z = z > 0
    uv = pc[..., :2] / torch.where(ok_z, z, torch.ones_like(z))[..., None]
    focal = torch.tensor([cam.fx, cam.fy], device=pos.device)
    princ = torch.tensor([cam.cx, cam.cy], device=pos.device)
    px = uv * focal + princ
    res = torch.tensor([cam.width, cam.height], dtype=torch.float32,
                       device=pos.device)
    tol = res * s.image_margin_factor
    inside = ((px[..., 0] > -tol[0]) & (px[..., 1] > -tol[1])
              & (px[..., 0] < res[0] + tol[0])
              & (px[..., 1] < res[1] + tol[1]))
    ok = ok_z & inside
    px = torch.where(ok_z[..., None], px, torch.zeros_like(px))
    center = w0 * px[:, 0] + wi * px[:, 1:].sum(1)
    c = px - center[:, None]
    wts = torch.tensor([w0c] + [wi] * 6, device=pos.device)
    cxx = (wts * c[..., 0] * c[..., 0]).sum(1)
    cxy = (wts * c[..., 0] * c[..., 1]).sum(1)
    cyy = (wts * c[..., 1] * c[..., 1]).sum(1)
    z_sensor = pos @ r_wc[2] + cam.t[2]
    valid = ((ok.sum(1) > 0) & (opac >= s.alpha_threshold)
             & (z_sensor >= s.min_sensor_z))
    dxx = cxx + s.covariance_dilation
    dyy = cyy + s.covariance_dilation
    det = dxx * dyy - cxy * cxy
    det_safe = torch.where(det == 0, torch.ones_like(det), det)
    conic = torch.stack([dyy, -cxy, dxx], -1) / det_safe[:, None]
    det_raw = cxx * cyy - cxy * cxy
    opacity = opac * torch.sqrt(torch.clamp(det_raw / det_safe, min=2.5e-5))
    valid = valid & (det != 0) & (opacity >= s.alpha_threshold)
    max_power = torch.log(torch.clamp(opacity, min=1e-30)
                          / s.alpha_threshold)
    factor = torch.clamp(torch.sqrt(2 * torch.clamp(max_power, min=0)),
                         max=3.33)
    mid = 0.5 * (dxx + dyy)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radius = factor * torch.sqrt(lam_max)
    ext = torch.minimum(factor[:, None] * torch.sqrt(torch.stack([dxx, dyy],
                                                                 -1)),
                        radius[:, None])
    valid = valid & (radius > 0)
    return Projection(valid, center, conic, opacity,
                      torch.where(valid[:, None], ext, torch.zeros_like(ext)),
                      torch.where(valid, z_sensor,
                                  torch.full_like(z_sensor, math.inf)))


def tile_min_power(tx, ty, conic, center):
    """Least conic power 0.5 x^T C x over each tile's square; 0 when the
    centre lies inside the tile (the reference's per-tile cull)."""
    t = float(TILE)
    x0, y0 = t * tx, t * ty
    x1, y1 = x0 + t, y0 + t
    cx, cy = center[:, 0], center[:, 1]
    mx, my = x0 - cx, y0 - cy
    lx, ly = (mx > 0).float(), (my > 0).float()
    bx = lx + (cx > x1).float()
    by = ly + (cy > y1).float()
    outside = (bx + by) > 0
    px = x1 * (1 - lx) + x0 * lx
    py = y1 * (1 - ly) + y0 * ly
    dx = torch.where(mx == 0, torch.full_like(mx, t), torch.sign(mx) * t)
    dy = torch.where(my == 0, torch.full_like(my, t), torch.sign(my) * t)
    ex, ey = cx - px, cy - py
    a, b, c = conic.unbind(-1)
    ox = by * torch.clamp((dx * a * ex + dx * b * ey) * (1 / (t * t * a)),
                          0, 1)
    oy = bx * torch.clamp((dy * b * ex + dy * c * ey) * (1 / (t * t * c)),
                          0, 1)
    ddx = cx - (px + ox * dx)
    ddy = cy - (py + oy * dy)
    power = 0.5 * (a * ddx * ddx + c * ddy * ddy) + b * ddx * ddy
    return torch.where(outside, power, torch.zeros_like(power))


class Pairs(NamedTuple):
    """(tile, particle) pairs sorted by tile, then by depth."""
    tile: torch.Tensor       # [P] int64
    particle: torch.Tensor   # [P] int64
    tile_start: torch.Tensor  # [T + 1] int64
    grid: tuple              # (gx, gy)


@torch.no_grad()
def make_pairs(cam: Camera, s: Settings, proj: Projection,
               max_slots: int = 1 << 25) -> Pairs:
    """Every particle over the tiles of its bounding box, the tiles its
    conic cannot reach above the alpha threshold culled."""
    gx = (cam.width + TILE - 1) // TILE
    gy = (cam.height + TILE - 1) // TILE
    dev = proj.center.device
    idx = torch.nonzero(proj.valid).squeeze(1)
    idx = idx[torch.argsort(proj.depth[idx], stable=True)]
    center, ext = proj.center[idx], proj.extent[idx]
    lo_x = torch.clamp(torch.floor((center[:, 0] - 0.5 - ext[:, 0]) / TILE),
                       0, gx)
    lo_y = torch.clamp(torch.floor((center[:, 1] - 0.5 - ext[:, 1]) / TILE),
                       0, gy)
    hi_x = torch.clamp(torch.ceil((center[:, 0] - 0.5 + ext[:, 0]) / TILE),
                       0, gx)
    hi_y = torch.clamp(torch.ceil((center[:, 1] - 0.5 + ext[:, 1]) / TILE),
                       0, gy)
    wdt = torch.clamp(hi_x - lo_x, min=0).long()
    cnt = wdt * torch.clamp(hi_y - lo_y, min=0).long()
    max_power = torch.log(torch.clamp(proj.opacity[idx], min=1e-30)
                          / s.alpha_threshold)
    tiles, ranks = [], []
    # the slots in runs of whole particles, at most max_slots at a time
    ends = torch.cumsum(cnt, 0)
    start = 0
    while start < idx.numel():
        base = 0 if start == 0 else int(ends[start - 1])
        stop = int(torch.searchsorted(ends, base + max_slots, right=True))
        stop = max(stop, start + 1)
        r = torch.arange(start, stop, device=dev)
        rep = torch.repeat_interleave(r, cnt[start:stop])
        if rep.numel():
            first = ends[rep] - cnt[rep]
            local = torch.arange(rep.numel(), device=dev) + base - first
            tx = lo_x[rep] + (local % wdt[rep]).float()
            ty = lo_y[rep] + (local // wdt[rep]).float()
            power = tile_min_power(tx, ty, proj.conic[idx[rep]],
                                   center[rep])
            keep = power < max_power[rep]
            tiles.append((ty * gx + tx).long()[keep])
            ranks.append(rep[keep])
        start = stop
    tile = torch.cat(tiles) if tiles else torch.zeros(0, dtype=torch.long,
                                                      device=dev)
    rank = torch.cat(ranks) if ranks else tile.clone()
    order = torch.argsort(tile * max(idx.numel(), 1) + rank)
    tile, rank = tile[order], rank[order]
    tile_start = torch.searchsorted(
        tile, torch.arange(gx * gy + 1, device=dev))
    return Pairs(tile, idx[rank], tile_start, (gx, gy))


class Rays(NamedTuple):
    """Per-pixel rays of the tile-padded image, tile-major [T, 256, .]."""
    origin: torch.Tensor   # [3]
    dirs: torch.Tensor     # [T, 256, 3]
    tmin: torch.Tensor     # [T, 256]
    tmax: torch.Tensor     # [T, 256]
    inside: torch.Tensor   # [T, 256] bool: the pixel lies in the image


@torch.no_grad()
def camera_rays(cam: Camera, pos, scale_act, grid) -> Rays:
    """Unit world rays through pixel centres and their range inside the
    particles' +-3 sigma box (the reference's object AABB clip)."""
    gx, gy = grid
    dev = pos.device
    hh, ww = gy * TILE, gx * TILE
    y, x = torch.meshgrid(torch.arange(hh, dtype=torch.float32, device=dev),
                          torch.arange(ww, dtype=torch.float32, device=dev),
                          indexing="ij")
    d = torch.stack([(x + 0.5 - cam.cx) / cam.fx, (y + 0.5 - cam.cy) / cam.fy,
                     torch.ones_like(x)], -1)
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    rot = quat_to_rotmat(cam.q)
    d = torch.einsum("ij,hwi->hwj", rot, d)
    o = -(rot.T @ cam.t)
    rad = 3.0 * scale_act.amax(-1, keepdim=True)
    lo = (pos - rad).amin(0)
    hi = (pos + rad).amax(0)
    tiny = torch.where(d >= 0, torch.full_like(d, 1e-12),
                       torch.full_like(d, -1e-12))
    inv = 1.0 / torch.where(d.abs() < 1e-12, tiny, d)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    tmin = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0)
    tmax = torch.maximum(t0, t1).amin(-1)
    inside = (x < cam.width) & (y < cam.height)

    def tiles(v):
        v = v.reshape(gy, TILE, gx, TILE, *v.shape[2:]).transpose(1, 2)
        return v.reshape(gx * gy, TILE_PIXELS, *v.shape[4:]).contiguous()

    return Rays(o, tiles(d), tiles(tmin), tiles(tmax), tiles(inside))


def untile(v: torch.Tensor, cam: Camera, grid) -> torch.Tensor:
    """[T, 256, C] -> [H, W, C]."""
    gx, gy = grid
    c = v.shape[-1]
    v = v.reshape(gy, gx, TILE, TILE, c).transpose(1, 2)
    return v.reshape(gy * TILE, gx * TILE, c)[:cam.height, :cam.width]


def particle_terms(params: Dict[str, torch.Tensor], origin: torch.Tensor,
                   sh_degree: int, precision: str = "fp32"):
    """Per-particle inputs of the hit test, differentiable in the raw
    parameters: M = diag(1/s) R^T, a = M (o - p), the opacity and the
    clamped SH radiance towards the sensor."""
    rnd = round_tf32 if precision == "tf32" else (lambda v: v)
    rot = quat_to_rotmat(unit_quat(params["rotation"]))
    scale = torch.exp(params["scale"])
    m = (1.0 / scale)[:, :, None] * rot.transpose(1, 2)
    a = torch.einsum("nij,nj->ni", rnd(m), rnd(origin - params["positions"]))
    opac = torch.sigmoid(params["density"][:, 0])
    ray = params["positions"] - origin
    view = ray / torch.clamp(torch.sqrt((ray * ray).sum(-1)), min=1e-12)[:,
                                                                          None]
    k = (sh_degree + 1) ** 2
    coeffs = torch.cat([params["features_albedo"][:, None, :],
                        params["features_specular"].reshape(
                            params["positions"].shape[0], -1, 3)], 1)[:, :k]
    rad = torch.einsum("nk,nkc->nc", rnd(sh_basis(view, sh_degree)),
                       rnd(coeffs)) + 0.5
    return {"m": m, "a": a, "opac": opac, "rgb": torch.clamp(rad, min=0.0)}


class Block(NamedTuple):
    t0: int
    t1: int
    p0: int
    p1: int


def blocks(pairs: Pairs, budget: int = 1 << 25):
    """Runs of whole tiles whose (pair, pixel) evaluations stay near
    ``budget``."""
    ts = pairs.tile_start.tolist()
    n_t = len(ts) - 1
    out, t0 = [], 0
    while t0 < n_t:
        t1 = t0 + 1
        while t1 < n_t and (ts[t1 + 1] - ts[t0]) * TILE_PIXELS <= budget:
            t1 += 1
        if ts[t1] > ts[t0]:
            out.append(Block(t0, t1, ts[t0], ts[t1]))
        t0 = t1
    return out


def composite_block(blk: Block, pairs: Pairs, terms, rays: Rays,
                    s: Settings, precision: str = "fp32",
                    counts: Optional[dict] = None):
    """Colour [T_b, 256, 3] and opacity [T_b, 256, 1] of a block's tiles."""
    rnd = round_tf32 if precision == "tf32" else (lambda v: v)
    g = pairs.particle[blk.p0:blk.p1]
    lt = pairs.tile[blk.p0:blk.p1] - blk.t0
    n_t = blk.t1 - blk.t0
    d = rays.dirs[blk.t0:blk.t1][lt]                         # [P, 256, 3]
    mg = terms["m"][g]                                       # [P, 3, 3]
    grdu = torch.bmm(rnd(d), rnd(mg).transpose(1, 2))        # M d
    grd = grdu * torch.rsqrt(torch.clamp((grdu * grdu).sum(-1, keepdim=True),
                                         min=1e-32))
    gro = terms["a"][g][:, None, :].expand_as(grd)
    cr = torch.cross(grd, gro, dim=-1)
    sq = (cr * cr).sum(-1)                                   # [P, 256]
    resp = torch.exp(-0.5 * sq)
    alpha = torch.clamp(resp * terms["opac"][g][:, None], max=s.max_alpha)
    # the hit distance: the canonical foot of the ray mapped back
    proj = -(grd * gro).sum(-1)
    t_hit = proj * torch.rsqrt(torch.clamp((grdu * grdu).sum(-1),
                                           min=1e-32))
    tmin = rays.tmin[blk.t0:blk.t1][lt]
    tmax = rays.tmax[blk.t0:blk.t1][lt]
    ok = ((resp > s.min_response) & (alpha > s.alpha_threshold)
          & (t_hit > tmin) & (t_hit < tmax))
    a = torch.where(ok, alpha, torch.zeros_like(alpha)).double()
    lg = torch.log1p(-a)
    cs = torch.cumsum(lg, 0)
    # exclusive sum inside each tile's run: subtract the run's base
    start = pairs.tile_start[blk.t0:blk.t1] - blk.p0         # [T_b]
    base = torch.where(start[:, None] > 0,
                       cs[torch.clamp(start - 1, min=0)],
                       torch.zeros_like(cs[:1]).expand(n_t, -1))
    excl = cs - lg - base[lt]
    trans = torch.exp(excl)
    alive = trans.detach() >= s.min_transmittance
    w = torch.where(alive, a * trans, torch.zeros_like(a))
    rgb = terms["rgb"][g]
    if precision == "tf32":
        contrib = (round_tf32(w.float()).double()[..., None]
                   * round_tf32(rgb).double()[:, None, :])
    else:
        contrib = w[..., None] * rgb.double()[:, None, :]
    color = torch.zeros((n_t, TILE_PIXELS, 3), dtype=torch.float64,
                        device=a.device).index_add(0, lt, contrib)
    # the final transmittance: the first below the kill, else the last
    n_alive = torch.zeros((n_t, TILE_PIXELS), dtype=torch.long,
                          device=a.device).index_add(0, lt, alive.long())
    length = (pairs.tile_start[blk.t0 + 1:blk.t1 + 1]
              - pairs.tile_start[blk.t0:blk.t1])[:, None]
    total = torch.zeros((n_t, TILE_PIXELS), dtype=torch.float64,
                        device=a.device).index_add(0, lt, lg)
    killed = n_alive < length
    at = torch.clamp(start[:, None] + n_alive, max=blk.p1 - blk.p0 - 1)
    t_kill = torch.gather(trans, 0, at)
    t_final = torch.where(killed, t_kill, torch.exp(total))
    if counts is not None:
        inside = rays.inside[blk.t0:blk.t1][lt]
        hit = (w > 0) & inside
        counts["evals"] += int(hit.sum())
        counts["particles"][g[hit.any(1)]] = True
    return color.float(), (1.0 - t_final).float()[..., None]


def prepare(params: Dict[str, torch.Tensor], cam: Camera, s: Settings,
            precision: str = "fp32"):
    """(pairs, rays) of a view: the structural part, no gradient."""
    with torch.no_grad():
        scale = torch.exp(params["scale"])
        opac = torch.sigmoid(params["density"][:, 0])
        proj = project(cam, s, params["positions"], params["rotation"], scale,
                       opac, precision)
        pairs = make_pairs(cam, s, proj)
        rays = camera_rays(cam, params["positions"], scale, pairs.grid)
    return pairs, rays


def render(params: Dict[str, torch.Tensor], cam: Camera, s: Settings,
           sh_degree: int, precision: str = "fp32",
           counts: Optional[dict] = None, budget: int = 1 << 25):
    """(colour [H, W, 3], opacity [H, W, 1], number of pairs) of a view,
    without a gradient. ``counts``, where given, gathers the contributing
    (particle, pixel) evaluations (``evals``) and marks each particle that
    contributes to a pixel (``particles``, [N] bool)."""
    pairs, rays = prepare(params, cam, s, precision)
    with torch.no_grad():
        terms = particle_terms(params, rays.origin, sh_degree, precision)
        n_t = pairs.tile_start.numel() - 1
        color = torch.zeros((n_t, TILE_PIXELS, 3), device=rays.dirs.device)
        opac = torch.zeros((n_t, TILE_PIXELS, 1), device=rays.dirs.device)
        for blk in blocks(pairs, budget):
            c, o = composite_block(blk, pairs, terms, rays, s, precision,
                                   counts)
            color[blk.t0:blk.t1] = c
            opac[blk.t0:blk.t1] = o
    return (untile(color, cam, pairs.grid), untile(opac, cam, pairs.grid),
            int(pairs.tile.numel()))


def render_backward(params: Dict[str, torch.Tensor], cam: Camera,
                    s: Settings, sh_degree: int, image_loss,
                    precision: str = "fp32", budget: int = 1 << 25):
    """Render a view, take ``image_loss(color, opacity)`` (a scalar that
    may also depend on other leaves) and accumulate the gradient of the
    loss into ``.grad`` of every leaf it reaches, the raw parameters
    included. Returns (loss value, number of pairs)."""
    pairs, rays = prepare(params, cam, s, precision)
    terms = particle_terms(params, rays.origin, sh_degree, precision)
    leaves = {k: v.detach().requires_grad_() for k, v in terms.items()}
    bl = blocks(pairs, budget)
    n_t = pairs.tile_start.numel() - 1
    dev = rays.dirs.device
    with torch.no_grad():
        color = torch.zeros((n_t, TILE_PIXELS, 3), device=dev)
        opac = torch.zeros((n_t, TILE_PIXELS, 1), device=dev)
        for blk in bl:
            c, o = composite_block(blk, pairs, leaves, rays, s, precision)
            color[blk.t0:blk.t1] = c
            opac[blk.t0:blk.t1] = o
    color.requires_grad_()
    opac.requires_grad_()
    loss = image_loss(untile(color, cam, pairs.grid),
                      untile(opac, cam, pairs.grid))
    loss.backward()
    for blk in bl:
        c, o = composite_block(blk, pairs, leaves, rays, s, precision)
        torch.autograd.backward([c, o], [color.grad[blk.t0:blk.t1],
                                         opac.grad[blk.t0:blk.t1]])
    outs = [terms[k] for k in leaves if leaves[k].grad is not None]
    grads = [leaves[k].grad for k in leaves if leaves[k].grad is not None]
    torch.autograd.backward(outs, grads)
    return float(loss.detach()), int(pairs.tile.numel())
