"""Plain PyTorch training step of the benchmark's configurations: the
reference that the timed ``Trainer.train_iteration`` is held to.

One step on one view: the render of ``render.py``, the background, the
learned ISP (PPISP) where the configuration has it, the loss
``lambda_l1 * L1 + lambda_ssim * (1 - SSIM)`` plus the opacity and
scale terms over every row, the gradient of every parameter group,
Adam with the configuration's learning rates and schedules, then MCMC's
events of the step: relocate and add on their schedule, the perturbation
of the positions on every step. Each formula is the published one,
written again here; nothing of the port is imported.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import render as ref

SSIM_C1 = 0.01 ** 2
SSIM_C2 = 0.03 ** 2

# the fixed whitening of PPISP's colour latents (a constant of the format)
LATENT_WHITEN = [
    [[0.0480542, -0.0043631], [-0.0043631, 0.0481283]],
    [[0.0580570, -0.0179872], [-0.0179872, 0.0431061]],
    [[0.0433336, -0.0180537], [-0.0180537, 0.0580500]],
    [[0.0128369, -0.0034654], [-0.0034654, 0.0128158]],
]


class Spec(NamedTuple):
    """What one training step needs from the configuration file."""
    lambda_l1: float
    lambda_ssim: float
    lambda_opacity: float
    lambda_scale: float
    background: float
    ppisp: bool
    ppisp_lr: float
    lrs: Dict[str, float]
    positions_lr_final: float
    positions_max_steps: int
    tail_start_frac: float
    tail_final_scale: float
    betas: tuple
    eps: float
    noise_lr: float
    perturb_end: int
    relocate: tuple         # (start, end, frequency)
    add: tuple              # (start, end, frequency)
    opacity_threshold: float
    binom_n_max: int
    max_n_gaussians: int
    settings: ref.Settings


def spec_from(conf: dict) -> Spec:
    t = conf["train"]
    return Spec(
        lambda_l1=t["loss"]["lambda_l1"], lambda_ssim=t["loss"]["lambda_ssim"],
        lambda_opacity=t["loss"]["lambda_opacity"],
        lambda_scale=t["loss"]["lambda_scale"],
        background={"black": 0.0, "white": 1.0}[t["background"]],
        ppisp=t["post_processing"] == "ppisp", ppisp_lr=t["ppisp_lr"],
        lrs=dict(t["lr"]), positions_lr_final=t["positions_lr_final"],
        positions_max_steps=t["positions_max_steps"],
        tail_start_frac=t["tail_start_frac"],
        tail_final_scale=t["tail_final_scale"], betas=tuple(t["betas"]),
        eps=t["eps"], noise_lr=t["perturb_noise_lr"],
        perturb_end=t["perturb_end"],
        relocate=(t["relocate_start"], t["relocate_end"],
                  t["relocate_frequency"]),
        add=(t["add_start"], t["add_end"], t["add_frequency"]),
        opacity_threshold=t["opacity_threshold"],
        binom_n_max=t["binom_n_max"],
        max_n_gaussians=conf["max_n_gaussians"],
        settings=ref.settings_from(conf))


# --- SSIM (11x11 Gaussian window, sigma 1.5, valid padding) -------------

def _window(device) -> torch.Tensor:
    x = np.arange(11, dtype=np.float64) - 5.0
    g = np.exp(-(x ** 2) / (2.0 * 1.5 ** 2))
    return torch.tensor((g / g.sum()).astype(np.float32), device=device)


def ssim(a: torch.Tensor, b: torch.Tensor, precision: str = "fp32"):
    """Mean SSIM of two [H, W, 3] images over the valid windows."""
    rnd = ref.round_tf32 if precision == "tf32" else (lambda v: v)
    x = torch.cat([a, b, a * a, b * b, a * b], -1).permute(2, 0, 1)[None]
    g = _window(a.device)
    c = x.shape[1]
    x = F.conv2d(rnd(x), rnd(g).view(1, 1, 11, 1).expand(c, 1, 11, 1),
                 groups=c)
    x = F.conv2d(rnd(x), rnd(g).view(1, 1, 1, 11).expand(c, 1, 1, 11),
                 groups=c)
    mu1, mu2, m11, m22, m12 = x[0].split(3)
    s1, s2, s12 = m11 - mu1 * mu1, m22 - mu2 * mu2, m12 - mu1 * mu2
    num = (2 * mu1 * mu2 + SSIM_C1) * (2 * s12 + SSIM_C2)
    den = (mu1 * mu1 + mu2 * mu2 + SSIM_C1) * (s1 + s2 + SSIM_C2)
    return (num / den).mean()


# --- PPISP: the learned ISP chain (exposure, vignetting, chromaticity
# homography, camera response) ------------------------------------------

def ppisp_init(n_frames: int, device) -> Dict[str, torch.Tensor]:
    """Identity ISP: every table zero (one camera)."""
    shapes = dict(exposure=(n_frames,), color_latents=(n_frames, 8),
                  responsivity=(1,), vig_center=(1, 3, 2),
                  vig_alpha=(1, 3, 3), crf=(1, 3, 4))
    return {k: torch.zeros(v, device=device) for k, v in shapes.items()}


def _clip(x, lo=None, hi=None):
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


def _mm3(a, b, rnd):
    return (rnd(a)[..., :, :, None] * rnd(b)[..., None, :, :]).sum(-2)


def homography(lat: torch.Tensor, rnd) -> torch.Tensor:
    """[8] colour latents -> [3, 3] chromaticity homography."""
    lat = lat.reshape(4, 2)
    d = (torch.tensor(LATENT_WHITEN, device=lat.device)
         * lat[:, None, :]).sum(-1)
    bd, rd, gd, nd = d.unbind(0)
    one = torch.ones_like(bd[0])
    zero = torch.zeros_like(one)
    t_b = torch.stack([bd[0], bd[1], one])
    t_r = torch.stack([1 + rd[0], rd[1], one])
    t_g = torch.stack([gd[0], 1 + gd[1], one])
    t_n = torch.stack([1 / 3 + nd[0], 1 / 3 + nd[1], one])
    t = torch.stack([t_b, t_r, t_g], -1)
    skew = torch.stack([torch.stack([zero, -t_n[2], t_n[1]]),
                        torch.stack([t_n[2], zero, -t_n[0]]),
                        torch.stack([-t_n[1], t_n[0], zero])])
    m = _mm3(skew, t, rnd)
    c01 = torch.cross(m[0], m[1], dim=-1)
    c02 = torch.cross(m[0], m[2], dim=-1)
    c12 = torch.cross(m[1], m[2], dim=-1)
    lam = torch.where((c01 * c01).sum() >= 1e-20, c01,
                      torch.where((c02 * c02).sum() >= 1e-20, c02, c12))
    h = t * lam[None, :]
    sinv = torch.tensor([[-1.0, -1.0, 1.0], [1.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0]], device=lat.device)
    h = _mm3(h, sinv, rnd)
    s = h[2:3, 2:3]
    big = s.abs() > 1e-20
    return torch.where(big, h / torch.where(big, s, torch.ones_like(s)), h)


def camera_response(x, crf):
    x = _clip(x, 0.0, 1.0)
    toe = 0.3 + F.softplus(crf[:, 0])
    shoulder = 0.3 + F.softplus(crf[:, 1])
    gamma = 0.1 + F.softplus(crf[:, 2])
    center = _clip(torch.sigmoid(crf[:, 3]), 1e-6, 1 - 1e-6)
    lerp = _clip((shoulder - toe) * center + toe, 1e-6)
    a = shoulder * center / lerp
    below = a * torch.pow(_clip(x / center, 1e-12), toe)
    above = 1 - (1 - a) * torch.pow(_clip((1 - x) / (1 - center), 1e-12),
                                    shoulder)
    return torch.pow(_clip(torch.where(x <= center, below, above), 1e-12),
                     gamma)


def ppisp(p: Dict[str, torch.Tensor], rgb: torch.Tensor, frame: int,
          precision: str = "fp32") -> torch.Tensor:
    """The ISP of camera 0 and ``frame`` on an [H, W, 3] radiance image."""
    rnd = ref.round_tf32 if precision == "tf32" else (lambda v: v)
    h, w = rgb.shape[:2]
    m = float(max(h, w))
    ys = (torch.arange(h, device=rgb.device) + 0.5 - h * 0.5) / m
    xs = (torch.arange(w, device=rgb.device) + 0.5 - w * 0.5) / m
    uv = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], -1)
    x = rgb * torch.pow(2.0, p["responsivity"][0]) * torch.pow(
        2.0, p["exposure"][frame])
    delta = uv[:, :, None, :] - p["vig_center"][0][None, None]
    r2 = (delta * delta).sum(-1)
    al = p["vig_alpha"][0]
    fall = (1 + al[None, None, :, 0] * r2 + al[None, None, :, 1] * r2 * r2
            + al[None, None, :, 2] * r2 * r2 * r2)
    x = x * _clip(fall, 0.0, 1.0)
    hm = homography(p["color_latents"][frame], rnd)
    inten = x.sum(-1, keepdim=True)
    rgi = torch.cat([x[..., 0:1], x[..., 1:2], inten], -1)
    rgi = (rnd(hm) * rnd(rgi)[..., None, :]).sum(-1)
    rgi = rgi * (inten / (rgi[..., 2:3] + 1e-5))
    x = torch.cat([rgi[..., 0:1], rgi[..., 1:2],
                   rgi[..., 2:3] - rgi[..., 0:1] - rgi[..., 1:2]], -1)
    return camera_response(x, p["crf"][0])


# --- the step -----------------------------------------------------------

def scene_extent(c2w: List[np.ndarray]) -> float:
    """1.1 x the median camera distance from the median camera centre."""
    c = np.stack([np.asarray(m)[:3, 3] for m in c2w])
    med = np.median(c, axis=0, keepdims=True)
    return float(np.median(np.linalg.norm(c - med, axis=1)) * 1.1)


def learning_rates(spec: Spec, step: int, extent: float) -> Dict[str, float]:
    """Each group's rate at ``step``: the positions' exponential decay
    (scaled by the scene extent), a cosine tail on the constant groups."""
    lrs = {"positions": positions_lr(spec, step, extent)}
    tail = 1.0
    t0 = spec.tail_start_frac * spec.positions_max_steps
    if spec.tail_final_scale < 1.0 and step > t0:
        u = min((step - t0) / max(spec.positions_max_steps - t0, 1.0), 1.0)
        tail = (spec.tail_final_scale + 0.5 * (1 - spec.tail_final_scale)
                * (1 + math.cos(math.pi * u)))
    for k in ("rotation", "scale", "density", "features_albedo",
              "features_specular"):
        lrs[k] = spec.lrs[k] * tail
    return lrs


def positions_lr(spec: Spec, step: int, extent: float) -> float:
    t = float(np.clip(step / spec.positions_max_steps, 0.0, 1.0))
    lo = spec.lrs["positions"] * extent
    hi = spec.positions_lr_final * extent
    return float(np.exp(np.log(lo) * (1 - t) + np.log(hi) * t))


@torch.no_grad()
def adam(params, grads, m, v, lrs, step: int, spec: Spec):
    b1, b2 = spec.betas
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
    for k, p in params.items():
        g = grads[k]
        m[k] = b1 * m[k] + (1 - b1) * g
        v[k] = b2 * v[k] + (1 - b2) * g * g
        p -= lrs[k] * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + spec.eps)


def fires(step: int, schedule: tuple) -> bool:
    """An event of schedule (start, end, frequency) is due after the step
    that brings the count to ``step``: past start, before end (-1: no
    end), on a multiple of the frequency."""
    start, end, freq = schedule
    return (freq > 0 and start >= 0 and step > start
            and (end == -1 or step < end) and step % freq == 0)


def relocation(op: torch.Tensor, scale: torch.Tensor, n: torch.Tensor,
               n_max: int):
    """3DGS as MCMC, Eq. 9: the opacity and scale of each of ``n``
    particles that now share one's place, such that together they render
    as the one did. The double sum over i <= n and k < i is taken over k
    alone, with sum_{i=k+1..n} C(i-1, k) = C(n, k+1). Computed in float64;
    returns float32."""
    op, scale = op.double(), scale.double()
    n = n.clamp(1, n_max)
    new_op = 1.0 - (1.0 - op) ** (1.0 / n.double())
    comb = torch.tensor([[math.comb(a, b) for b in range(n_max + 1)]
                         for a in range(n_max + 1)], dtype=torch.float64,
                        device=op.device)[n]
    denom = torch.zeros_like(op)
    for k in range(n_max):
        denom = denom + (comb[:, k + 1] * (-1.0) ** k / math.sqrt(k + 1)
                         * new_op ** (k + 1))
    coeff = op / torch.where(denom == 0, torch.ones_like(denom), denom)
    return new_op.float(), (coeff[:, None] * scale).float()


@torch.no_grad()
def relocate(params, moments, gen: torch.Generator, spec: Spec) -> int:
    """MCMC's relocate: each dead particle (opacity at most the threshold)
    takes the place of a live one drawn in proportion to its opacity; the
    drawn ones and their copies share their opacity by Eq. 9, and the
    optimizer's moments of every row involved start again. The draw is
    made as the trainer's (one draw a row, with replacement, from the
    trainer's generator). Returns the dead rows and the rows involved
    (dead or drawn)."""
    op = torch.sigmoid(params["density"][:, 0])
    n_rows = op.shape[0]
    dead = op <= spec.opacity_threshold
    probs = torch.where(dead, torch.zeros_like(op), op)
    src = torch.multinomial(probs, n_rows, replacement=True, generator=gen)
    targets = src[dead]
    copies = torch.bincount(targets, minlength=n_rows)
    new_op, new_scale = relocation(op[targets],
                                   torch.exp(params["scale"])[targets],
                                   copies[targets] + 1, spec.binom_n_max)
    params["density"][targets] = torch.logit(
        new_op.clamp(0.005, 1.0 - 1.19e-7))[:, None]
    params["scale"][targets] = torch.log(new_scale.clamp_min(1e-30))
    for p in params.values():
        p[dead] = p[targets]
    reset = dead.clone()
    reset[targets] = True
    for mom in moments:
        for k in params:
            mom[k][reset] = 0.0
    return dead, reset


@torch.no_grad()
def add_at_cap(params, gen: torch.Generator, spec: Spec):
    """MCMC's add once the count has reached ``max_n_gaussians``: the
    trainer still draws its targets (its generator moves on), and no
    particle is added. The cells start at the cap."""
    op = torch.sigmoid(params["density"][:, 0])
    if op.shape[0] < spec.max_n_gaussians:
        raise ValueError("the reference's add is the one at the cap")
    torch.multinomial(op, op.shape[0], replacement=True, generator=gen)


@torch.no_grad()
def perturb(params, gen: torch.Generator, lr: float, noise_lr: float):
    """MCMC's exploration noise: R S S^T R^T times standard normals, gated
    to the nearly transparent particles, scaled by noise_lr * lr."""
    n = params["positions"].shape[0]
    op = torch.sigmoid(params["density"])
    gate = 1.0 / (1.0 + torch.exp(-100.0 * ((1.0 - op) - 0.995)))
    noise = torch.randn((n, 3), generator=gen, device=gen.device)
    noise = noise * gate * noise_lr * np.float32(lr)
    rs = (ref.quat_to_rotmat(ref.unit_quat(params["rotation"]))
          * torch.exp(params["scale"])[:, None, :])
    cov = torch.einsum("nij,nkj->nik", rs, rs)
    params["positions"] += torch.einsum("nij,nj->ni", cov, noise)


class StepReadings(NamedTuple):
    losses: List[float]
    pairs: List[int]
    grad_norms: Dict[str, float]       # the first step's, by leaf
    change: Dict[str, torch.Tensor]    # each leaf's change over the steps
    touched: torch.Tensor              # [rows] bool: relocate moved or drew
    relocated: int                     # the particles relocate moved
    rows: Dict[str, torch.Tensor]      # row_summary of the last state
    # the reference's alone: relocate's dead rows, and the opacity and
    # scale of every row just before it (the steps hold one relocate)
    dead: Optional[torch.Tensor] = None
    pre: Optional[Dict[str, torch.Tensor]] = None
    binom_n_max: int = 51


# every leaf but the position: a relocated row and its source agree in
# each bit of these (the perturbation moves positions alone)
COPIED_LEAVES = ("rotation", "scale", "density", "features_albedo",
                 "features_specular")
_HASH_P = 2 ** 31 - 1


def row_summary(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """On the host: each row's key (a hash of its bits in
    ``COPIED_LEAVES``: rows that are copies of one another share it, others
    differ but by chance of about 1e-18 a pair), raw density and raw
    scale."""
    x = torch.cat([params[k].detach().reshape(params[k].shape[0], -1)
                   for k in COPIED_LEAVES], 1).contiguous()
    bits = (x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) % _HASH_P
    gen = torch.Generator().manual_seed(0)
    key = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for _ in range(2):
        c = torch.randint(1, _HASH_P, (x.shape[1],), generator=gen,
                          dtype=torch.int64).to(x.device)
        key = key * _HASH_P + (bits * c % _HASH_P).sum(1) % _HASH_P
    return {"key": key.cpu(),
            "density": params["density"].detach().to("cpu", copy=True),
            "scale": params["scale"].detach().to("cpu", copy=True)}


def train_steps(params: Dict[str, torch.Tensor], views, frames: List[int],
                spec: Spec, start_step: int, sh_degree: int, extent: float,
                noise_seed: int, precision: str = "fp32",
                drop_half: bool = False) -> StepReadings:
    """``len(frames)`` steps from ``params`` (raw, updated in place) on
    ``views[frame]`` (each a (Camera, GT [H, W, 3]) pair), the first at
    global step ``start_step``. ``drop_half`` takes the loss's mean over
    the image's top half only (a planted fault). The change is returned
    on the host."""
    dev = params["positions"].device
    init = {k: v.clone() for k, v in params.items()}
    isp = ppisp_init(len(views), dev) if spec.ppisp else {}
    init.update({f"ppisp/{k}": v.clone() for k, v in isp.items()})
    leaves = dict(params)
    leaves.update({f"ppisp/{k}": v for k, v in isp.items()})
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    gen = torch.Generator(device=dev).manual_seed(noise_seed)
    bg = torch.full((3,), spec.background, device=dev)
    touched = torch.zeros(params["positions"].shape[0], dtype=torch.bool,
                          device=dev)
    dead, pre = None, None
    losses, pairs = [], []
    for i, frame in enumerate(frames):
        step = start_step + i
        cam, gt = views[frame]
        for t in leaves.values():
            t.requires_grad_(True)
            t.grad = None

        def image_loss(color, opac):
            pred = color + bg * (1.0 - opac)
            if spec.ppisp:
                pred = ppisp(isp, pred, frame, precision)
            target = gt
            if drop_half:
                half = pred.shape[0] // 2
                pred, target = pred[:half], gt[:half]
            loss = (spec.lambda_l1 * torch.mean(torch.abs(pred - target))
                    + spec.lambda_ssim * (1.0 - ssim(pred, target,
                                                     precision)))
            if spec.lambda_opacity:
                loss = loss + spec.lambda_opacity * torch.mean(
                    torch.abs(torch.sigmoid(params["density"])))
            if spec.lambda_scale:
                loss = loss + spec.lambda_scale * torch.mean(
                    torch.abs(torch.exp(params["scale"])))
            return loss

        loss, n_pairs = ref.render_backward(params, cam, spec.settings,
                                            sh_degree, image_loss, precision)
        grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for k, t in leaves.items()}
        for t in leaves.values():
            t.requires_grad_(False)
            t.grad = None
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(g))
                          for k, g in grads.items()}
        lrs = learning_rates(spec, step, extent)
        lrs.update({k: spec.ppisp_lr for k in leaves if k.startswith("ppisp/")})
        adam(leaves, grads, m, v2, lrs, i + 1, spec)
        if fires(step + 1, spec.relocate):
            pre = {"op": torch.sigmoid(params["density"][:, 0]).cpu(),
                   "scale": torch.exp(params["scale"]).cpu()}
            dead, rows = relocate(params, (m, v2), gen, spec)
            touched |= rows
        if fires(step + 1, spec.add):
            add_at_cap(params, gen, spec)
        if step + 1 < spec.perturb_end:
            perturb(params, gen, positions_lr(spec, step + 1, extent),
                    spec.noise_lr)
        losses.append(loss)
        pairs.append(n_pairs)
    change = {k: (leaves[k] - init.pop(k)).cpu() for k in leaves}
    return StepReadings(
        losses, pairs, grad_norms, change, touched.cpu(),
        0 if dead is None else int(dead.sum()), row_summary(params),
        None if dead is None else dead.cpu(), pre, spec.binom_n_max)


def change_norms(r: StepReadings, keep: torch.Tensor) -> Dict[str, float]:
    """Each leaf's change norm over the rows ``keep`` (the leaves of the
    particles' rows; the ISP's whole)."""
    rows = keep.shape[0]
    return {k: float(torch.linalg.vector_norm(
        c[keep] if c.shape[0] == rows else c)) for k, c in r.change.items()}


def relocate_check(got: StepReadings, want: StepReadings
                   ) -> Dict[str, float]:
    """Holds ``got``'s last state to relocate's invariants on the
    reference's dead rows, whichever live rows its draw chose: each dead
    row shares its key with exactly one live row, its source; the group
    of a source and its n - 1 copies carries the density and scale that
    Eq. 9 gives for n copies of the source's opacity and scale before the
    relocate (the reference's), within the most by which those differ
    between the two sides on any row relocate left alone, plus 1e-4; no
    live row shares its key with another live row. Returns the share of
    rows that break one, over the dead rows (under "gap"), and the count
    of each kind."""
    out = {"gap": 0.0, "unmatched": 0, "formula": 0, "live_copied": 0}
    if want.dead is None:
        return out
    dead = want.dead
    keep = ~(got.touched | want.touched)
    env = {k: float((got.change[k] - want.change[k]).abs()[keep].max())
           if bool(keep.any()) else 0.0 for k in ("density", "scale")}
    _, group, size = torch.unique(got.rows["key"], return_inverse=True,
                                  return_counts=True)
    live = torch.zeros_like(size).index_add_(0, group, (~dead).long())
    source = torch.full_like(size, -1)
    idx = torch.arange(dead.shape[0])
    source[group[~dead]] = idx[~dead]
    d = idx[dead]
    g = group[d]
    matched = (size[g] >= 2) & (live[g] == 1)
    d, g = d[matched], g[matched]
    s = source[g]
    new_op, new_scale = relocation(want.pre["op"][s], want.pre["scale"][s],
                                   size[g], want.binom_n_max)
    want_d = torch.logit(new_op.clamp(0.005, 1.0 - 1.19e-7))
    want_s = torch.log(new_scale.clamp_min(1e-30))
    off = ((got.rows["density"][d, 0] - want_d).abs()
           > env["density"] + 1e-4) | (
        (got.rows["scale"][d] - want_s).abs().amax(1)
        > env["scale"] + env["density"] + 1e-4)
    copied = (~dead) & (live[group] >= 2)
    out.update(unmatched=int((~matched).sum()), formula=int(off.sum()),
               live_copied=int(copied.sum()))
    out["gap"] = (out["unmatched"] + out["formula"] + out["live_copied"]) / (
        max(int(dead.sum()), 1))
    return out


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             keep: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between two norms, against the larger of that
    leaf's reference norm and the median leaf's."""
    keys = keep if keep is not None else list(want)
    med = float(np.median([want[k] for k in want]))
    return max((abs(got[k] - want[k]) / max(want[k], med, 1e-30)
                for k in keys), default=0.0)
