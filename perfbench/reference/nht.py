"""Plain PyTorch training step of the benchmark's NHT configuration (3DGUT
with Neural Harmonic Textures): the reference that the timed
``Trainer.train_iteration`` of an NHT model is held to.

The published model (3dgrut's neuralHarmonicFeaturesParticle.slang and
model/feature_decoder.py; configs/base.yaml ``model.nht_features`` and
``model.nht_decoder``), written again in fp32 with TF32 off and no
kernel:

- each particle carries d control features at each of the 4 vertices
  of a regular tetrahedron in its canonical frame (vertices at distance
  3 from the centre: the 3-sigma sphere's inscribed tetrahedron);
- a ray's hit is ``render.py``'s: the canonical point where the ray
  passes closest to the centre. Its barycentric weights in the
  tetrahedron blend the vertex features, b_k = sum_v w_v f[v d + k];
  the ray features are (sin b_k, cos b_k), interleaved by k;
- the 2 d ray features and the opacity are composited in global depth
  order with ``render.py``'s exact kill, over its blocks of tiles;
- the decoder: the ray direction's tcnn SH encoding (9 components) after
  the cube map (v * 3 + 1) / 2 -> [-1, 1], beside the ray features;
  three bias-free ReLU layers of 128 and a bias-free 3-wide layer, then
  a sigmoid; the background after it;
- ``train.py``'s loss, with the gradient of every leaf (the particles'
  5 and the decoder's 4 weights), Adam with the features' and the
  decoder's cosine rates (to a tenth over ``max_steps``), MCMC's events,
  and the decoder's EMA shadow after each step.

Departures from the published description, each the port's too:

- The direction encoding's degree-2 term at component 6 is written in
  the 3DGS form 0.315 (2 z^2 - x^2 - y^2). tiny-cuda-nn writes it
  0.946 z^2 - 0.315, equal for a unit argument; the cube map hands it
  3 v (|3 v| = 3), where the two differ by the constant 8 x 0.315.
  The JAX package and the port take the 3DGS form.
- fp32 particle and ray features and an fp32 decoder where the
  configuration asks for fp16 (``particle_feature_half``,
  ``feature_output_half``, a half-precision tcnn network).

``precision`` "tf32" rounds both operands of every product-sum to TF32
(``render.py``'s, the hit's blend and compositing, the decoder's
products); "bf16_decoder" computes the decoder's products in bf16 alone
(operands, outputs and their cotangents rounded to bf16, accumulated in
fp32, as a bf16 matrix product does). Both are controls of the check.
``fault`` plants a fault in the reference: "half" (the loss over the
image's top half), "no_dir" (zeros for the direction encoding),
"no_cos" (the cosine half of the ray features dropped) or "no_ema" (the
EMA shadow left alone).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import render as ref
from . import train as ref_train

# fp32 products stay fp32 (render.py sets the same on import)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the canonical tetrahedron (neuralHarmonicFeaturesParticle.slang): its
# vertices, and the rows of its inverse edge matrix, which map a point's
# offset from vertex 0 to barycentric weights 1-3
_EDGE = math.sqrt(24.0)
TETRA = np.array([(0.5 * _EDGE, -math.sqrt(2.0), -1.0),
                  (-0.5 * _EDGE, -math.sqrt(2.0), -1.0),
                  (0.0, _EDGE * math.sqrt(3.0) / 2.0 - math.sqrt(2.0), -1.0),
                  (0.0, 0.0, 3.0)])
TETRA_INV = np.linalg.inv((TETRA[1:] - TETRA[0]).T)

SH_SCALE = 3.0
DIR_SH_DEGREE = 2        # tcnn's degree 3: bands 0-2, 9 components
# blocks a fifth of render.py's: each evaluation carries 2 d features
BUDGET = 1 << 22


class NhtSpec(NamedTuple):
    """The NHT settings of one step beside ``train.Spec``."""
    features_lr: float
    features_decay_final: float
    features_max_steps: int
    decoder_lr: float
    decoder_decay_final: float
    decoder_max_steps: int
    ema_decay: float


def nht_spec_from(conf: dict) -> NhtSpec:
    n, d = conf["nht"], conf["nht"]["decoder"]
    return NhtSpec(n["features_lr"], n["features_decay_final"],
                   n["features_max_steps"], d["learning_rate"],
                   d["decay_final"], d["max_steps"], d["ema_decay"])


def cosine(lr: float, final: float, max_steps: int, step: int) -> float:
    """``lr`` cosine-decayed to ``lr * final`` over ``max_steps``."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return lr * final + 0.5 * (lr - lr * final) * (1 + math.cos(math.pi * t))


def _rounding(precision: str):
    return ref.round_tf32 if precision == "tf32" else (lambda v: v)


def geometry_terms(params: Dict[str, torch.Tensor], origin: torch.Tensor,
                   precision: str = "fp32") -> Dict[str, torch.Tensor]:
    """Per-particle inputs of the hit test (``render.particle_terms``
    without the SH colour), and the control features."""
    rnd = _rounding(precision)
    rot = ref.quat_to_rotmat(ref.unit_quat(params["rotation"]))
    m = (1.0 / torch.exp(params["scale"]))[:, :, None] * rot.transpose(1, 2)
    a = torch.einsum("nij,nj->ni", rnd(m), rnd(origin - params["positions"]))
    return {"m": m, "a": a, "opac": torch.sigmoid(params["density"][:, 0]),
            "features": params["features"]}


def hit_features(features: torch.Tensor, canonical: torch.Tensor,
                 precision: str = "fp32") -> torch.Tensor:
    """[P, 256, 2 d] ray features of particles' control features [P, 4 d]
    (vertex-major) at canonical hit points [P, 256, 3]."""
    rnd = _rounding(precision)
    dev = canonical.device
    inv = torch.tensor(TETRA_INV, dtype=torch.float32, device=dev)
    w123 = torch.einsum("ij,pnj->pni", rnd(inv), rnd(
        canonical - torch.tensor(TETRA[0], dtype=torch.float32, device=dev)))
    w = torch.cat([1.0 - w123.sum(-1, keepdim=True), w123], -1)
    d = features.shape[1] // 4
    blend = torch.bmm(rnd(w), rnd(features.reshape(-1, 4, d)))
    return torch.stack([torch.sin(blend), torch.cos(blend)], -1).flatten(-2)


def composite_block(blk: ref.Block, pairs: ref.Pairs, terms, rays: ref.Rays,
                    s: ref.Settings, precision: str = "fp32"):
    """Ray features [T_b, 256, 2 d] and opacity [T_b, 256, 1] of a block's
    tiles: ``render.composite_block``'s hit and kill, the features at each
    hit in place of a particle's colour."""
    rnd = _rounding(precision)
    g = pairs.particle[blk.p0:blk.p1]
    lt = pairs.tile[blk.p0:blk.p1] - blk.t0
    n_t = blk.t1 - blk.t0
    d = rays.dirs[blk.t0:blk.t1][lt]                         # [P, 256, 3]
    grdu = torch.bmm(rnd(d), rnd(terms["m"][g]).transpose(1, 2))
    inv_len = torch.rsqrt(torch.clamp((grdu * grdu).sum(-1, keepdim=True),
                                      min=1e-32))
    grd = grdu * inv_len
    gro = terms["a"][g][:, None, :].expand_as(grd)
    cr = torch.cross(grd, gro, dim=-1)
    resp = torch.exp(-0.5 * (cr * cr).sum(-1))
    alpha = torch.clamp(resp * terms["opac"][g][:, None], max=s.max_alpha)
    proj = -(grd * gro).sum(-1)
    t_hit = proj * inv_len[..., 0]
    ok = ((resp > s.min_response) & (alpha > s.alpha_threshold)
          & (t_hit > rays.tmin[blk.t0:blk.t1][lt])
          & (t_hit < rays.tmax[blk.t0:blk.t1][lt]))
    a = torch.where(ok, alpha, torch.zeros_like(alpha)).double()
    lg = torch.log1p(-a)
    cs = torch.cumsum(lg, 0)
    start = pairs.tile_start[blk.t0:blk.t1] - blk.p0
    base = torch.where(start[:, None] > 0,
                       cs[torch.clamp(start - 1, min=0)],
                       torch.zeros_like(cs[:1]).expand(n_t, -1))
    trans = torch.exp(cs - lg - base[lt])
    alive = trans.detach() >= s.min_transmittance
    w = torch.where(alive, a * trans, torch.zeros_like(a))
    feats = hit_features(terms["features"][g],
                         gro + grd * proj[..., None], precision)
    if precision == "tf32":
        contrib = (ref.round_tf32(w.float()).double()[..., None]
                   * ref.round_tf32(feats).double())
    else:
        contrib = w[..., None] * feats.double()
    out = torch.zeros((n_t, ref.TILE_PIXELS, feats.shape[-1]),
                      dtype=torch.float64, device=a.device).index_add(
                          0, lt, contrib)
    n_alive = torch.zeros((n_t, ref.TILE_PIXELS), dtype=torch.long,
                          device=a.device).index_add(0, lt, alive.long())
    length = (pairs.tile_start[blk.t0 + 1:blk.t1 + 1]
              - pairs.tile_start[blk.t0:blk.t1])[:, None]
    total = torch.zeros((n_t, ref.TILE_PIXELS), dtype=torch.float64,
                        device=a.device).index_add(0, lt, lg)
    at = torch.clamp(start[:, None] + n_alive, max=blk.p1 - blk.p0 - 1)
    t_final = torch.where(n_alive < length, torch.gather(trans, 0, at),
                          torch.exp(total))
    return out.float(), (1.0 - t_final).float()[..., None]


def direction_encoding(dirs: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit directions -> [..., 9]: SH bands 0-2 at the cube
    map's 3 v (the module docstring's departure)."""
    return ref.sh_basis(((dirs * SH_SCALE + 1.0) * 0.5) * 2.0 - 1.0,
                        DIR_SH_DEGREE)


def _product(x: torch.Tensor, w: torch.Tensor, precision: str):
    """x [N, K] times w [M, K]^T."""
    if precision == "tf32":
        return ref.round_tf32(x) @ ref.round_tf32(w).t()
    if precision == "bf16_decoder":
        bf = torch.bfloat16
        y = x.to(bf).float() @ w.to(bf).float().t()
        return y.to(bf).float()
    return x @ w.t()


def decode(features: torch.Tensor, dirs: torch.Tensor,
           weights: List[torch.Tensor], precision: str = "fp32",
           no_dir: bool = False) -> torch.Tensor:
    """RGB [H, W, 3] of ray features [H, W, F] along unit dirs [H, W, 3]."""
    enc = direction_encoding(dirs)
    if no_dir:
        enc = torch.zeros_like(enc)
    x = torch.cat([features, enc], -1)
    h, w = x.shape[:2]
    x = x.reshape(h * w, -1)
    for wt in weights[:-1]:
        x = torch.relu(_product(x, wt, precision))
    return torch.sigmoid(_product(x, weights[-1], precision)).reshape(h, w, 3)


def render_backward(params: Dict[str, torch.Tensor],
                    weights: List[torch.Tensor], cam: ref.Camera,
                    s: ref.Settings, image_loss, precision: str = "fp32",
                    fault: Optional[str] = None, budget: int = BUDGET):
    """Render a view's ray features, decode them, take
    ``image_loss(rgb, opacity)`` and accumulate the gradient of the loss
    into ``.grad`` of the raw parameters and the decoder's weights (as
    ``render.render_backward``: the forward in blocks without a graph,
    then each block again with autograd against the image's cotangent).
    Returns (loss value, number of pairs, the decoded image)."""
    pairs, rays = ref.prepare(params, cam, s, precision)
    terms = geometry_terms(params, rays.origin, precision)
    leaves = {k: v.detach().requires_grad_() for k, v in terms.items()}
    bl = ref.blocks(pairs, budget)
    n_t = pairs.tile_start.numel() - 1
    dev = rays.dirs.device
    nf = 2 * (params["features"].shape[1] // 4)
    with torch.no_grad():
        feat = torch.zeros((n_t, ref.TILE_PIXELS, nf), device=dev)
        opac = torch.zeros((n_t, ref.TILE_PIXELS, 1), device=dev)
        for blk in bl:
            f, o = composite_block(blk, pairs, leaves, rays, s, precision)
            feat[blk.t0:blk.t1] = f
            opac[blk.t0:blk.t1] = o
    feat.requires_grad_()
    opac.requires_grad_()
    img = ref.untile(feat, cam, pairs.grid)
    if fault == "no_cos":
        img = img * (torch.arange(nf, device=dev) % 2 == 0)
    rgb = decode(img, ref.untile(rays.dirs, cam, pairs.grid), weights,
                 precision, no_dir=fault == "no_dir")
    loss = image_loss(rgb, ref.untile(opac, cam, pairs.grid))
    loss.backward()
    for blk in bl:
        f, o = composite_block(blk, pairs, leaves, rays, s, precision)
        torch.autograd.backward([f, o], [feat.grad[blk.t0:blk.t1],
                                         opac.grad[blk.t0:blk.t1]])
    outs = [terms[k] for k in leaves if leaves[k].grad is not None]
    grads = [leaves[k].grad for k in leaves if leaves[k].grad is not None]
    torch.autograd.backward(outs, grads)
    return float(loss.detach()), int(pairs.tile.numel()), rgb.detach()


@torch.no_grad()
def count_view(params: Dict[str, torch.Tensor], cam: ref.Camera,
               s: ref.Settings) -> dict:
    """The contributing (particle, pixel) evaluations of a view and the
    particles that contribute (``render.render``'s counts: the geometry
    alone decides them)."""
    pairs, rays = ref.prepare(params, cam, s)
    terms = geometry_terms(params, rays.origin)
    terms["rgb"] = torch.zeros_like(params["positions"])
    c = {"evals": 0, "particles": torch.zeros(
        params["positions"].shape[0], dtype=torch.bool,
        device=rays.dirs.device)}
    for blk in ref.blocks(pairs):
        ref.composite_block(blk, pairs, terms, rays, s, counts=c)
    return c


def row_summary(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``train.row_summary`` of an NHT state: the control features take
    the SH features' place among the leaves a relocated row copies."""
    return ref_train.row_summary({
        **params, "features_albedo": params["features"],
        "features_specular": params["features"][:, :0]})


class Readings(NamedTuple):
    steps: ref_train.StepReadings      # the decoder's leaves among them
    ema_change: Dict[str, torch.Tensor]  # by decoder leaf, on the host
    rgb: torch.Tensor                  # the first step's decoded image


def decoder_key(i: int) -> str:
    return f"nht_decoder/{i}"


def train_steps(params: Dict[str, torch.Tensor], weights: List[torch.Tensor],
                views, frames: List[int], spec: ref_train.Spec, nht: NhtSpec,
                start_step: int, extent: float, noise_seed: int,
                precision: str = "fp32", fault: Optional[str] = None
                ) -> Readings:
    """``len(frames)`` steps from ``params`` (raw, updated in place) and
    the decoder's ``weights`` (input layer first, [out, in]) on
    ``views[frame]``, the first at global step ``start_step``; as
    ``train.train_steps``, with the decoder, its EMA shadow and the first
    step's decoded image [H, W, 3] (on the host)."""
    if spec.ppisp:
        raise ValueError("the NHT reference has no ISP")
    dev = params["positions"].device
    weights = [w.detach().clone() for w in weights]
    shadow = [w.clone() for w in weights]
    leaves = dict(params)
    leaves.update({decoder_key(i): w for i, w in enumerate(weights)})
    init = {k: v.clone() for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    gen = torch.Generator(device=dev).manual_seed(noise_seed)
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

        def image_loss(rgb, opac):
            pred = rgb + spec.background * (1.0 - opac)
            target = gt
            if fault == "half":
                half = pred.shape[0] // 2
                pred, target = pred[:half], gt[:half]
            loss = (spec.lambda_l1 * torch.mean(torch.abs(pred - target))
                    + spec.lambda_ssim * (1.0 - ref_train.ssim(
                        pred, target, precision)))
            if spec.lambda_opacity:
                loss = loss + spec.lambda_opacity * torch.mean(
                    torch.abs(torch.sigmoid(params["density"])))
            if spec.lambda_scale:
                loss = loss + spec.lambda_scale * torch.mean(
                    torch.abs(torch.exp(params["scale"])))
            return loss

        loss, n_pairs, rgb = render_backward(
            params, weights, cam, spec.settings, image_loss, precision,
            fault)
        if i == 0:
            rgb0 = rgb.cpu()
        grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for k, t in leaves.items()}
        for t in leaves.values():
            t.requires_grad_(False)
            t.grad = None
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(g))
                          for k, g in grads.items()}
        lrs = ref_train.learning_rates(spec, step, extent)
        lrs["features"] = cosine(nht.features_lr, nht.features_decay_final,
                                 nht.features_max_steps, step)
        lr_dec = cosine(nht.decoder_lr, nht.decoder_decay_final,
                        nht.decoder_max_steps, step)
        lrs.update({decoder_key(j): lr_dec for j in range(len(weights))})
        ref_train.adam(leaves, grads, m, v2, lrs, i + 1, spec)
        if fault != "no_ema":
            for sh, w in zip(shadow, weights):
                sh.copy_(nht.ema_decay * sh + (1.0 - nht.ema_decay) * w)
        if ref_train.fires(step + 1, spec.relocate):
            pre = {"op": torch.sigmoid(params["density"][:, 0]).cpu(),
                   "scale": torch.exp(params["scale"]).cpu()}
            dead, rows = ref_train.relocate(params, (m, v2), gen, spec)
            touched |= rows
        if ref_train.fires(step + 1, spec.add):
            ref_train.add_at_cap(params, gen, spec)
        if step + 1 < spec.perturb_end:
            ref_train.perturb(params, gen,
                              ref_train.positions_lr(spec, step + 1, extent),
                              spec.noise_lr)
        losses.append(loss)
        pairs.append(n_pairs)
    ema = {decoder_key(j): (sh - init[decoder_key(j)]).cpu()
           for j, sh in enumerate(shadow)}
    change = {k: (leaves[k] - init.pop(k)).cpu() for k in leaves}
    steps = ref_train.StepReadings(
        losses, pairs, grad_norms, change, touched.cpu(),
        0 if dead is None else int(dead.sum()), row_summary(params),
        None if dead is None else dead.cpu(), pre, spec.binom_n_max)
    return Readings(steps, ema, rgb0)
