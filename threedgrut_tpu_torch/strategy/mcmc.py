"""The MCMC densification strategy (3DGS as MCMC) on the capacity layout
(port of threedgrut_tpu/strategy/mcmc.py:37-229; reference
threedgrut/strategy/mcmc.py:50-224 and its relocation kernel
strategy/src/gaussian_mcmc.cu:36-69):

- relocate: dead particles (opacity <= threshold) move onto samples of
  the live ones drawn in proportion to their opacity; each target's
  opacity and scale are rescaled by the binomial correction for the
  number of copies it now has (Eq. 9 of the MCMC paper), and the Adam
  moments of the moved rows and of their targets are zeroed;
- add: the count grows by 5% (up to the capacity and max_n_gaussians)
  with copies of samples drawn the same way;
- perturb: positions get noise shaped by each particle's covariance,
  scaled by op_sigmoid(1 - opacity) * noise_lr * the position lr.

Samples come from ``torch.multinomial`` with replacement on the
trainer's generator: the distribution of JAX's categorical over the
log-opacities, not its values. Everything updates the model and the
Adam state in place, through ``strategy/base.py`` for appended rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..models.gaussians import INVERSE_ACTIVATIONS, GaussianModel
from ..ops.quaternion import quat_normalize, quat_to_rotmat
from ..optimizers.adam import AdamState
from . import base


@dataclasses.dataclass(frozen=True)
class MCMCStrategyConfig:
    """configs/strategy/mcmc.yaml."""
    binom_n_max: int = 51
    opacity_threshold: float = 0.005
    relocate_frequency: int = 100
    relocate_start: int = 500
    relocate_end: int = 25000
    add_frequency: int = 100
    add_start: int = 500
    add_end: int = 25000
    max_n_gaussians: int = 1000000
    perturb_frequency: int = 1
    perturb_start: int = 0
    perturb_end: int = 27500
    noise_lr: float = 5e5

    def replace(self, **kw) -> "MCMCStrategyConfig":
        return dataclasses.replace(self, **kw)


def _binom_table(n_max: int, device) -> torch.Tensor:
    """[n, k] = C(n, k) for n, k < n_max (0 above the diagonal), f32."""
    return torch.tensor([[math.comb(n, k) if k <= n else 0
                          for k in range(n_max)] for n in range(n_max)],
                        dtype=torch.float32, device=device)


def compute_relocation(opacities: torch.Tensor, scales: torch.Tensor,
                       ratios: torch.Tensor, n_max: int = 51):
    """The binomial opacity and scale rescale (gaussian_mcmc.cu:36-69):
    opacities [N] post-activation, scales [N, 3], ratios [N] integer copy
    counts (clamped to [1, n_max]). Returns (new opacities [N], new
    scales [N, 3])."""
    ratios = torch.clamp(ratios.to(torch.int64), 1, n_max)
    new_op = 1.0 - torch.pow(1.0 - opacities,
                             1.0 / ratios.to(torch.float32))
    # denom = sum_{i=1..n} sum_{k=0..i-1} C(i-1, k) (-1)^k / sqrt(k+1)
    #         new_op^(k+1); the weight of term k is the cumulative
    # binomial sum_{i=1..n} C(i-1, k)
    ks = torch.arange(n_max, dtype=torch.float32, device=opacities.device)
    sign = torch.pow(-1.0, ks)
    term = (sign / torch.sqrt(ks + 1.0))[None, :] * torch.pow(
        new_op[:, None], ks[None, :] + 1.0)
    cum_binom = torch.cumsum(_binom_table(n_max, opacities.device), dim=0)
    denom = torch.sum(cum_binom[ratios - 1] * term, dim=1)
    coeff = opacities / torch.where(denom == 0.0, torch.ones_like(denom),
                                    denom)
    return new_op, coeff[:, None] * scales


def _sample_targets(generator: torch.Generator, probs: torch.Tensor,
                    n_samples: int) -> torch.Tensor:
    """[n_samples] rows drawn with replacement in proportion to ``probs``
    (mcmc.py:_sample_targets); row 0 each time when every probability is
    zero, as JAX's categorical over all -inf logits gives."""
    if not bool((probs > 0.0).any()):
        return torch.zeros(n_samples, dtype=torch.int64, device=probs.device)
    return torch.multinomial(probs, n_samples, replacement=True,
                             generator=generator)


def _relocation_updates(model: GaussianModel, sampled: torch.Tensor,
                        move_mask: torch.Tensor, n_max: int):
    """The shared math of relocate and add (mcmc.py:96-120): each target's
    copy count, then the raw density [C, 1] and raw scale [C, 3] that the
    rescale gives every slot's target. ``sampled`` [C] is the target of
    each slot, ``move_mask`` [C] the slots that take a copy."""
    cap = model.capacity
    counts = torch.zeros(cap, dtype=torch.int64, device=sampled.device)
    counts.index_add_(0, sampled, move_mask.to(torch.int64))
    ratios = torch.clamp(counts[sampled] + 1, 1, n_max)
    new_op, new_scales = compute_relocation(
        model.get_density()[:, 0][sampled], model.get_scale()[sampled],
        ratios, n_max)
    new_op = torch.clamp(new_op, 0.005, 1.0 - 1.19e-7)
    raw_op = INVERSE_ACTIVATIONS[model.config.density_activation](new_op)
    raw_scale = INVERSE_ACTIVATIONS[model.config.scale_activation](
        torch.clamp(new_scales, min=1e-30))
    return raw_op[:, None], raw_scale


def _rescale_targets(model: GaussianModel, sampled, move_mask, n_max):
    """Write the rescaled density and scale onto the targets of the
    moving slots; returns those targets."""
    raw_op, raw_scale = _relocation_updates(model, sampled, move_mask, n_max)
    targets = sampled[move_mask]
    # slots that share a target carry the same values: the writes agree
    model.density.data[targets] = raw_op[move_mask]
    model.scale.data[targets] = raw_scale[move_mask]
    return targets


@torch.no_grad()
def relocate(model: GaussianModel, opt: AdamState, generator: torch.Generator,
             opacity_threshold: float = 0.005, n_max: int = 51) -> int:
    """mcmc.py:123-164: move the dead particles onto opacity-weighted
    samples of the live ones, rescale the targets, zero the moments of
    both. Returns the number of particles moved."""
    cap = model.capacity
    active = model.active_mask()
    dens = model.get_density()[:, 0]
    dead = active & (dens <= opacity_threshold)
    alive = active & (dens > opacity_threshold)
    sampled = _sample_targets(generator, torch.where(
        alive, dens, torch.zeros_like(dens)), cap)
    targets = _rescale_targets(model, sampled, dead, n_max)
    # targets are alive, so the copies read no row they write
    for p in model.params().values():
        p.data[dead] = p.data[targets]
    touched = dead.clone()
    touched[targets] = True
    base.reset_moments_rows(opt, touched)
    return int(dead.sum())


@torch.no_grad()
def add_gaussians(model: GaussianModel, opt: AdamState,
                  generator: torch.Generator, max_n: int = 1_000_000,
                  growth: float = 1.05, n_max: int = 51) -> int:
    """mcmc.py:167-209: grow the count by ``growth`` (to max_n and the
    capacity) with copies of opacity-weighted samples of the live
    particles, both rescaled. Returns the number of rows added."""
    cap, n = model.capacity, model.n_active
    # the JAX target: growth * n in fp32, truncated
    target = min(int(np.float32(growth) * np.float32(n)), max_n, cap)
    n_add = max(target - n, 0)
    active = model.active_mask()
    dens = model.get_density()[:, 0]
    sampled = _sample_targets(generator, torch.where(
        active, dens, torch.zeros_like(dens)), cap)
    add_mask = torch.arange(cap, device=sampled.device) < n_add
    targets = _rescale_targets(model, sampled, add_mask, n_max)
    # the new rows copy the (rescaled) targets
    new_rows = {k: p.data[targets] for k, p in model.params().items()}
    touched = torch.zeros(cap, dtype=torch.bool, device=sampled.device)
    touched[targets] = True
    base.reset_moments_rows(opt, touched)
    base.append_rows(model, opt, new_rows, add_mask)
    return n_add


@torch.no_grad()
def perturb(model: GaussianModel, generator: torch.Generator,
            position_lr: float, noise_lr: float = 5e5,
            noise: Optional[torch.Tensor] = None):
    """mcmc.py:212-229: add R S S^T R^T times standard-normal noise (drawn
    from ``generator``, or ``noise`` [C, 3]), scaled by
    op_sigmoid(1 - opacity) * noise_lr * position_lr, to the live
    particles' positions."""
    cap = model.capacity
    dens = model.get_density()
    op_sig = 1.0 / (1.0 + torch.exp(-100.0 * ((1.0 - dens) - 0.995)))
    if noise is None:
        noise = torch.randn((cap, 3), generator=generator,
                            device=model.device)
    noise = noise * op_sig * noise_lr * np.float32(position_lr)
    rs = quat_to_rotmat(quat_normalize(model.rotation)) * \
        model.get_scale()[:, None, :]
    cov = torch.einsum("nij,nkj->nik", rs, rs)
    noise = torch.einsum("nij,nj->ni", cov, noise)
    noise = torch.where(model.active_mask()[:, None], noise,
                        torch.zeros_like(noise))
    model.positions.data += noise
