"""Classic 3DGS densification on the capacity layout (port of
threedgrut_tpu/strategy/gs.py; reference threedgrut/strategy/gs.py).

- gradient buffer: accumulate ||dL/dpos * dist_to_camera|| / 2 for the
  particles with non-zero position gradients (gs.py:130-141),
- clone: grad norm >= clone threshold and max scale <= rel_size *
  scene_extent -> duplicate,
- split: grad norm >= split threshold and max scale > rel_size *
  scene_extent -> ``n_split`` samples from the particle's covariance,
  scales shrunk by 1 / (0.8 n_split),
- prune by density or by screen footprint, density decay, density reset
  with the density moments zeroed.

- prune by blend weight: particles whose running max of alpha * T over
  the sampled views (``render_gut(weight_telemetry=True)``, kernel E)
  stayed below the threshold.

Row counts change through ``strategy/base.py``; everything updates the
model and the Adam state in place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models.gaussians import (ACTIVATIONS, INVERSE_ACTIVATIONS,
                                GaussianModel)
from ..ops.quaternion import quat_normalize, quat_to_rotmat
from ..optimizers.adam import AdamState
from . import base


@dataclasses.dataclass(frozen=True)
class GSStrategyConfig:
    """configs/strategy/gs.yaml."""
    densify_frequency: int = 300
    densify_start: int = 500
    densify_end: int = 15000
    clone_grad_threshold: float = 0.0002
    split_grad_threshold: float = 0.0002
    relative_size_threshold: float = 0.01
    split_n_gaussians: int = 2
    prune_frequency: int = 100
    prune_start: int = 500
    prune_end: int = 15000
    prune_density_threshold: float = 0.005
    reset_density_frequency: int = 3000
    reset_density_start: int = 0
    reset_density_end: int = 15000
    new_max_density: float = 0.01
    density_decay_frequency: int = 0
    density_decay_start: int = -1
    density_decay_end: int = -1
    density_decay_gamma: float = 0.99
    prune_scale_frequency: int = 0
    prune_scale_start: int = -1
    prune_scale_end: int = -1
    prune_scale_threshold: float = 1.0
    prune_weight_frequency: int = 0
    prune_weight_start: int = -1
    prune_weight_end: int = -1
    prune_weight_threshold: float = 0.01
    weight_telemetry_frequency: int = 10

    def replace(self, **kw) -> "GSStrategyConfig":
        return dataclasses.replace(self, **kw)


class GSBuffers(NamedTuple):
    grad_norm_accum: torch.Tensor  # [C] f32
    grad_norm_denom: torch.Tensor  # [C] i32


def init_buffers(capacity: int, device="cpu") -> GSBuffers:
    return GSBuffers(torch.zeros(capacity, dtype=torch.float32,
                                 device=device),
                     torch.zeros(capacity, dtype=torch.int32, device=device))


@torch.no_grad()
def update_gradient_buffer(buffers: GSBuffers, pos_grad: torch.Tensor,
                           positions: torch.Tensor,
                           sensor_position: torch.Tensor) -> GSBuffers:
    """gs.py:130-141: accumulate camera-distance-scaled position-grad
    norms of the particles the step touched."""
    touched = torch.any(pos_grad != 0.0, dim=1)
    dist = torch.linalg.norm(positions - sensor_position, dim=1)
    norm = torch.linalg.norm(pos_grad * dist[:, None], dim=1) / 2.0
    return GSBuffers(
        buffers.grad_norm_accum + torch.where(touched, norm,
                                              torch.zeros_like(norm)),
        buffers.grad_norm_denom + touched.to(torch.int32))


def _permute_buffers(buffers: GSBuffers, order: torch.Tensor) -> GSBuffers:
    return GSBuffers(buffers.grad_norm_accum[order],
                     buffers.grad_norm_denom[order])


@torch.no_grad()
def densify(model: GaussianModel, opt: AdamState, buffers: GSBuffers,
            scene_extent: float, *, clone_grad_threshold: float = 0.0002,
            split_grad_threshold: float = 0.0002,
            relative_size_threshold: float = 0.01, n_split: int = 2,
            noise: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None):
    """Clone + split in one pass (gs.py:142-233).

    ``noise`` [n_split, C, 3] are the standard normals of the split
    samples; drawn from ``generator`` when absent.
    Returns (buffers, stats dict of ints).
    """
    cap = model.capacity
    dev = model.device
    active = model.active_mask()
    denom = buffers.grad_norm_denom
    grad_norm = buffers.grad_norm_accum / torch.clamp(denom.to(torch.float32),
                                                      min=1.0)
    grad_norm = torch.where(denom > 0, grad_norm, torch.zeros_like(grad_norm))

    scale = model.get_scale()
    big = torch.amax(scale, dim=1) > relative_size_threshold * scene_extent
    clone_mask = active & (grad_norm >= clone_grad_threshold) & ~big
    split_mask = active & (grad_norm >= split_grad_threshold) & big

    # clone: plain duplicates appended at the end
    dropped = base.append_rows(model, opt, {}, clone_mask)

    # split: the original row becomes sample 0, the others are appended
    rot = quat_to_rotmat(quat_normalize(model.rotation))
    new_scale_raw = INVERSE_ACTIVATIONS[model.config.scale_activation](
        torch.clamp(scale / (0.8 * n_split), min=1e-30))
    if noise is None:
        noise = torch.randn((n_split, cap, 3), generator=generator,
                            device=generator.device if generator else dev
                            ).to(dev)
    offsets = [torch.einsum("nij,nj->ni", rot, noise[s] * scale)
               for s in range(n_split)]
    m = split_mask[:, None]
    model.set_params(
        positions=torch.where(m, model.positions + offsets[0],
                              model.positions),
        scale=torch.where(m, new_scale_raw, model.scale))
    # the reference rebuilds split particles: their moments start at zero
    base.reset_moments_rows(opt, split_mask)
    for s in range(1, n_split):
        new_rows = {"positions": model.positions - offsets[0] + offsets[s],
                    "scale": new_scale_raw}
        dropped += base.append_rows(model, opt, new_rows, split_mask)

    stats = {"n_cloned": int(clone_mask.sum()),
             "n_split": int(split_mask.sum()), "n_dropped": dropped}
    return init_buffers(cap, dev), stats


@torch.no_grad()
def _prune(model: GaussianModel, opt: AdamState, buffers: GSBuffers,
           keep: torch.Tensor):
    n_pruned = model.n_active - int(keep.sum())
    order = base.compact(model, opt, keep)
    return _permute_buffers(buffers, order), n_pruned


@torch.no_grad()
def prune_opacity(model: GaussianModel, opt: AdamState, buffers: GSBuffers,
                  threshold: float = 0.005):
    """gs.py:269: drop particles with post-activation density below
    ``threshold``. Returns (buffers, n_pruned)."""
    keep = model.active_mask() & (model.get_density()[:, 0] >= threshold)
    return _prune(model, opt, buffers, keep)


@torch.no_grad()
def prune_scale(model: GaussianModel, opt: AdamState, buffers: GSBuffers,
                cam_normals: torch.Tensor, focal_max: float,
                threshold: float = 1.0):
    """gs.py:252: drop particles whose minimum scale over the camera
    distance, times the focal length, reaches ``threshold``."""
    sims = model.positions @ cam_normals.T
    cam_dists = torch.clamp(torch.amin(sims, dim=1), min=1e-8)
    ratio = torch.amin(model.get_scale(), dim=1) / cam_dists * focal_max
    keep = model.active_mask() & (ratio < threshold)
    return _prune(model, opt, buffers, keep)


@torch.no_grad()
def prune_weight(model: GaussianModel, opt: AdamState, buffers: GSBuffers,
                 max_weights: torch.Tensor, threshold: float = 0.01):
    """gs.py:179-191: drop particles whose max blend weight over the
    sampled views stayed below ``threshold`` (``max_weights`` [C], the
    trainer's running max of ``particle_wmax``). Returns (buffers,
    n_pruned)."""
    keep = model.active_mask() & (max_weights >= threshold)
    return _prune(model, opt, buffers, keep)


@torch.no_grad()
def reset_density(model: GaussianModel, opt: AdamState,
                  new_max_density: float = 0.01):
    """gs.py:315: clamp the raw density at inv_act(new_max_density) and
    zero every density moment."""
    inv = INVERSE_ACTIVATIONS[model.config.density_activation](
        torch.tensor(new_max_density, dtype=torch.float32))
    model.set_params(density=torch.clamp(model.density, max=float(inv)))
    opt.exp_avg["density"].zero_()
    opt.exp_avg_sq["density"].zero_()


@torch.no_grad()
def decay_density(model: GaussianModel, gamma: float = 0.99):
    """gs.py:311: densities <- inv_act(act(density) * gamma)."""
    act = ACTIVATIONS[model.config.density_activation]
    inv = INVERSE_ACTIVATIONS[model.config.density_activation]
    model.set_params(density=inv(torch.clamp(act(model.density) * gamma,
                                             1e-10, 1.0 - 1e-7)))
