"""Per-group Adam and SelectiveAdam (port of
threedgrut_tpu/optimizers/adam.py).

SelectiveAdam (reference optimizers.cu:49-78) updates parameters AND
moments only for the rows visible in the current frame; ``update_mask``
keeps the capacity's dead rows out of every update. A masked elementwise
update, in plain PyTorch. Unlike the functional JAX version, ``adam_step``
updates the parameters and the moments in place (one copy of each instead
of two at every step).

The learning-rate schedules are those of threedgrut/utils/misc.py:91-126.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    step: int
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]


def init_adam_state(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        step=0,
        exp_avg={k: torch.zeros_like(v) for k, v in params.items()},
        exp_avg_sq={k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def adam_step(params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state: AdamState,
              lrs: Dict[str, float], *, betas=(0.9, 0.999), eps=1e-15,
              visibility: Optional[torch.Tensor] = None,
              update_mask: Optional[torch.Tensor] = None) -> AdamState:
    """One (Selective)Adam step over named parameter tensors, in place.

    Args:
        lrs: learning rate per parameter name.
        visibility: optional [C] bool; rows with False keep their params
            AND moments untouched (SelectiveAdam).
        update_mask: optional [C] bool; rows with False are never updated
            (the capacity's inactive rows).

    Returns the state with its step advanced (the moment tensors are the
    same objects, updated in place).
    """
    b1, b2 = betas
    step = state.step + 1
    # bias corrections in fp32, as the JAX package computes them
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    row_mask = visibility
    if update_mask is not None:
        row_mask = update_mask if row_mask is None else (row_mask
                                                         & update_mask)
    for name, p in params.items():
        g = grads[name]
        m, v = state.exp_avg[name], state.exp_avg_sq[name]
        m2 = b1 * m + (1.0 - b1) * g
        v2 = b2 * v + (1.0 - b2) * g * g
        p2 = p - lrs[name] * (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        if row_mask is not None and p.shape[0] == row_mask.shape[0]:
            mask = row_mask.reshape((-1,) + (1,) * (p.ndim - 1))
            p2 = torch.where(mask, p2, p)
            m2 = torch.where(mask, m2, m)
            v2 = torch.where(mask, v2, v)
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
    return AdamState(step=step, exp_avg=state.exp_avg,
                     exp_avg_sq=state.exp_avg_sq)


def exp_scheduler(lr_init: float, lr_final: float,
                  max_steps: int) -> Callable:
    def f(step):
        t = np.clip(step / max_steps, 0.0, 1.0)
        return float(np.exp(np.log(lr_init) * (1 - t)
                            + np.log(lr_final) * t))
    return f


def cosine_scheduler(lr_init: float, lr_final: float,
                     max_steps: int) -> Callable:
    def f(step):
        t = np.clip(step / max_steps, 0.0, 1.0)
        return float(lr_final + 0.5 * (lr_init - lr_final)
                     * (1 + np.cos(np.pi * t)))
    return f


def constant_scheduler(lr: float) -> Callable:
    return lambda step: float(lr)
