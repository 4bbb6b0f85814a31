"""Strategy base: capacity-layout row surgery (port of
threedgrut_tpu/strategy/base.py).

Parameters live in capacity-sized rows with an ``n_active`` count. An
"append" writes new rows at [n_active, n_active + k) (drops what does not
fit, and reports it); a "prune" compacts the kept rows to the front with a
stable permutation. The Adam moments move with their rows and are zeroed
for new ones (reference strategy/base.py:77). The port updates the
model's parameters and the moments in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.gaussians import GaussianModel
from ..optimizers.adam import AdamState
from ..utils.timer import host_read


def _rows_of(model: GaussianModel, opt: AdamState):
    """Every capacity-row tensor: parameters, then the two moments."""
    cap = model.capacity
    for name, p in model.params().items():
        for t in (p.data, opt.exp_avg.get(name), opt.exp_avg_sq.get(name)):
            if t is not None and t.ndim >= 1 and t.shape[0] == cap:
                yield t


def _keep_order(keep: torch.Tensor) -> torch.Tensor:
    """Stable permutation: kept rows first (by index), dropped after."""
    return torch.argsort((~keep).to(torch.int32), stable=True)


@torch.no_grad()
def compact(model: GaussianModel, opt: AdamState, keep: torch.Tensor
            ) -> torch.Tensor:
    """Move kept rows to the front (stable), set ``n_active``. ``keep`` is
    [C] bool; rows >= n_active must be False. Returns the permutation."""
    order = _keep_order(keep)
    for t in _rows_of(model, opt):
        t.copy_(t[order])
    model.n_active = int(keep.sum())
    return order


def mask_rows(mask: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of ``mask``'s ``n`` True entries, in order, without
    reading the mask on the host."""
    return torch.nonzero_static(mask, size=n).flatten()


@torch.no_grad()
def append_rows(model: GaussianModel, opt: AdamState, new_rows: dict,
                add_mask: torch.Tensor, n_add: Optional[int] = None) -> int:
    """Append row i of ``new_rows[name]`` (default: the model's own row i)
    for every i with ``add_mask[i]``, at the end of the live region; the
    moments of appended rows are zeroed. ``n_add``: the mask's count,
    where the caller knows it (else one host read). Returns the rows
    dropped because the capacity is full."""
    cap = model.capacity
    n = model.n_active
    if n_add is None:
        n_add = int(host_read("strategy.append", add_mask.sum()))
    n_fit = min(n_add, cap - n)
    src = mask_rows(add_mask, n_add)[:n_fit]
    dest = torch.arange(n, n + n_fit, device=add_mask.device)
    for name, p in model.params().items():
        p.data[dest] = new_rows.get(name, p.data)[src]
        for mom in (opt.exp_avg, opt.exp_avg_sq):
            if name in mom:
                mom[name].index_fill_(0, dest, 0.0)
    model.n_active = n + n_fit
    return n_add - n_fit


@torch.no_grad()
def reset_moments_rows(opt: AdamState, mask: torch.Tensor):
    """Zero the optimizer moments of the masked rows."""
    for mom in (opt.exp_avg, opt.exp_avg_sq):
        for t in mom.values():
            if t.ndim >= 1 and t.shape[0] == mask.shape[0]:
                t[mask] = 0.0


def check_step_condition(step: int, start: int, end: int,
                         frequency: int) -> bool:
    """threedgrut/utils/misc.py:212: fire when step > start (start >= 0),
    step < end (or end == -1) and step % frequency == 0."""
    if frequency <= 0:
        return False
    return ((start >= 0 and step > start)
            and (step < end or end == -1)
            and step % frequency == 0)
