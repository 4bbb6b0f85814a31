"""The collectives that ``shard_map`` gave the JAX package
(``jax.lax.psum``, ``pmean``, ``all_gather``, ``ppermute``,
``axis_index``, ``axis_size``; threedgrut_tpu/parallel/{dp,particle}.py),
on torch.distributed process groups.

Every collective is built from ``dist.all_reduce`` and
``dist.all_gather`` alone (and ``broadcast_`` on ``dist.broadcast``),
which both NCCL and gloo take on CUDA tensors; send/recv,
reduce_scatter and all_to_all are not used. Each
differentiable one is a ``torch.autograd.Function`` whose backward is
written out. The convention is JAX's: the objective is the sum over the
ranks of each rank's own loss, so
  * psum's backward is the psum of the cotangents,
  * all_gather's backward all-reduces the gathered cotangents and keeps
    the rank's own slot (JAX's transpose, psum_scatter): where every
    rank computes the same loss from the gathered value, each rank's
    input gets D times its cotangent, which the caller divides out
    (``particle.py``'s pmean of the gradients, as JAX's),
  * ppermute's backward sends each cotangent back to the rank that sent
    the value (an all_gather, whose backward does exactly that).

``group`` is a process group (None: the default group). Without an
initialised process group the functions act on a group of one: the
collectives are the identity, ``axis_index`` is 0 and ``axis_size`` 1,
so a step built on them runs unchanged in a single process.

gloo on CUDA tensors: on the H100, gloo took all_reduce, all_gather and
broadcast on CUDA tensors directly (``chip_smoke.py`` phase 50 probes and
prints it), so nothing here branches on the backend or stages through
the host; NCCL refuses two ranks on one device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def axis_index(group=None) -> int:
    """This process's rank in ``group`` (jax.lax.axis_index)."""
    return dist.get_rank(group) if initialized() else 0


def axis_size(group=None) -> int:
    """The ranks in ``group`` (jax.lax.axis_size)."""
    return dist.get_world_size(group) if initialized() else 1


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of ``x`` in a new tensor."""
    y = x.detach().contiguous().clone()
    if axis_size(group) > 1:
        dist.all_reduce(y, group=group)
    return y


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[D, *x.shape]: every rank's ``x`` in rank order."""
    n = axis_size(group)
    x = x.detach().contiguous()
    if n == 1:
        return x[None].clone()
    out = x.new_empty((n,) + tuple(x.shape))
    dist.all_gather(list(out.unbind(0)), x, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group)[axis_index(ctx.group)], None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group (jax.lax.psum)."""
    return _PSum.apply(x, group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the group (jax.lax.pmean)."""
    return psum(x, group) / axis_size(group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """[D, *x.shape], every rank's ``x`` stacked in rank order
    (jax.lax.all_gather, axis 0, untiled)."""
    return _AllGather.apply(x, group)


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group=None) -> torch.Tensor:
    """The ``x`` of the rank that sends to this one under ``perm``
    [(source, destination), ...], zeros where none does
    (jax.lax.ppermute). Built on all_gather: its backward returns each
    cotangent to the sender."""
    me = axis_index(group)
    src = [s for s, d in perm if d == me]
    gathered = all_gather(x, group)
    if src:
        return gathered[src[0]]
    # zeros that keep the graph: every rank's backward must reach the
    # all_gather's collective, or the senders wait for this rank
    return torch.cat([gathered, torch.zeros_like(gathered[:1])])[-1]


def halo_rows(x: torch.Tensor, r: int, group=None) -> torch.Tensor:
    """[r + B + r, ...]: ``x`` [B, ...] (this rank's row band) between the
    previous rank's bottom ``r`` rows and the next rank's top ``r`` rows,
    wrapping around the ring as JAX's ppermute pair does
    (parallel/dp.py:72-82; the wrapped rows feed only windows the
    caller's validity mask drops). One all_gather of every rank's 2 r
    edge rows; its backward all-reduces the gathered rows' cotangents,
    so each rank adds what its neighbours' windows sent back into its
    own edge rows' gradient (the transpose of JAX's ppermute)."""
    n, d = axis_size(group), axis_index(group)
    edges = all_gather(torch.cat([x[:r], x[-r:]], dim=0), group)
    top = edges[(d - 1) % n, r:]          # the previous band's bottom rows
    bottom = edges[(d + 1) % n, :r]       # the next band's top rows
    return torch.cat([top, x, bottom], dim=0)


@torch.no_grad()
def psum_tensors(tensors: List[torch.Tensor], group=None
                 ) -> List[torch.Tensor]:
    """The psum of each tensor, by one all_reduce of their concatenation
    (the gradients of a step: one collective, not one a leaf)."""
    if axis_size(group) == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


@torch.no_grad()
def broadcast_(tensors: List[torch.Tensor], src: int = 0, group=None):
    """Overwrite every rank's ``tensors`` with rank ``src``'s (``src`` a
    rank of ``group``), in place."""
    if axis_size(group) == 1:
        return
    root = src if group is None else dist.get_global_rank(group, src)
    for t in tensors:
        dist.broadcast(t, root, group=group)
