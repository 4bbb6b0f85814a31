"""Kernel H wrappers: segmented forward fill.

Replaces threedgrut_tpu/ops/pallas/fill.py:_fill_kernel (through
``forward_fill`` and ``segmented_fill_rows``), as standalone ops: nothing
in the port calls them, as nothing in the JAX package does. The CUDA
kernel is ``csrc/fill.cu``; its header says how the carry crosses blocks
(each block reads the aggregates of the spans before it, never waiting
for another block) and what bounds it. On CPU tensors
the wrappers run ``forward_fill_plain`` and ``segmented_fill_rows_plain``,
which the kernel equals bit for bit.

The port's layout is row-major, [L, D] values and an [L] bool mask, where
JAX's ``forward_fill`` takes [n_slabs, D + 1, SLAB] slabs with the mask
in the last row. Where two rows of ``segmented_fill_rows`` name the same
slot, the port keeps the last one in input order; JAX's ``.at[].set``
leaves the winner unspecified. Negative slots raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# slots a span of csrc/fill.cu (its kSpan): the kernel's aggregates take
# one int a span
FILL_SPAN = 1024


def fill_spans(length: int) -> int:
    """The spans of a fill over ``length`` slots: the ints of its
    aggregates' workspace (the launch refuses fewer)."""
    return -(-length // FILL_SPAN)


def forward_fill(vals: torch.Tensor, marked: torch.Tensor) -> torch.Tensor:
    """Each slot takes ``vals`` of the last marked slot at or before it.

    Args:
        vals: [L, D] f32.
        marked: [L] bool.

    Returns [L, D] f32: zeros before the first mark.
    """
    length, d = vals.shape
    dev = vals.device
    build.check_tensor("vals", vals, torch.float32, (length, d), dev)
    build.check_tensor("marked", marked, torch.bool, (length,), dev)
    if dev.type == "cpu":
        return forward_fill_plain(vals, marked)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((length, d), dtype=torch.float32, device=dev)
    agg = torch.empty(fill_spans(length), dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.fill_launch(vals.data_ptr(), marked.data_ptr(), length, d,
                          agg.data_ptr(), agg.numel(), out.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("fill", err, lib)
    forward_fill.launches += 1
    return out


def segmented_fill_rows(row_vals: torch.Tensor, row_slots: torch.Tensor,
                        length: int) -> torch.Tensor:
    """Put each row at its slot, then forward-fill: [length, D] per-slot
    values (fill.py:segmented_fill_rows).

    Args:
        row_vals: [N, D] f32.
        row_slots: [N] i32, >= 0; slots >= length drop their row (JAX
            drops slots past its padded buffer and cuts the rest off with
            the padding). Of rows sharing a slot, the last in input order
            wins.
        length: output slots.

    Raises ValueError for a negative slot: JAX wraps it modulo its
    buffer padded to 8192-slot slabs, a TPU layout the port does not
    keep. On a card the kernel drops such rows and reports the least
    negative slot, which the wrapper reads back (one int) after the
    launch.
    """
    n, d = row_vals.shape
    dev = row_vals.device
    build.check_tensor("row_vals", row_vals, torch.float32, (n, d), dev)
    build.check_tensor("row_slots", row_slots, torch.int32, (n,), dev)
    if dev.type == "cpu":
        _refuse_negative(int(row_slots.min()) if n else 0)
        return segmented_fill_rows_plain(row_vals, row_slots, length)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((length, d), dtype=torch.float32, device=dev)
    # each slot's row, the aggregates, the negative-slot check
    ws = torch.empty(length + fill_spans(length) + 1, dtype=torch.int32,
                     device=dev)
    lib = _lib()
    err = lib.fill_rows_launch(
        row_vals.data_ptr(), row_slots.data_ptr(), n, length, d,
        ws.data_ptr(), ws.numel(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("fill", err, lib)
    forward_fill.launches += 1
    _refuse_negative(-1 - int(ws[-1]))
    return out


def _refuse_negative(least):
    if least < 0:
        raise ValueError(f"row_slots holds negative slot {least}: slots "
                         f"must be >= 0")


# kernel H launches, by either wrapper
forward_fill.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("fill")
    if lib.fill_launch.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.fill_launch.argtypes = [p, p, i, i, p, i, p, p]
        lib.fill_launch.restype = i
        lib.fill_rows_launch.argtypes = [p, p, i, i, i, p, i64, p, p]
        lib.fill_rows_launch.restype = i
    return lib


def _fill_from(pos, source_rows):
    """[L, D]: row ``source_rows`` of the last position >= 0 of ``pos``
    [L] at or before each slot (``pos[l]`` is l or -1), 0 before any."""
    last = torch.cummax(pos, dim=0).values
    out = source_rows(last.clamp(min=0))
    return torch.where((last >= 0)[:, None], out, torch.zeros_like(out))


def forward_fill_plain(vals, marked):
    """Plain PyTorch version of ``forward_fill``: an inclusive ``cummax``
    of the marked positions, then a gather."""
    if vals.shape[0] == 0:
        return vals.clone()
    slot = torch.arange(vals.shape[0], device=vals.device)
    pos = torch.where(marked, slot, torch.full_like(slot, -1))
    return _fill_from(pos, lambda i: vals[i])


def segmented_fill_rows_plain(row_vals, row_slots, length):
    """Plain PyTorch version of ``segmented_fill_rows``: each slot's row
    (the largest row index naming it, by ``scatter_reduce``), then
    ``forward_fill``'s cummax and gather."""
    dev = row_vals.device
    if length == 0 or row_vals.shape[0] == 0:
        return row_vals.new_zeros((length, row_vals.shape[1]))
    slots = row_slots.to(torch.int64)
    keep = (slots >= 0) & (slots < length)
    rows = torch.arange(row_vals.shape[0], device=dev)
    sel = torch.full((length,), -1, dtype=torch.int64, device=dev)
    sel.scatter_reduce_(0, slots[keep], rows[keep], "amax")
    slot = torch.arange(length, device=dev)
    pos = torch.where(sel >= 0, slot, torch.full_like(slot, -1))
    return _fill_from(pos, lambda i: row_vals[sel[i].clamp(min=0)])
