"""Kernel F wrapper: accumulate per-pair rows into a per-particle table.

Replaces threedgrut_tpu/ops/pallas/scatter.py:_scatter_kernel (through
``scatter_accumulate_rows``), the table gradient of JAX's
``rasterize_tiles_table``. The CUDA kernel is ``csrc/scatter_rows.cu``;
its header says what bounds it and why it is deterministic. The wrapper
sorts the pairs by id (``id_runs``: a stable ``torch.sort``, set-up as
the binning's sorts are) and finds each row's run; the kernel
(``scatter_runs``, which counts its launches) sums every run in pair
order. On CPU tensors the wrapper runs ``scatter_accumulate_rows_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# the widest record the kernel takes (JAX's FIELDS; NHT's 64-wide records
# keep kernel D)
MAX_WIDTH = 16


def scatter_accumulate_rows(d_rows: torch.Tensor, ids: torch.Tensor,
                            n_rows: int) -> torch.Tensor:
    """``out[ids[j]] += d_rows[j]`` for every pair j, in pair order.

    Args:
        d_rows: [P, R] f32 per-pair rows, R <= 16.
        ids: [P] i32 table row of each pair; ids outside [0, n_rows) are
            dropped (JAX requires them in range; pairs whose rows are zero
            may carry any valid id).
        n_rows: rows of the table.

    Returns [n_rows, R] f32; a row no pair names is 0. On the card every
    row's sum is the sequential fp32 sum in pair order, bit for bit.
    """
    p, width = d_rows.shape
    dev = d_rows.device
    build.check_tensor("d_rows", d_rows, torch.float32, (p, width), dev)
    build.check_tensor("ids", ids, torch.int32, (p,), dev)
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"record width {width}: kernel F takes 1 to "
                         f"{MAX_WIDTH} (NHT records fold with kernel D)")
    if dev.type == "cpu":
        return scatter_accumulate_rows_plain(d_rows, ids, n_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return scatter_runs(d_rows, *id_runs(ids, n_rows))


def id_runs(ids: torch.Tensor, n_rows: int):
    """Kernel F's set-up: (perm [P] i32, the pairs in a stable order by
    id; row_start [n_rows + 1] i32, where each row's run of them
    starts)."""
    sorted_ids, perm = torch.sort(ids, stable=True)
    row_start = torch.searchsorted(
        sorted_ids, torch.arange(n_rows + 1, dtype=torch.int32,
                                 device=ids.device), out_int32=True)
    return perm.to(torch.int32), row_start


def scatter_runs(d_rows: torch.Tensor, perm: torch.Tensor,
                 row_start: torch.Tensor) -> torch.Tensor:
    """Kernel F on the runs of ``id_runs``: [n_rows, R] f32, row r the sum
    of d_rows[perm[j]] over its run, in order."""
    p, width = d_rows.shape
    n_rows = row_start.shape[0] - 1
    dev = d_rows.device
    build.check_tensor("d_rows", d_rows, torch.float32, (p, width), dev)
    build.check_tensor("perm", perm, torch.int32, (p,), dev)
    build.check_tensor("row_start", row_start, torch.int32, (n_rows + 1,),
                       dev)
    if dev.type != "cuda" or not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"kernel F takes CUDA rows 1 to {MAX_WIDTH} wide, "
                         f"not {width} on {dev}")
    out = torch.empty((n_rows, width), dtype=torch.float32,
                      device=dev)    # the kernel writes every row
    lib = _lib()
    err = lib.scatter_rows_launch(
        d_rows.data_ptr(), perm.data_ptr(), row_start.data_ptr(), n_rows,
        width, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("scatter_rows", err, lib)
    scatter_runs.launches += 1
    return out


scatter_runs.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("scatter_rows")
    fn = lib.scatter_rows_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def scatter_accumulate_rows_plain(d_rows, ids, n_rows):
    """Plain PyTorch version of ``scatter_accumulate_rows``: ``index_add``
    in float64, rounded to float32."""
    idx = ids.to(torch.int64)
    keep = (idx >= 0) & (idx < n_rows)
    out = torch.zeros((n_rows, d_rows.shape[1]), dtype=torch.float64,
                      device=d_rows.device)
    out.index_add_(0, idx[keep], d_rows[keep].double())
    return out.to(torch.float32)
