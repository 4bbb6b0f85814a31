"""Kernel F wrapper: accumulate per-pair rows into a per-particle table.

Replaces threedgrut_tpu/ops/pallas/scatter.py:_scatter_kernel (through
``scatter_accumulate_rows``), the table gradient of JAX's
``rasterize_tiles_table``. The CUDA kernel is ``csrc/scatter_rows.cu``;
its header says what bounds it and why it is deterministic. The wrapper
groups the pairs by id (``id_runs``: the set-up kernels of the same
library, a counting sort that leaves each row's run in any order; it
counts its launches) and the kernel (``scatter_runs``, which counts its
launches) puts every run in pair order and sums it. ``id_runs_plain`` is
the set-up's plain version (a stable ``torch.sort`` and a
``searchsorted``), ``scatter_runs_plain`` the kernel's (each run sorted,
then summed in order). On CPU tensors the wrapper runs
``scatter_accumulate_rows_plain``.
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
    """Kernel F's set-up: (perm [P] i32, the pairs grouped by id; row_start
    [n_rows + 1] i32, where each row's run of them starts). Ids outside
    [0, n_rows) are left out. On the card the runs hold their pairs in
    any order (the placement's atomics decide it; ``scatter_runs`` orders
    them); on the CPU this is ``id_runs_plain``, in pair order."""
    p = ids.shape[0]
    dev = ids.device
    build.check_tensor("ids", ids, torch.int32, (p,), dev)
    if dev.type == "cpu":
        return id_runs_plain(ids, n_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    count = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    rank = torch.empty(p, dtype=torch.int32, device=dev)
    perm = torch.empty(p, dtype=torch.int32, device=dev)  # placed runs only
    row_start = torch.empty(n_rows + 1, dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.id_runs_launch(
        ids.data_ptr(), p, n_rows, count.data_ptr(), rank.data_ptr(),
        perm.data_ptr(), row_start.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("id_runs", err, lib)
    id_runs.launches += 1
    return perm, row_start


id_runs.launches = 0


def id_runs_plain(ids: torch.Tensor, n_rows: int):
    """Plain PyTorch version of ``id_runs``: a stable sort by id, so each
    run holds its pairs in pair order, and the runs' starts by
    ``searchsorted``."""
    sorted_ids, perm = torch.sort(ids, stable=True)
    row_start = torch.searchsorted(
        sorted_ids, torch.arange(n_rows + 1, dtype=torch.int32,
                                 device=ids.device), out_int32=True)
    return perm.to(torch.int32), row_start


def scatter_runs(d_rows: torch.Tensor, perm: torch.Tensor,
                 row_start: torch.Tensor) -> torch.Tensor:
    """Kernel F on the runs of ``id_runs``: [n_rows, R] f32, row r the sum
    of d_rows[j] over the pairs j of its run, in ascending j. The kernel
    sorts each run of ``perm`` in place."""
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
        lib.id_runs_launch.argtypes = [p, ctypes.c_int64, i, p, p, p, p, p]
        lib.id_runs_launch.restype = ctypes.c_int
    return lib


def kernel_attributes():
    """{id_count, id_scan, id_place, scatter_rows: build.attributes} of
    the set-up's and F's kernels."""
    return build.attributes("scatter_rows", ("id_count", "id_scan",
                                             "id_place", "scatter_rows"))


def scatter_runs_plain(d_rows, perm, row_start):
    """Plain PyTorch version of ``scatter_runs``: each run put in
    ascending pair order, then summed one fp32 add at a time in that
    order (row r's t-th pair added at step t)."""
    n_rows = row_start.shape[0] - 1
    start = row_start.to(torch.int64) - int(row_start[0])
    lengths = start[1:] - start[:-1]
    row_of = torch.repeat_interleave(
        torch.arange(n_rows, device=perm.device), lengths)
    placed = perm[int(row_start[0]):int(row_start[-1])].to(torch.int64)
    placed = placed[torch.argsort(row_of * max(perm.shape[0], 1) + placed)]
    out = torch.zeros((n_rows, d_rows.shape[1]), dtype=torch.float32,
                      device=d_rows.device)
    for t in range(int(lengths.max()) if n_rows else 0):
        rows = torch.nonzero(lengths > t)[:, 0]
        out[rows] += d_rows[placed[start[rows] + t]]
    return out


def scatter_accumulate_rows_plain(d_rows, ids, n_rows):
    """Plain PyTorch version of ``scatter_accumulate_rows``: ``index_add``
    in float64, rounded to float32."""
    idx = ids.to(torch.int64)
    keep = (idx >= 0) & (idx < n_rows)
    out = torch.zeros((n_rows, d_rows.shape[1]), dtype=torch.float64,
                      device=d_rows.device)
    out.index_add_(0, idx[keep], d_rows[keep].double())
    return out.to(torch.float32)
