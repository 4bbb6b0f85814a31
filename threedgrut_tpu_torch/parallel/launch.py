"""Run a function on several ranks of one host over torch.distributed.

    results = run_ranks(fn, world_size, device="cuda")

``fn(rank, world_size, device, *args)`` runs in ``world_size`` processes
started by ``torch.multiprocessing`` (spawn), each in a process group
initialised from a ``file://`` store, so concurrent launches (test
workers) never compete for a TCP port. ``fn`` must be importable by the
child processes: the rank functions live in this package
(``dryrun.py``), never in a test module, whose conftest would import
JAX in every rank. Each rank's return value comes back to the caller,
in rank order.

The default is the card with NCCL, one rank per GPU. More ranks than
GPUs raise unless the caller asks for ``backend="gloo"``, which shares
the devices (rank r on ``cuda:(r % count)``); nothing switches on its
own. On the CPU every rank runs gloo with one intra-op thread. Before a
card launch the parent builds every kernel (``ops/cuda/build.py``), so
the ranks load the libraries rather than race nvcc into ``build/``.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, world_size: int, dev_type: str,
               backend: str, store_dir: str, args: Sequence):
    if dev_type == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store_dir, "store"),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=600))
    try:
        result = fn(rank, world_size, device, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(store_dir, f"result-{rank}.pt"))


def run_ranks(fn: Callable, world_size: int, device: str = "cuda",
              backend: Optional[str] = None,
              store_dir: Optional[str] = None, args: Sequence = (),
              timeout: float = 1800.0) -> List:
    """``fn(rank, world_size, device, *args)`` on ``world_size`` ranks;
    returns their results in rank order. Raises if a rank raises, or
    kills every rank past ``timeout`` seconds and raises."""
    dev_type = torch.device(device).type
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if dev_type == "cuda":
        n_gpu = torch.cuda.device_count()
        if n_gpu == 0:
            raise RuntimeError("no CUDA device: pass device=\"cpu\"")
        if world_size > n_gpu and backend != "gloo":
            raise ValueError(
                f"{world_size} ranks on {n_gpu} GPU(s): {backend} takes one "
                "rank a device (NCCL: 'Duplicate GPU detected'); pass "
                "backend=\"gloo\" to share the devices")
        from ..ops.cuda import build

        build.load_all(build.kernel_names())
    own = store_dir is None
    if own:
        store_dir = tempfile.mkdtemp(prefix="run_ranks_")
    else:
        os.makedirs(store_dir, exist_ok=True)
        for f in os.listdir(store_dir):
            if f == "store" or f.startswith("result-"):
                os.remove(os.path.join(store_dir, f))
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, dev_type, backend, store_dir,
                              tuple(args)),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"run_ranks: {world_size} ranks of "
                                   f"{fn.__name__} past {timeout} s")
        return [torch.load(os.path.join(store_dir, f"result-{r}.pt"),
                           weights_only=False) for r in range(world_size)]
    finally:
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)
