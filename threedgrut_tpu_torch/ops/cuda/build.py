"""Build the port's CUDA kernels with nvcc at first use, load them with
ctypes, and check what goes into and comes out of a launch.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/threedgrut_tpu_torch/lib<name>-<hash>.so`` at the repository
root (``build/`` is git-ignored). The hash covers the kernel's source,
the shared headers and the flags, so an edited source builds anew and an
unchanged one loads from disk. The library never includes PyTorch's
headers: a build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "threedgrut_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel -> extra nvcc flags. No FMA contraction: bin_decode emits
# integers that its plain PyTorch version must reproduce exactly, and
# raster_fwd's accept decisions (sq < threshold) then match the plain
# version's too, instead of flipping one ~1/255 contribution on tens of
# pixels per view. raster_bwd shares raster_fwd's hit math
# (common.cuh:eval_hit) and must take the same decisions, as must wmax;
# fold only adds. The kernels not named here (scatter_rows, expand_rows,
# fill) only add, copy or count and take no extra flags.
EXTRA_FLAGS: Dict[str, List[str]] = {
    "bin_decode": ["-fmad=false"],
    "raster_fwd": ["-fmad=false"],
    "raster_bwd": ["-fmad=false"],
    "fold": ["-fmad=false"],
    "wmax": ["-fmad=false"],
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc by this process, per kernel (0.0 when loaded
# from an earlier build)
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME")
    return str(path)


def _flags(name: str) -> List[str]:
    return ARCH + BASE_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str, verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    return load_all([name], verbose)[name]


def load_all(names: List[str], verbose: bool = False
             ) -> Dict[str, ctypes.CDLL]:
    """Load the kernel libraries ``names``; those not built yet are built
    by one nvcc process each, all started together."""
    todo = {}
    for name in names:
        if name in _LIBS:
            continue
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path()] + _flags(name) + (
                ["-Xptxas", "-v"] if verbose else []) + [
                "-o", str(tmp), str(CSRC / f"{name}.cu")]
            todo[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in todo.items():
        _, err = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{err}")
            continue
        if verbose:
            print(err, end="")
        os.replace(tmp, out)   # atomic: concurrent builders never see half
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBS:
            BUILD_SECONDS.setdefault(name, 0.0)
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return {name: _LIBS[name] for name in names}


def attributes(name: str, kernels) -> Dict[str, Dict[str, int]]:
    """{kernel: {registers, local_bytes, shared_bytes, dynamic_shared_bytes}}
    of the kernels of library ``name``, in the order its
    ``<name>_attributes`` C function lists them (cudaFuncGetAttributes:
    registers a thread, local memory a thread for spills and stack, static
    shared memory a block; and the dynamic shared memory a launch asks
    for)."""
    lib = load(name)
    out = (ctypes.c_int * (4 * len(kernels)))()
    fn = getattr(lib, f"{name}_attributes")
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check_launch(f"{name}_attributes", fn(ctypes.addressof(out)), lib)
    return {k: dict(registers=out[4 * i], local_bytes=out[4 * i + 1],
                    shared_bytes=out[4 * i + 2],
                    dynamic_shared_bytes=out[4 * i + 3])
            for i, k in enumerate(kernels)}


def check_launch(name: str, err: int, lib: Optional[ctypes.CDLL] = None):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = ""
        if lib is not None:
            lib.cuda_error_string.restype = ctypes.c_char_p
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cuda error {err} {msg}")


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
