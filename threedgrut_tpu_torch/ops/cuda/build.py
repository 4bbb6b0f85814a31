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
# pixels per view.
EXTRA_FLAGS: Dict[str, List[str]] = {
    "bin_decode": ["-fmad=false"],
    "raster_fwd": ["-fmad=false"],
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
    return ARCH + BASE_FLAGS + EXTRA_FLAGS[name]


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str, verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    BUILD_SECONDS[name] = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path()] + _flags(name) + (
            ["-Xptxas", "-v"] if verbose else []) + [
            "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
        if verbose:
            print(res.stderr, end="")
        os.replace(tmp, out)   # atomic: concurrent builders never see half
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib


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
    ``device`` that does not require grad (no kernel has a backward yet)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.requires_grad:
        raise RuntimeError(
            f"{name} requires grad: the kernels have no backward yet; "
            "render under torch.no_grad()")
