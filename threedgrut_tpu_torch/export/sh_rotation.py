"""Rotate SH coefficient sets under a world rotation (port of
threedgrut_tpu/export/sh_rotation.py on the port's ``ops/sh.py:sh_basis``).

Reference: threedgrut/export/sh_rotation.py (150 LoC) - needed when
exporting with a normalizing world transform so radiance stays
view-consistent. Implemented via the Wigner-D construction: band-l
rotation matrices are built numerically by evaluating the band's basis on
a fixed set of sample directions (exact for each band since the SH basis
restricted to a band is closed under rotation).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.sh import sh_basis


@functools.lru_cache(maxsize=None)
def _band_sample_dirs(l: int):
    """2l+1 generic unit directions (deterministic) for solving band l."""
    rng = np.random.default_rng(12345 + l)
    d = rng.normal(size=(2 * l + 1, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _band_basis(dirs: np.ndarray, l: int) -> np.ndarray:
    """Evaluate only band l of the SH basis: [M, 2l+1], in float32 as
    the JAX package evaluates it."""
    full = sh_basis(torch.from_numpy(np.asarray(dirs, np.float32)),
                    l).numpy()
    return full[:, l * l:(l + 1) * (l + 1)]


def band_rotation_matrix(rot: np.ndarray, l: int) -> np.ndarray:
    """[2l+1, 2l+1] matrix D with sh_l(R d) = D @ sh_l(d).

    Solved from samples: B_rot = B @ D^T with B the band basis at sample
    dirs and B_rot the basis at rotated dirs.
    """
    if l == 0:
        return np.ones((1, 1))
    dirs = _band_sample_dirs(l)
    b = _band_basis(dirs, l)                 # [M, 2l+1]
    b_rot = _band_basis(dirs @ rot.T, l)     # sh(R d)
    # sh(R d) = D sh(d) -> B_rot^T = D B^T -> solve B^T X = B_rot^T... use lstsq
    d, *_ = np.linalg.lstsq(b, b_rot, rcond=None)
    return d.T


def rotate_sh_coefficients(coeffs: np.ndarray, rot: np.ndarray,
                           degree: int) -> np.ndarray:
    """Rotate [N, K, C] SH coefficient sets by world rotation ``rot``.

    After rotation, radiance(d) of the transformed particle equals the
    original radiance(R^T d) - i.e. the appearance rotates rigidly with
    the geometry.
    """
    out = coeffs.copy()
    for l in range(degree + 1):
        lo, hi = l * l, (l + 1) ** 2
        if hi > coeffs.shape[1]:
            break
        dmat = band_rotation_matrix(rot, l)
        # new coeffs c' with sum c'_m Y_m(d) = sum c_m Y_m(R^T d)
        # Y(R^T d) = D(R^T) Y(d) -> c' = D(R^T)^T c = D(R)^{-T}... use D(R^T)
        d_inv = band_rotation_matrix(rot.T, l)
        out[:, lo:hi] = np.einsum("mk,nkc->nmc", d_inv.T, coeffs[:, lo:hi])
    return out
