#!/usr/bin/env python3
"""Regenerate the cross-implementation parity cloud with the PyTorch/CUDA
port (the port's counterpart of scripts/gen_parity_fixture.py).

Writes ``make_cloud(n=512, seed=11)`` through the port's PLY writer
(``threedgrut_tpu_torch/export/ply.py``, byte for byte the JAX package's)
to the path given: the reference-format 3DGS PLY (x/y/z, f_dc_*,
channel-major f_rest_*, opacity, scale_*, rot_*) committed as
tests/fixtures/parity_cloud.ply, which every in-repo path imports and
renders. Numpy only: nothing is rendered.

    python scripts/gen_parity_fixture_torch.py tests/fixtures/parity_cloud.ply
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_cloud(n=512, seed=11):
    """Raw parameters (positions, rotation, scale, density, albedo,
    degree-3 SH rest) of ``n`` Gaussians in x, y in [-1.8, 1.8], z in
    [2, 7], from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0:2] = rng.uniform(-1.8, 1.8, (n, 2))
    pos[:, 2] = rng.uniform(2.0, 7.0, n)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    scale = np.log(rng.uniform(0.03, 0.12, (n, 3)).astype(np.float32))
    density = rng.normal(size=(n, 1)).astype(np.float32) * 0.8
    albedo = rng.uniform(-1.0, 1.5, (n, 3)).astype(np.float32)
    spec = (rng.normal(size=(n, 45)) * 0.15).astype(np.float32)
    return pos, quat, scale, density, albedo, spec


def main(argv=None):
    from threedgrut_tpu_torch.export.ply import export_ply

    ap = argparse.ArgumentParser()
    ap.add_argument("out", help="the PLY to write")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    export_ply(args.out, *make_cloud())
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
