"""The repository's headline synthetic scene, built without JAX.

``bench_cloud`` makes the cloud of bench.py:130-152 from
``np.random.default_rng(seed)``: ``n`` Gaussians in the box x, y in
[-2.5, 2.5], z in [2, 9] in front of a camera at the origin, random
rotations, scales 0.01-0.05, logit densities N(0, 0.5), RGB albedo and
small degree-3 SH terms; capacity rounded up to a multiple of 256 with
the dead rows parked far away.
"""

from __future__ import annotations

import numpy as np

from .models.gaussians import GaussianModel, GaussianModelConfig
from .ops.sh import SH_C0


def bench_cloud(n: int = 100_000, seed: int = 0,
                device="cpu") -> GaussianModel:
    cap = ((n + 255) // 256) * 256
    rng = np.random.default_rng(seed)
    pos = np.zeros((cap, 3), np.float32)
    pos[:n, 0:2] = rng.uniform(-2.5, 2.5, (n, 2))
    pos[:n, 2] = rng.uniform(2.0, 9.0, n)
    pos[n:, 2] = 1e6
    quat = rng.normal(size=(cap, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    scales = np.log(rng.uniform(0.01, 0.05, (cap, 3)).astype(np.float32))
    dens = (rng.normal(size=(cap, 1)) * 0.5).astype(np.float32)
    rgb = rng.uniform(0, 1, (cap, 3)).astype(np.float32)
    albedo = ((rgb - 0.5) / np.float32(SH_C0)).astype(np.float32)
    spec = (rng.normal(size=(cap, 45)) * 0.02).astype(np.float32)
    arrays = dict(positions=pos, rotation=quat, scale=scales, density=dens,
                  features_albedo=albedo, features_specular=spec)
    return GaussianModel.from_numpy(arrays, n_active=n, n_active_features=3,
                                    config=GaussianModelConfig(),
                                    device=device)


def orbit_geometry(model: GaussianModel):
    """(center, distance) of an orbit around the live cloud, as
    scripts/eval_fps.py picks it: the mean, and 2.2 times the 95th
    percentile of the distances to it."""
    pos = model.positions.detach()[:model.n_active].cpu().numpy()
    center = pos.mean(axis=0)
    radius = float(np.percentile(np.linalg.norm(pos - center, axis=1), 95))
    return center, max(2.2 * radius, 1e-3)
