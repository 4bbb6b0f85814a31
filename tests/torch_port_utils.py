"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
move JAX scenes, cameras and outputs into the PyTorch port."""

import numpy as np
import torch

from threedgrut_tpu_torch.convert import model_from_state
from threedgrut_tpu_torch.ops.cameras import CameraModel

CAMERA_TENSORS = ("focal", "principal", "radial", "tangential", "thin_prism",
                  "max_angle", "ftheta_angle_to_pixeldist",
                  "ftheta_pixeldist_to_angle", "ftheta_linear_cde",
                  "t_start", "q_start", "t_end", "q_end")


def torch_camera(cam, device="cpu"):
    """A JAX CameraModel (any model and shutter) as the port's camera,
    field for field."""
    return CameraModel(
        resolution=tuple(cam.resolution), model_type=int(cam.model_type),
        shutter_type=int(cam.shutter_type),
        ftheta_reference_poly=int(cam.ftheta_reference_poly),
        **{k: torch.tensor(np.asarray(getattr(cam, k), np.float32),
                           device=device) for k in CAMERA_TENSORS})


def torch_scene(cam, state):
    return torch_camera(cam), model_from_state(state)


def np32(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


# the id patterns that stress kernel F's set-up: one id owning 5,000 of
# 6,000 pairs (a run sorted in place in memory), every id distinct, ids
# outside [0, n_rows) (dropped), and no pairs at all
ADVERSARIAL_IDS = ("one_id_5000", "distinct", "out_of_range", "empty")


def adversarial_ids(case: str, seed: int = 0):
    """(ids [P] int32, n_rows) of one ADVERSARIAL_IDS case, from a numpy
    seed; n_rows is a multiple of 8, as JAX's scatter requires."""
    rng = np.random.default_rng(seed)
    if case == "one_id_5000":
        ids = rng.integers(0, 64, 6000)
        ids[rng.choice(6000, 5000, replace=False)] = 17
        return ids.astype(np.int32), 64
    if case == "distinct":
        return rng.permutation(4096)[:3000].astype(np.int32), 4096
    if case == "out_of_range":
        return rng.integers(-20, 84, 3000).astype(np.int32), 64
    if case == "empty":
        return np.zeros(0, np.int32), 64
    raise ValueError(case)


def far_rays(model, dist=300.0, side=48):
    """Rays [side, side, 3] (origins, directions) from ``dist`` units
    behind the live cloud's centre (300: about 2,000 of the bench cloud's
    3-sigma particle radii) onto a side x side grid over its extent, on
    the model's device: trace's cull at far origins."""
    pos = model.positions.detach()[:model.n_active].double().cpu()
    c = pos.mean(0)
    lo, hi = pos.amin(0), pos.amax(0)
    o = c - torch.tensor([0.0, 0.0, dist], dtype=torch.float64)
    u = torch.linspace(0.0, 1.0, side, dtype=torch.float64)
    gx, gy = torch.meshgrid(lo[0] + (hi[0] - lo[0]) * u,
                            lo[1] + (hi[1] - lo[1]) * u, indexing="ij")
    target = torch.stack([gx, gy, torch.full_like(gx, float(c[2]))], -1)
    d = target - o
    d = d / d.norm(dim=-1, keepdim=True)
    dev = model.device
    return (o.expand_as(d).float().contiguous().to(dev),
            d.float().contiguous().to(dev))


def faint_column(n=512, seed=5, device="cpu"):
    """n faint particles (density 0.02, so a ray survives them all) along
    the z axis between 2 and 6, jittered by 0.02 across it: trace's rays
    down it accept more candidates in a window than the kernels' k-buffer
    holds (common.cuh:kTraceK)."""
    from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                       GaussianModelConfig)

    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0:2] = rng.uniform(-0.02, 0.02, (n, 2))
    pos[:, 2] = rng.uniform(2.0, 6.0, n)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    arrays = dict(positions=pos, rotation=quat,
                  scale=rng.uniform(0.05, 0.1, (n, 3)).astype(np.float32),
                  density=np.full((n, 1), 0.02, np.float32),
                  features_albedo=rng.uniform(0, 1, (n, 3)).astype(
                      np.float32),
                  features_specular=np.zeros((n, 0), np.float32))
    return GaussianModel.from_numpy(arrays, config=GaussianModelConfig(
        density_activation="none", scale_activation="none", max_sh_degree=0),
        device=device)


def column_rays(side=16, device="cpu"):
    """side x side rays from z = 0 down ``faint_column``, within 0.05 of
    its axis."""
    u = torch.linspace(-0.05, 0.05, side, device=device)
    gx, gy = torch.meshgrid(u, u, indexing="ij")
    ro = torch.stack([gx, gy, torch.zeros_like(gx)], -1)
    rd = torch.zeros_like(ro)
    rd[..., 2] = 1.0
    return ro, rd


def incoherent_rays(model, side=48, seed=9):
    """Rays [side, side, 3] (origins, directions) and t_min [side, side]
    with origins drawn across the live cloud's box grown by a fifth on
    each side, on the model's device. The first half of the rows look
    within 37 degrees of one axis from origins spread over the box (warps
    whose pyramid has a wide apex); the second half look anywhere, and a
    quarter of them are open 10 units behind their origin (t_min -10), so
    their warps test every pair."""
    rng = np.random.default_rng(seed)
    pos = model.positions.detach()[:model.n_active].double().cpu().numpy()
    lo, hi = pos.min(0), pos.max(0)
    pad = 0.2 * (hi - lo)
    ro = rng.uniform(lo - pad, hi + pad, (side, side, 3))
    rd = rng.normal(size=(side, side, 3))
    half = side // 2
    ball = rng.normal(size=(half, side, 3))
    ball *= (0.6 * rng.uniform(0.0, 1.0, (half, side, 1)) ** (1.0 / 3.0)
             / np.linalg.norm(ball, axis=-1, keepdims=True))
    axis = np.array([0.3, -0.2, 1.0]) / np.linalg.norm([0.3, -0.2, 1.0])
    rd[:half] = axis + ball
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    t_min = np.full((side, side), 1e-4)
    t_min[half:][rng.uniform(size=(side - half, side)) < 0.25] = -10.0
    dev = model.device
    return tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                 for x in (ro, rd, t_min))
