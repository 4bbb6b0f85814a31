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
