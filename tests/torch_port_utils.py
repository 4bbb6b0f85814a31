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
