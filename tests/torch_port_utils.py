"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
move JAX scenes, cameras and outputs into the PyTorch port."""

import numpy as np
import torch

from threedgrut_tpu_torch.convert import model_from_state
from threedgrut_tpu_torch.ops.cameras import make_pinhole as t_make_pinhole


def torch_camera(cam):
    """A JAX pinhole CameraModel (global shutter) as the port's camera."""
    return t_make_pinhole(
        cam.resolution, np.asarray(cam.focal), np.asarray(cam.principal),
        radial=np.asarray(cam.radial), tangential=np.asarray(cam.tangential),
        thin_prism=np.asarray(cam.thin_prism), t=np.asarray(cam.t_start),
        q=np.asarray(cam.q_start))


def torch_scene(cam, state):
    return torch_camera(cam), model_from_state(state)


def np32(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)
