"""Forward-only serving renderer (port of threedgrut_tpu/render/serve.py).

Renders a frozen model for a batch of views, the deployment and eval hot
path. The body is a plain eager loop over the views under
``torch.inference_mode()``; each view runs the whole 3DGUT pipeline, or
the 3DGRT one with ``render/grt.py:grt_raster_config()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..models.background import apply_background
from ..models.gaussians import GaussianModel
from ..ops.cameras import CameraModel
from ..ops.ut import UTConfig
from .common import RasterConfig
from .gut import render_gut


def make_serving_renderer(model: GaussianModel, raster_cfg: RasterConfig,
                          sh_degree: int,
                          ut_cfg: Optional[UTConfig] = None,
                          background: Optional[torch.Tensor] = None):
    """``render(cams) -> [B, H, W, 3]`` for a sequence of cameras of one
    resolution, one camera model and one shutter type (JAX
    render/serve.py:49-50): pinhole or fisheye, global or rolling.
    ``background`` (optional [3], default black) is composited
    against the residual transmittance, as the eval renderer does.
    Normals are off whatever ``raster_cfg`` says: a served view returns
    colour only (JAX render/serve.py:serving_raster_config)."""
    ut_cfg = ut_cfg or UTConfig()
    raster_cfg = dataclasses.replace(raster_cfg, enable_normals=False)
    bg = (torch.zeros(3, dtype=torch.float32, device=model.device)
          if background is None
          else torch.as_tensor(background, dtype=torch.float32,
                               device=model.device))

    def render(cams: Sequence[CameraModel]) -> torch.Tensor:
        if len({(c.resolution, c.model_type, c.shutter_type)
                for c in cams}) != 1:
            raise ValueError("a batch needs one resolution, camera model "
                             "and shutter type")
        with torch.inference_mode():
            imgs = []
            for cam in cams:
                out = render_gut(cam, ut_cfg, raster_cfg, model, sh_degree)
                imgs.append(apply_background(out["pred_features"],
                                             out["pred_opacity"], bg))
            return torch.stack(imgs)

    return render
