"""3DGRT primary-ray rendering (port of threedgrut_tpu/render/grt.py:42-55).

The 3DGRT renderer of camera rays is the 3DGUT pipeline with the 3DGRT
settings of configs/render/3dgrt.yaml: the degree-4 particle kernel,
min_transmittance 1e-3, and sorted compositing, in which every ray
re-sorts each window of ``sort_window`` depth-consecutive candidates by
its own hit distance before compositing them (the analogue of the
reference's k = 16 hit buffer).

``trace`` (arbitrary rays), ``GridAccel`` and ``build_grid`` are not
ported: only the playground calls them (ROADMAP.md queue 1 item 20).
"""

from __future__ import annotations

from typing import Optional

from ..models.gaussians import GaussianModel
from ..ops.cameras import CameraModel
from ..ops.ut import UTConfig
from .common import RasterConfig
from .gut import render_gut


def grt_raster_config(base: Optional[RasterConfig] = None) -> RasterConfig:
    """3DGRT rendering defaults (configs/render/3dgrt.yaml)."""
    base = base or RasterConfig()
    return base.replace(kernel_degree=4, min_transmittance=1e-3,
                        sorted_compositing=True)


def render_grt(cam: CameraModel, ut_cfg: UTConfig, raster_cfg: RasterConfig,
               model: GaussianModel, sh_degree: int, rays=None):
    """Primary-ray 3DGRT render (camera view, or the world-space
    ``rays`` = (ray_o, ray_d) given), differentiable in the model's
    parameters."""
    return render_gut(cam, ut_cfg, grt_raster_config(raster_cfg), model,
                      sh_degree, rays=rays)
