"""Kernel P wrapper: a view's projection of every particle row in one pass.

Kernel P (``csrc/project.cu``) replaces no TPU kernel: the JAX package's
projection is plain XLA (threedgrut_tpu/ops/ut.py, ops/sh.py,
render/gut.py). It computes, for every row of a 3DGUT model with SH
features, what ``project_view_plain`` composes from
``ops/ut.py:unscented_projection``, ``ops/sh.py:eval_sh_radiance``,
``render/gut.py:particle_table`` and ``_scene_aabb``: the UT projection
(without ``view_dir``, which only the SH read), the table records with
their radiance, and the scene AABB. It has no backward:
``render/gut.py:prepare_view`` launches it where no gradient can flow
and keeps the composition, which is autograd's, where one can. On CPU
tensors the wrapper runs ``project_view_plain``. The kernel's header
says what bounds it and how it is laid out.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ...models.gaussians import PARAM_NAMES, GaussianModel, param_names
from ...utils.timer import ScopedTimer
from ..cameras import CameraModel, margin_bounds
from ..sh import eval_sh_radiance, num_sh_coeffs
from ..ut import Projection, UTConfig, sensor_position, unscented_projection
from . import build

# the activation ids of csrc/project.cu (models/gaussians.py:ACTIVATIONS)
ACTIVATION_IDS = {"none": 0, "exp": 1, "sigmoid": 2}
# the camera's tensors in the order project_launch reads them, and their
# sizes
CAMERA_FIELDS = (("focal", 2), ("principal", 2), ("radial", 6),
                 ("tangential", 2), ("thin_prism", 4), ("max_angle", 1),
                 ("ftheta_angle_to_pixeldist", 6),
                 ("ftheta_pixeldist_to_angle", 6), ("ftheta_linear_cde", 3),
                 ("t_start", 3), ("q_start", 4), ("t_end", 3), ("q_end", 4))
# the sizes of project_launch's Params arrays (csrc/project.cu: kNumInts,
# kNumFloats)
NUM_INTS = 18
NUM_FLOATS = 12


class ProjectedView(NamedTuple):
    """What the capacity-long part of ``prepare_view`` makes for a view."""
    proj: Projection
    table: torch.Tensor    # [C, 16] (NHT: [C, 16 + 4 d])
    aabb_lo: torch.Tensor  # [3] scene AABB of the active rows
    aabb_hi: torch.Tensor  # [3]


def needs_grad(model: GaussianModel) -> bool:
    """Whether a gradient can flow into the model's parameters (those of
    a GaussianModel, or of a view of one, ``parallel/dp.py:ParamView``)."""
    return torch.is_grad_enabled() and any(
        getattr(model, k).requires_grad
        for k in param_names(model.config.feature_type))


def project_view(cam: CameraModel, ut_cfg: UTConfig, model: GaussianModel,
                 sh_degree: int, shared: bool) -> ProjectedView:
    """Kernel P: the UT projection of every row (``view_dir`` None), its
    table records (``shared``: a = M (o - p) from the camera's sensor
    position, else the positions) with the SH radiance up to
    ``sh_degree``, and the scene AABB. An SH model only, and no gradient
    (``needs_grad`` false)."""
    if model.config.feature_type != "sh":
        raise NotImplementedError("kernel P has no NHT mode")
    if not 0 <= sh_degree <= model.config.max_sh_degree:
        raise ValueError(f"sh_degree {sh_degree}: the model holds degrees "
                         f"0-{model.config.max_sh_degree}")
    if needs_grad(model):
        raise ValueError("kernel P has no backward: the model's parameters "
                         "require grad; call project_view_plain")
    dev = model.device
    if dev.type == "cpu":
        return project_view_plain(cam, ut_cfg, model, sh_degree, shared)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    with ScopedTimer("grut.ut"):
        c = model.capacity
        stride = 3 * (num_sh_coeffs(model.config.max_sh_degree) - 1)
        inputs = []
        for name, width in zip(PARAM_NAMES, (3, 4, 3, 1, 3, stride)):
            t = getattr(model, name).contiguous()
            build.check_tensor(name, t, torch.float32, (c, width), dev)
            inputs.append(t)
        fields = []
        for name, size in CAMERA_FIELDS:
            t = getattr(cam, name).contiguous()
            if t.dtype != torch.float32 or t.numel() != size or \
                    t.device != dev:
                raise ValueError(f"camera {name}: {t.dtype} [{t.numel()}] "
                                 f"on {t.device}, expected float32 [{size}] "
                                 f"on {dev}")
            fields.append(t)
        f32 = dict(dtype=torch.float32, device=dev)
        valid = torch.empty(c, dtype=torch.bool, device=dev)
        center = torch.empty((c, 2), **f32)
        conic = torch.empty((c, 3), **f32)
        opacity = torch.empty(c, **f32)
        extent = torch.empty((c, 2), **f32)
        depth = torch.empty(c, **f32)
        table = torch.empty((c, 16), **f32)
        aabb = torch.empty((2, 3), **f32)
        outputs = (valid, center, conic, opacity, extent, depth, table, aabb)
        ptrs = [t.data_ptr() for t in inputs] + [
            t.data_ptr() for t in outputs] + [t.data_ptr() for t in fields]
        ints, floats = launch_params(cam, ut_cfg, model, sh_degree, shared)
        lib = _lib()
        err = lib.project_launch(
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * NUM_INTS)(*ints),
            (ctypes.c_float * NUM_FLOATS)(*floats),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check_launch("project", err, lib)
        if shared:
            project_view.launches += 1
        else:
            project_view.launches_general += 1
    proj = Projection(valid=valid, center=center, conic=conic,
                      opacity=opacity, extent=extent, depth=depth,
                      view_dir=None)
    return ProjectedView(proj, table, aabb[0], aabb[1])


project_view.launches = 0
project_view.launches_general = 0


def launch_params(cam: CameraModel, ut_cfg: UTConfig, model: GaussianModel,
                  sh_degree: int, shared: bool):
    """(ints, floats): the fields of csrc/project.cu's Params, in order.
    Constants the plain composition takes as Python floats (the UT weights,
    the margin bounds, the out-of-image radius) are rounded to fp32 here, as
    PyTorch rounds them against an fp32 tensor."""
    n_sigma_d = 3
    lam = ut_cfg.alpha * ut_cfg.alpha * (n_sigma_d + ut_cfg.kappa) - n_sigma_d
    w0 = lam / (n_sigma_d + lam)
    wi = 1.0 / (2.0 * (n_sigma_d + lam))
    w0_cov = w0 + (1.0 - ut_cfg.alpha * ut_cfg.alpha + ut_cfg.beta)
    ints = [model.capacity, model.n_active, sh_degree,
            3 * (num_sh_coeffs(model.config.max_sh_degree) - 1),
            ACTIVATION_IDS[model.config.scale_activation],
            ACTIVATION_IDS[model.config.density_activation],
            int(cam.model_type), int(cam.shutter_type),
            ut_cfg.n_rolling_shutter_iterations, int(cam.ftheta_reference_poly),
            int(ut_cfg.require_all_sigma_points), int(ut_cfg.rect_bounding),
            int(ut_cfg.tight_opacity_bounding),
            int(ut_cfg.mip_splatting_scaling), int(ut_cfg.global_z_order),
            int(shared), cam.width, cam.height]
    floats = [w0, wi, w0_cov, ut_cfg.delta,
              *margin_bounds(cam.resolution, ut_cfg.image_margin_factor),
              math.hypot(float(cam.width), float(cam.height)),
              ut_cfg.min_sensor_z, ut_cfg.covariance_dilation,
              ut_cfg.alpha_threshold]
    return ints, floats


def _lib() -> ctypes.CDLL:
    lib = build.load("project")
    fn = lib.project_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def kernel_attributes():
    """{pinhole, pinhole_rolling, fisheye, fisheye_rolling, ftheta,
    ftheta_rolling: build.attributes} of kernel P's instantiations."""
    return build.attributes("project", (
        "pinhole", "pinhole_rolling", "fisheye", "fisheye_rolling", "ftheta",
        "ftheta_rolling"))


def project_view_plain(cam: CameraModel, ut_cfg: UTConfig,
                       model: GaussianModel, sh_degree: int,
                       shared: bool) -> ProjectedView:
    """Plain PyTorch version of ``project_view``, and the autograd path:
    the composition of ``unscented_projection``, the SH radiance clamped
    at 0 (an NHT model: its raw control features and 3 slots of padding),
    ``particle_table`` and the scene AABB (no gradient), in the spans
    ``grut.ut``, ``grut.sh`` and ``grut.table``. ``proj.view_dir`` is
    set."""
    # render/gut.py imports this module
    from ...render.gut import _scene_aabb, particle_table

    proj = unscented_projection(
        cam, ut_cfg, model.positions, model.rotation, model.get_scale(),
        model.get_density()[:, 0], model.active_mask())
    with ScopedTimer("grut.sh"):
        if model.config.feature_type == "nht":
            feats = torch.cat([model.features, model.features.new_zeros(
                (model.capacity, 3))], dim=1)
        else:
            # per-particle radiance from the sensor->particle direction,
            # clamped at 0 like the renderer's max(features, 0) fetch
            feats = torch.clamp(eval_sh_radiance(
                model.sh_coeffs(), proj.view_dir, sh_degree), min=0.0)
    with ScopedTimer("grut.table"):
        table = particle_table(
            model, sensor_position(cam) if shared else None, feats)
        with torch.no_grad():
            lo, hi = _scene_aabb(model)
    return ProjectedView(proj, table, lo, hi)
