"""Kernel P wrapper: a view's projection of every particle row in one pass,
and its backward, kernel P_b.

Kernel P (``csrc/project.cu``) replaces no TPU kernel: the JAX package's
projection is plain XLA (threedgrut_tpu/ops/ut.py, ops/sh.py,
render/gut.py). It computes, for every row of a 3DGUT model with SH
features, what ``project_view_plain`` composes from
``ops/ut.py:unscented_projection``, ``ops/sh.py:eval_sh_radiance``,
``render/gut.py:particle_table`` and ``_scene_aabb``: the UT projection
(without ``view_dir``, which only the SH read), the table records with
their radiance, and the scene AABB. Where a gradient can flow,
``ProjectFunction`` wraps the same launch, and its backward is kernel P_b
(the same file): the table's cotangent to the six raw parameters, whose
plain version is ``project_view_backward_plain``. On CPU tensors the
wrapper runs ``project_view_plain``, whose autograd is the CPU path. The
kernels' header notes say what bounds them and how they are laid out.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ...models.gaussians import (ACTIVATIONS, PARAM_NAMES, GaussianModel,
                                 param_names)
from ...utils.timer import ScopedTimer
from ..cameras import CameraModel, margin_bounds
from ..quaternion import quat_to_rotmat
from ..sh import (SH_C1, SH_C2, SH_C3, eval_sh_radiance, num_sh_coeffs,
                  sh_basis)
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
# kNumFloats) and of project_bwd_launch's BwdParams (kNumBwdInts)
NUM_INTS = 18
NUM_FLOATS = 12
NUM_BWD_INTS = 6


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
    ``sh_degree``, and the scene AABB. An SH model only. Where a gradient
    can flow into its parameters (``needs_grad``) the table is
    ``ProjectFunction``'s, whose backward is kernel P_b; otherwise the
    launch records no autograd node."""
    if model.config.feature_type != "sh":
        raise NotImplementedError("kernel P has no NHT mode")
    if not 0 <= sh_degree <= model.config.max_sh_degree:
        raise ValueError(f"sh_degree {sh_degree}: the model holds degrees "
                         f"0-{model.config.max_sh_degree}")
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
        if needs_grad(model):
            outs = ProjectFunction.apply(cam, ut_cfg, model, sh_degree,
                                         shared, *inputs)
        else:
            outs = _launch(cam, ut_cfg, model, sh_degree, shared, inputs)
    valid, center, conic, opacity, extent, depth, table, aabb = outs
    proj = Projection(valid=valid, center=center, conic=conic,
                      opacity=opacity, extent=extent, depth=depth,
                      view_dir=None)
    return ProjectedView(proj, table, aabb[0], aabb[1])


project_view.launches = 0
project_view.launches_general = 0
project_view.launches_backward = 0


def _launch(cam: CameraModel, ut_cfg: UTConfig, model: GaussianModel,
            sh_degree: int, shared: bool, inputs):
    """One launch of kernel P on ``inputs`` (the six parameters, checked):
    (valid, center, conic, opacity, extent, depth, table, aabb [2, 3])."""
    dev = model.device
    c = model.capacity
    fields = []
    for name, size in CAMERA_FIELDS:
        t = getattr(cam, name).contiguous()
        if t.dtype != torch.float32 or t.numel() != size or t.device != dev:
            raise ValueError(f"camera {name}: {t.dtype} [{t.numel()}] on "
                             f"{t.device}, expected float32 [{size}] on "
                             f"{dev}")
        fields.append(t)
    f32 = dict(dtype=torch.float32, device=dev)
    outputs = (torch.empty(c, dtype=torch.bool, device=dev),   # valid
               torch.empty((c, 2), **f32),                     # center
               torch.empty((c, 3), **f32),                     # conic
               torch.empty(c, **f32),                          # opacity
               torch.empty((c, 2), **f32),                     # extent
               torch.empty(c, **f32),                          # depth
               torch.empty((c, 16), **f32),                    # table
               torch.empty((2, 3), **f32))                     # aabb
    ptrs = [t.data_ptr() for t in (*inputs, *outputs, *fields)]
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
    return outputs


class ProjectFunction(torch.autograd.Function):
    """Kernel P under a gradient: ``apply(cam, ut_cfg, model, sh_degree,
    shared, *params)`` with the six raw parameters in PARAM_NAMES order
    gives P's eight outputs, of which the table alone is differentiable
    (the UT's outputs feed the binning, which carries no gradient). Its
    backward is kernel P_b: the table's cotangent to every parameter that
    requires grad, None to the others. On CPU tensors the forward is
    ``project_view_plain`` and the backward ``project_view_backward_plain``.
    Saves the parameters themselves, not copies, and the camera."""

    @staticmethod
    def forward(ctx, cam, ut_cfg, model, sh_degree, shared, *params):
        if params[0].device.type == "cuda":
            outs = _launch(cam, ut_cfg, model, sh_degree, shared, params)
        else:
            pv = project_view_plain(cam, ut_cfg, model, sh_degree, shared)
            outs = (*pv.proj[:6], pv.table,
                    torch.stack([pv.aabb_lo, pv.aabb_hi]))
        ctx.mark_non_differentiable(*outs[:6], outs[7])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*params)
        ctx.cam, ctx.config = cam, model.config
        ctx.sh_degree, ctx.shared = sh_degree, shared
        return outs

    @staticmethod
    def backward(ctx, *grads):
        d_table = grads[6]
        none = (None,) * 5
        if d_table is None:
            return none + (None,) * len(PARAM_NAMES)
        wanted = ctx.needs_input_grad[5:]
        return none + tuple(project_view_backward(
            d_table, ctx.saved_tensors, ctx.cam, ctx.config, ctx.sh_degree,
            ctx.shared, wanted))


def project_view_backward(d_table: torch.Tensor, params, cam: CameraModel,
                          config, sh_degree: int, shared: bool,
                          wanted=None):
    """Kernel P_b: the cotangent ``d_table`` [C, 16] of ``project_view``'s
    table to the six raw parameters ``params`` (PARAM_NAMES order) of a
    model of ``config``, viewed by ``cam``, as a list of six gradients;
    None where ``wanted`` (six bools, all by default) is false, and then
    the kernel computes into no memory. On CPU tensors:
    ``project_view_backward_plain``."""
    wanted = wanted or (True,) * len(PARAM_NAMES)
    dev = d_table.device
    if dev.type == "cpu":
        got = project_view_backward_plain(d_table, params, cam, config,
                                          sh_degree, shared)
        return [g if w else None for g, w in zip(got, wanted)]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    d_table = d_table.contiguous()
    c = params[0].shape[0]
    build.check_tensor("d_table", d_table, torch.float32, (c, 16), dev)
    for name, t in zip(PARAM_NAMES, params):
        build.check_tensor(name, t, torch.float32, (c, t.shape[1]), dev)
    grads = [torch.empty_like(t) if w else None
             for t, w in zip(params, wanted)]
    cam_ptrs = []
    for name, size in (("t_start", 3), ("q_start", 4)):
        t = getattr(cam, name).contiguous()
        build.check_tensor(f"camera {name}", t.reshape(-1), torch.float32,
                           (size,), dev)
        cam_ptrs.append(t)
    ptrs = [t.data_ptr() for t in (*params, d_table)] + [
        0 if g is None else g.data_ptr() for g in grads] + [
        t.data_ptr() for t in cam_ptrs]
    ints = backward_params(c, config, sh_degree, params[5].shape[1], shared)
    lib = _lib()
    err = lib.project_bwd_launch(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * NUM_BWD_INTS)(*ints),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("project_bwd", err, lib)
    project_view.launches_backward += 1
    return grads


def backward_params(n: int, config, sh_degree: int, sh_stride: int,
                    shared: bool):
    """The fields of csrc/project.cu's BwdParams, in order."""
    return [n, sh_degree, sh_stride,
            ACTIVATION_IDS[config.scale_activation],
            ACTIVATION_IDS[config.density_activation], int(shared)]


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
        lib.project_bwd_launch.argtypes = [p, p, p]
        lib.project_bwd_launch.restype = ctypes.c_int
    return lib


def kernel_attributes():
    """{pinhole, pinhole_rolling, fisheye, fisheye_rolling, ftheta,
    ftheta_rolling: build.attributes} of kernel P's instantiations."""
    return build.attributes("project", (
        "pinhole", "pinhole_rolling", "fisheye", "fisheye_rolling", "ftheta",
        "ftheta_rolling"))


def backward_kernel_attributes():
    """{degree0, ..., degree3: build.attributes} of kernel P_b's
    instantiations, one an SH degree."""
    return build.attributes("project", tuple(
        f"degree{d}" for d in range(4)), function="project_bwd_attributes")


def project_view_plain(cam: CameraModel, ut_cfg: UTConfig,
                       model: GaussianModel, sh_degree: int,
                       shared: bool) -> ProjectedView:
    """Plain PyTorch version of ``project_view``, and the autograd path of
    CPU tensors and of NHT models: the composition of ``unscented_projection``, the SH radiance clamped
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


def _grad_of_activation(name: str, g: torch.Tensor, y: torch.Tensor):
    """g d act(x) / dx from the activated value y, as torch's backward of
    exp (g y) and sigmoid (g (1 - y) y)."""
    if name == "exp":
        return g * y
    if name == "sigmoid":
        return g * (1.0 - y) * y
    return g


def _sh_basis_vjp(v: torch.Tensor, gb: torch.Tensor, degree: int):
    """[C, 3] the unit directions' cotangent from the basis' ``gb`` [C, nb]
    (the derivative of ops/sh.py:sh_basis, term by term, in P_b's
    order)."""
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    gx, gy, gz = (torch.zeros_like(x) for _ in range(3))
    if degree >= 1:
        gy = gy - SH_C1 * gb[:, 1]
        gz = gz + SH_C1 * gb[:, 2]
        gx = gx - SH_C1 * gb[:, 3]
    if degree >= 2:
        t = SH_C2[0] * gb[:, 4]
        gx, gy = gx + t * y, gy + t * x
        t = SH_C2[1] * gb[:, 5]
        gy, gz = gy + t * z, gz + t * y
        t = SH_C2[2] * gb[:, 6]
        gx, gy = gx - t * (2.0 * x), gy - t * (2.0 * y)
        gz = gz + t * (4.0 * z)
        t = SH_C2[3] * gb[:, 7]
        gx, gz = gx + t * z, gz + t * x
        t = SH_C2[4] * gb[:, 8]
        gx, gy = gx + t * (2.0 * x), gy - t * (2.0 * y)
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        t = SH_C3[0] * gb[:, 9]
        gx, gy = gx + t * (6.0 * xy), gy + t * (3.0 * xx - 3.0 * yy)
        t = SH_C3[1] * gb[:, 10]
        gx, gy, gz = gx + t * yz, gy + t * xz, gz + t * xy
        t = SH_C3[2] * gb[:, 11]
        gx = gx - t * (2.0 * xy)
        gy = gy + t * (4.0 * zz - xx - 3.0 * yy)
        gz = gz + t * (8.0 * yz)
        t = SH_C3[3] * gb[:, 12]
        gx, gy = gx - t * (6.0 * xz), gy - t * (6.0 * yz)
        gz = gz + t * (6.0 * zz - 3.0 * xx - 3.0 * yy)
        t = SH_C3[4] * gb[:, 13]
        gx = gx + t * (4.0 * zz - 3.0 * xx - yy)
        gy, gz = gy - t * (2.0 * xy), gz + t * (8.0 * xz)
        t = SH_C3[5] * gb[:, 14]
        gx, gy = gx + t * (2.0 * xz), gy - t * (2.0 * yz)
        gz = gz + t * (xx - yy)
        t = SH_C3[6] * gb[:, 15]
        gx, gy = gx + t * (3.0 * xx - 3.0 * yy), gy - t * (6.0 * xy)
    return torch.stack([gx, gy, gz], dim=1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a . b over the last axis, summed left to right."""
    out = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i] * b[..., i]
    return out


def _normalize_vjp(v, clamped, norm, g):
    """The cotangent of u / max(|u|, 1e-12) to u from the unit vectors v,
    the clamped norms, the norms and the output's cotangent g; torch's
    clamp passes the norm's gradient where the norm is >= 1e-12."""
    vg = torch.where(norm >= 1e-12, _dot(v, g), torch.zeros_like(norm))
    return (g - v * vg[:, None]) / clamped[:, None]


def project_view_backward_plain(d_table: torch.Tensor, params,
                                cam: CameraModel, config, sh_degree: int,
                                shared: bool):
    """Plain PyTorch version of ``project_view_backward`` (kernel P_b):
    the six gradients, in the parameters' shapes. The composition's chain
    rule written out in the kernel's order, with the camera's sensor
    position o (the shared records' origin and the SH direction's): the
    SH radiance (its clamp passing at 0), the direction's normalisation,
    a = M (o - p) (``shared``) or p, M = diag(1/s) R(q / |q|)^T and the
    activations. Rows whose cotangent is 0 get exact zeros, as do the
    coefficients past ``sh_degree``."""
    origin = sensor_position(cam)
    pos, rot, scale, dens, alb, spec = (t.detach() for t in params)
    g = d_table.detach()
    c = pos.shape[0]
    nb = num_sh_coeffs(sh_degree)
    # the radiance: rgb = max(SH(dir) . coeffs + 0.5, 0)
    sr = pos - origin
    dist = torch.sqrt(_dot(sr, sr))
    ds = torch.clamp(dist, min=1e-12)
    v = sr / ds[:, None]
    basis = sh_basis(v, sh_degree)
    coeffs = torch.cat([alb[:, None], spec.reshape(c, -1, 3)[:, :nb - 1]],
                       dim=1)                                  # [C, nb, 3]
    pre = basis[:, 0:1] * coeffs[:, 0]
    for k in range(1, nb):
        pre = pre + basis[:, k:k + 1] * coeffs[:, k]
    g_pre = torch.where(pre + 0.5 >= 0.0, g[:, 13:16],
                        torch.zeros_like(pre))
    g_coeffs = basis[:, :, None] * g_pre[:, None, :]
    g_pos = _normalize_vjp(v, ds, dist, _sh_basis_vjp(
        v, _dot(coeffs, g_pre[:, None, :]), sh_degree))
    # M = diag(1/s) R(q / |q|)^T
    qn = torch.sqrt(_dot(rot, rot))
    qs = torch.clamp(qn, min=1e-12)
    qh = rot / qs[:, None]
    r = quat_to_rotmat(qh)                                     # [C, 3, 3]
    s = ACTIVATIONS[config.scale_activation](scale)
    inv = 1.0 / s
    m_t = inv[:, None, :] * r                    # M^T: [j][i] = inv_i R_ji
    g_m = g[:, 3:12].reshape(c, 3, 3)
    if shared:
        d = origin - pos
        g_m = g_m + g[:, 0:3, None] * d[:, None, :]
        g_pos = g_pos - _dot(m_t, g[:, None, 0:3])
    else:
        g_pos = g_pos + g[:, 0:3]
    g_inv = _dot(g_m, r.transpose(1, 2))
    g_scale = _grad_of_activation(config.scale_activation,
                                  -g_inv * (inv * inv), s)
    g_r = (g_m * inv[:, :, None]).transpose(1, 2).reshape(c, 9)
    w, x, y, z = qh.unbind(1)
    gr = g_r.unbind(1)
    g_qh = torch.stack([
        2.0 * (-z * gr[1] + y * gr[2] + z * gr[3] - x * gr[5] - y * gr[6]
               + x * gr[7]),
        2.0 * (y * gr[1] + z * gr[2] + y * gr[3] - 2.0 * x * gr[4]
               - w * gr[5] + z * gr[6] + w * gr[7] - 2.0 * x * gr[8]),
        2.0 * (-2.0 * y * gr[0] + x * gr[1] + w * gr[2] + x * gr[3]
               + z * gr[5] - w * gr[6] + z * gr[7] - 2.0 * y * gr[8]),
        2.0 * (-2.0 * z * gr[0] - w * gr[1] + x * gr[2] + w * gr[3]
               - 2.0 * z * gr[4] + y * gr[5] + x * gr[6] + y * gr[7]),
    ], dim=1)
    g_rot = _normalize_vjp(qh, qs, qn, g_qh)
    g_dens = _grad_of_activation(
        config.density_activation, g[:, 12:13],
        ACTIVATIONS[config.density_activation](dens))
    g_spec = torch.zeros_like(spec)
    g_spec[:, :3 * (nb - 1)] = g_coeffs[:, 1:].reshape(c, -1)
    grads = [g_pos, g_rot, g_scale, g_dens, g_coeffs[:, 0], g_spec]
    live = (g != 0).any(dim=1, keepdim=True)
    return [torch.where(live, t, torch.zeros_like(t)) for t in grads]
