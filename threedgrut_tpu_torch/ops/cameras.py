"""Camera models and rolling shutter
(port of threedgrut_tpu/ops/cameras.py).

- OpenCV pinhole with radial(6) / tangential(2) / thin-prism(4)
  distortion (reference cameraProjections.cuh:72-118),
- OpenCV fisheye with 4 radial theta-poly coefficients (:120-146),
- FTheta polynomial cameras, both polynomial directions, with Newton
  inversion (:148-198),
- rolling-shutter projection by pose slerp and fixed-point iteration
  (:218-257).

The camera's model and shutter types are plain Python ints: the
projection dispatches on them in Python, as the JAX package does at
trace time. Field names follow the JAX ``CameraModel``.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .quaternion import quat_slerp, quat_to_rotmat

FTHETA_POLY_DEGREE = 6


class ShutterType(enum.IntEnum):
    GLOBAL = 0
    ROLLING_TOP_TO_BOTTOM = 1
    ROLLING_LEFT_TO_RIGHT = 2
    ROLLING_BOTTOM_TO_TOP = 3
    ROLLING_RIGHT_TO_LEFT = 4


class CameraModelType(enum.IntEnum):
    OPENCV_PINHOLE = 0
    OPENCV_FISHEYE = 1
    FTHETA = 2


@dataclasses.dataclass
class CameraModel:
    """Intrinsics, shutter and world->camera poses of one sensor view:
    ``x_cam = R(q) x_world + t`` at the shutter's start and end. All
    tensors are float32 on one device."""
    resolution: Tuple[int, int]                      # (W, H)
    model_type: int = int(CameraModelType.OPENCV_PINHOLE)
    shutter_type: int = int(ShutterType.GLOBAL)
    # FTheta: 0 evaluates angle->pixeldist directly, 1 Newton-inverts the
    # calibrated pixeldist->angle polynomial
    ftheta_reference_poly: int = 0
    focal: Optional[torch.Tensor] = None             # [2] fx, fy
    principal: Optional[torch.Tensor] = None         # [2] cx, cy
    radial: Optional[torch.Tensor] = None            # [6] (fisheye: 4 + pad)
    tangential: Optional[torch.Tensor] = None        # [2]
    thin_prism: Optional[torch.Tensor] = None        # [4]
    max_angle: Optional[torch.Tensor] = None         # [] FOV clamp
    ftheta_angle_to_pixeldist: Optional[torch.Tensor] = None   # [6]
    ftheta_pixeldist_to_angle: Optional[torch.Tensor] = None   # [6]
    ftheta_linear_cde: Optional[torch.Tensor] = None           # [3]
    t_start: Optional[torch.Tensor] = None           # [3]
    q_start: Optional[torch.Tensor] = None           # [4] wxyz
    t_end: Optional[torch.Tensor] = None             # [3]
    q_end: Optional[torch.Tensor] = None             # [4] wxyz

    @property
    def width(self) -> int:
        return self.resolution[0]

    @property
    def height(self) -> int:
        return self.resolution[1]

    @property
    def device(self) -> torch.device:
        return self.principal.device


def _camera(resolution, model_type, shutter_type, device, t, q, t_end,
            q_end, **fields) -> CameraModel:
    """The common part of the constructors: float32 tensors on
    ``device``, identity start pose by default, end pose = start pose
    unless given, zero distortion and a pi field of view."""
    def vec(v, n=None, default=0.0):
        if v is None:
            return torch.full((n,), default, dtype=torch.float32,
                              device=device)
        return torch.tensor(np.asarray(v, np.float32), device=device)

    qid = [1.0, 0.0, 0.0, 0.0]
    t_s = vec(t, 3)
    q_s = vec(q if q is not None else qid)
    kw = dict(radial=vec(None, 6), tangential=vec(None, 2),
              thin_prism=vec(None, 4), max_angle=vec(math.pi),
              ftheta_angle_to_pixeldist=vec(None, FTHETA_POLY_DEGREE),
              ftheta_pixeldist_to_angle=vec(None, FTHETA_POLY_DEGREE),
              ftheta_linear_cde=vec([1.0, 0.0, 0.0]))
    kw.update({k: vec(v) for k, v in fields.items()})
    return CameraModel(
        resolution=tuple(int(v) for v in resolution),
        model_type=int(model_type), shutter_type=int(shutter_type),
        t_start=t_s, q_start=q_s,
        t_end=t_s.clone() if t_end is None else vec(t_end),
        q_end=q_s.clone() if q_end is None else vec(q_end), **kw)


def make_pinhole(resolution, focal, principal, radial=None, tangential=None,
                 thin_prism=None, t=None, q=None, t_end=None, q_end=None,
                 shutter_type: int = int(ShutterType.GLOBAL),
                 device="cpu") -> CameraModel:
    """An (optionally distorted) pinhole camera; identity pose by default."""
    fields = dict(focal=focal, principal=principal)
    for k, v in (("radial", radial), ("tangential", tangential),
                 ("thin_prism", thin_prism)):
        if v is not None:
            fields[k] = v
    return _camera(resolution, CameraModelType.OPENCV_PINHOLE, shutter_type,
                   device, t, q, t_end, q_end, **fields)


def make_fisheye(resolution, focal, principal, radial4, max_angle, t=None,
                 q=None, t_end=None, q_end=None,
                 shutter_type: int = int(ShutterType.GLOBAL),
                 device="cpu") -> CameraModel:
    """An OpenCV fisheye camera: k1-k4 in ``radial4``."""
    radial = np.zeros(6, np.float32)
    radial[:4] = np.asarray(radial4, np.float32)
    return _camera(resolution, CameraModelType.OPENCV_FISHEYE, shutter_type,
                   device, t, q, t_end, q_end, focal=focal,
                   principal=principal, radial=radial, max_angle=max_angle)


def make_ftheta(resolution, principal, angle_to_pixeldist, pixeldist_to_angle,
                reference_poly: int, linear_cde, max_angle, t=None, q=None,
                t_end=None, q_end=None,
                shutter_type: int = int(ShutterType.GLOBAL),
                device="cpu") -> CameraModel:
    """An FTheta camera; polynomials padded to FTHETA_POLY_DEGREE."""
    def pad6(c):
        out = np.zeros(FTHETA_POLY_DEGREE, np.float32)
        c = np.asarray(c, np.float32)
        out[:c.shape[0]] = c
        return out

    cam = _camera(resolution, CameraModelType.FTHETA, shutter_type, device,
                  t, q, t_end, q_end, focal=[1.0, 1.0], principal=principal,
                  max_angle=max_angle,
                  ftheta_angle_to_pixeldist=pad6(angle_to_pixeldist),
                  ftheta_pixeldist_to_angle=pad6(pixeldist_to_angle),
                  ftheta_linear_cde=linear_cde)
    cam.ftheta_reference_poly = int(reference_poly)
    return cam


# ---------------------------------------------------------------------------
# projection of camera-space points
# ---------------------------------------------------------------------------

def _within_resolution(res_wh, tolerance, p):
    tol = torch.tensor(res_wh, dtype=torch.float32, device=p.device) \
        * tolerance
    return ((p[..., 0] > -tol[0]) & (p[..., 1] > -tol[1])
            & (p[..., 0] < res_wh[0] + tol[0])
            & (p[..., 1] < res_wh[1] + tol[1]))


def _horner(coeffs: torch.Tensor, n: int, x: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[i] x^i for i < n."""
    y = torch.zeros_like(x) + coeffs[n - 1]
    for i in range(n - 2, -1, -1):
        y = x * y + coeffs[i]
    return y


def _project_opencv_pinhole(cam: CameraModel, p: torch.Tensor, tolerance):
    """cameraProjections.cuh:72-118."""
    z = p[..., 2]
    valid_z = z > 0.0
    zs = torch.where(valid_z, z, torch.ones_like(z))
    uv = p[..., :2] / zs[..., None]
    uv2 = uv * uv
    r2 = uv2[..., 0] + uv2[..., 1]
    a1 = 2.0 * uv[..., 0] * uv[..., 1]
    a2 = r2 + 2.0 * uv2[..., 0]
    a3 = r2 + 2.0 * uv2[..., 1]
    k = cam.radial
    icd_num = 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
    icd_den = 1.0 + r2 * (k[3] + r2 * (k[4] + r2 * k[5]))
    icd = icd_num / icd_den
    t0, t1 = cam.tangential[0], cam.tangential[1]
    s = cam.thin_prism
    delta = torch.stack([
        t0 * a1 + t1 * a2 + r2 * (s[0] + r2 * s[1]),
        t0 * a3 + t1 * a1 + r2 * (s[2] + r2 * s[3]),
    ], dim=-1)
    uv_nd = icd[..., None] * uv + delta
    valid_radial = (icd > 0.8) & (icd < 1.2)
    proj_ok = uv_nd * cam.focal + cam.principal
    # out-of-limits: clip the direction to an out-of-image radius
    # (cameraProjections.cuh:108-115)
    roi_radius = math.hypot(float(cam.width), float(cam.height))
    proj_bad = (roi_radius / torch.sqrt(torch.clamp(r2, min=1e-20)))[
        ..., None] * uv + cam.principal
    proj = torch.where(valid_radial[..., None], proj_ok, proj_bad)
    valid = (valid_z & valid_radial
             & _within_resolution(cam.resolution, tolerance, proj))
    proj = torch.where(valid_z[..., None], proj, torch.zeros_like(proj))
    return proj, valid


def _stable_norm2(v: torch.Tensor) -> torch.Tensor:
    """|v[..., :2]| without overflow (cameraProjections.cuh)."""
    ax = torch.abs(v[..., 0])
    ay = torch.abs(v[..., 1])
    mn = torch.minimum(ax, ay)
    mx = torch.maximum(ax, ay)
    ratio = mn / torch.clamp(mx, min=1e-30)
    return torch.where(mx <= 0.0, torch.zeros_like(mx),
                       mx * torch.sqrt(1.0 + ratio * ratio))


def _project_opencv_fisheye(cam: CameraModel, p: torch.Tensor, tolerance):
    """cameraProjections.cuh:120-146."""
    rho = torch.clamp(_stable_norm2(p[..., :2]), min=1.1754944e-38)
    theta_full = torch.atan2(rho, p[..., 2])
    theta = torch.minimum(theta_full, cam.max_angle)
    theta2 = theta * theta
    poly = _horner(cam.radial, 4, theta2)
    delta = theta * (poly * theta2 + 1.0) / rho
    proj = cam.focal * p[..., :2] * delta[..., None] + cam.principal
    valid = ((theta < cam.max_angle)
             & _within_resolution(cam.resolution, tolerance, proj))
    return proj, valid


def _project_ftheta(cam: CameraModel, p: torch.Tensor, tolerance):
    """cameraProjections.cuh:148-198 (3 Newton iterations)."""
    rho = torch.clamp(_stable_norm2(p[..., :2]), min=1.1754944e-38)
    theta_full = torch.atan2(rho, p[..., 2])
    theta = torch.minimum(theta_full, cam.max_angle)
    n = FTHETA_POLY_DEGREE
    delta = _horner(cam.ftheta_angle_to_pixeldist, n, theta)
    if cam.ftheta_reference_poly == 1:  # PIXELDIST_TO_ANGLE is reference
        dcoef = (torch.arange(1, n, dtype=torch.float32, device=p.device)
                 * cam.ftheta_pixeldist_to_angle[1:])
        for _ in range(3):
            dfdx = _horner(dcoef, n - 1, delta)
            residual = _horner(cam.ftheta_pixeldist_to_angle, n, delta) \
                - theta
            delta = delta - residual / dfdx
    c, d, e = (cam.ftheta_linear_cde[0], cam.ftheta_linear_cde[1],
               cam.ftheta_linear_cde[2])
    scaled = (delta / rho)[..., None]
    proj = scaled * torch.stack([c * p[..., 0] + d * p[..., 1],
                                 e * p[..., 0] + p[..., 1]], dim=-1)
    proj = proj + cam.principal + 0.5
    valid = ((theta < cam.max_angle)
             & _within_resolution(cam.resolution, tolerance, proj))
    return proj, valid


def project_point(cam: CameraModel, p: torch.Tensor, tolerance=0.0):
    """Camera-space points [..., 3] -> (pixel uv [..., 2], valid [...])."""
    if cam.model_type == int(CameraModelType.OPENCV_PINHOLE):
        return _project_opencv_pinhole(cam, p, tolerance)
    if cam.model_type == int(CameraModelType.OPENCV_FISHEYE):
        return _project_opencv_fisheye(cam, p, tolerance)
    if cam.model_type == int(CameraModelType.FTHETA):
        return _project_ftheta(cam, p, tolerance)
    raise ValueError(f"unknown camera model {cam.model_type}")


# ---------------------------------------------------------------------------
# rolling shutter
# ---------------------------------------------------------------------------

def relative_shutter_time(cam: CameraModel, uv: torch.Tensor) -> torch.Tensor:
    """cameraProjections.cuh:50-65; 0.5 for a global shutter."""
    w, h = cam.resolution
    st = cam.shutter_type
    if st == int(ShutterType.ROLLING_TOP_TO_BOTTOM):
        return torch.floor(uv[..., 1]) / (h - 1.0)
    if st == int(ShutterType.ROLLING_LEFT_TO_RIGHT):
        return torch.floor(uv[..., 0]) / (w - 1.0)
    if st == int(ShutterType.ROLLING_BOTTOM_TO_TOP):
        return (h - torch.ceil(uv[..., 1])) / (h - 1.0)
    if st == int(ShutterType.ROLLING_RIGHT_TO_LEFT):
        return (w - torch.ceil(uv[..., 0])) / (w - 1.0)
    return torch.full(uv.shape[:-1], 0.5, dtype=uv.dtype, device=uv.device)


def world_to_camera(cam: CameraModel, p_world: torch.Tensor,
                    t: Optional[torch.Tensor] = None,
                    q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """World points through the pose (t, q), the start pose by default."""
    t = cam.t_start if t is None else t
    q = cam.q_start if q is None else q
    return torch.einsum("ij,...j->...i", quat_to_rotmat(q), p_world) + t


def project_point_with_shutter(cam: CameraModel, p_world: torch.Tensor,
                               tolerance=0.0, n_iterations: int = 5):
    """World point -> (pixel, valid) with rolling-shutter refinement
    (cameraProjections.cuh:218-257): seed with the start-pose
    projection (the end pose where that fails), then ``n_iterations``
    fixed-point steps through the pose interpolated at the seed's
    shutter time. Invalid when both seeds fail. A global shutter is one
    projection through the start pose."""
    proj0, valid0 = project_point(cam, world_to_camera(cam, p_world),
                                  tolerance)
    if cam.shutter_type == int(ShutterType.GLOBAL):
        return proj0, valid0
    proj_end, valid_end = project_point(
        cam, world_to_camera(cam, p_world, cam.t_end, cam.q_end), tolerance)
    proj = torch.where(valid0[..., None], proj0, proj_end)
    seeded = valid0 | valid_end
    valid = seeded
    for _ in range(n_iterations):
        # floor() has a zero derivative: the shutter time carries no
        # gradient, in JAX as here
        alpha = relative_shutter_time(cam, proj.detach())[..., None]
        q = quat_slerp(cam.q_start, cam.q_end, alpha)
        t = cam.t_start * (1.0 - alpha) + cam.t_end * alpha
        p_cam = torch.einsum("...ij,...j->...i", quat_to_rotmat(q),
                             p_world) + t
        proj, valid = project_point(cam, p_cam, tolerance)
    return proj, valid & seeded


# ---------------------------------------------------------------------------
# ray generation (camera-space rays)
# ---------------------------------------------------------------------------

def pinhole_camera_rays(width: int, height: int, fx, fy, cx=None, cy=None,
                        device="cpu"):
    """Camera-space ray directions at pixel centers.

    Returns (origins [H,W,3] zeros, unit dirs [H,W,3]).
    """
    if cx is None:
        cx = 0.5 * width
    if cy is None:
        cy = 0.5 * height
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    xs = (x + 0.5 - cx) / fx
    ys = (y + 0.5 - cy) / fy
    dirs = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True))
    return torch.zeros_like(dirs), dirs


def fisheye_camera_rays(width: int, height: int, focal, principal, radial4,
                        max_angle, newton_iters: int = 10, device=None):
    """Camera-space rays of the OpenCV fisheye model: per pixel center,
    r(theta) = theta (1 + sum_i k_i theta^(2i+2)) inverted by Newton
    steps from theta = clip(r, 0, max_angle) (ops/cameras.py:363-389).
    Pixels past the image circle keep the clamped angle. Returns (origins
    [H,W,3] zeros, unit dirs [H,W,3])."""
    focal = torch.as_tensor(focal, dtype=torch.float32, device=device)
    dev = focal.device
    principal = torch.as_tensor(principal, dtype=torch.float32, device=dev)
    k = torch.as_tensor(radial4, dtype=torch.float32, device=dev)
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    u = (x - principal[0]) / focal[0]
    v = (y - principal[1]) / focal[1]
    r = torch.sqrt(u * u + v * v)
    theta = torch.clamp(r, min=0.0, max=float(max_angle))
    for _ in range(newton_iters):
        t2 = theta * theta
        poly = 1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3])))
        f = theta * poly - r
        dpoly = k[0] + t2 * (2 * k[1] + t2 * (3 * k[2] + t2 * 4 * k[3]))
        df = poly + theta * (2.0 * theta * dpoly)
        theta = theta - f / torch.clamp(df, min=1e-9)
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    scale = torch.where(r > 1e-9, sin_t / torch.clamp(r, min=1e-9),
                        torch.ones_like(r))
    dirs = torch.stack([u * scale, v * scale, cos_t], dim=-1)
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True))
    return torch.zeros_like(dirs), dirs


def rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w,x,y,z) unit quaternion (Shepperd's method)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s,
             (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(r)))
        if i == 0:
            s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
            q = [(r[2, 1] - r[1, 2]) / s, 0.25 * s,
                 (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s]
        elif i == 1:
            s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
            q = [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s,
                 0.25 * s, (r[1, 2] + r[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
            q = [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
                 (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def world_to_camera_pose(c2w) -> tuple:
    """(t, q) float32 of the world->camera pose of a camera-to-world
    matrix."""
    c2w = np.asarray(c2w, np.float64)
    r_wc = c2w[:3, :3].T
    return ((-r_wc @ c2w[:3, 3]).astype(np.float32),
            rotmat_to_quat(r_wc).astype(np.float32))


def orbit_camera(azimuth: float, elevation: float, distance: float,
                 center=(0.0, 0.0, 4.0), resolution=(512, 512),
                 device="cpu") -> CameraModel:
    """Pinhole camera orbiting ``center`` (right-down-front convention;
    port of threedgrut_tpu/playground/web_gui.py:orbit_camera)."""
    c = np.asarray(center, np.float64)
    eye = c + distance * np.asarray([
        math.cos(elevation) * math.sin(azimuth),
        -math.sin(elevation),
        -math.cos(elevation) * math.cos(azimuth)])
    fwd = c - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray([0.0, -1.0, 0.0]))
    if np.linalg.norm(right) < 1e-6:
        right = np.asarray([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r_wc = np.stack([right, down, fwd], axis=1).T
    t_wc = -r_wc @ eye
    w, h = resolution
    return make_pinhole(resolution, (0.9 * w, 0.9 * w), (w / 2, h / 2),
                        t=t_wc.astype(np.float32),
                        q=rotmat_to_quat(r_wc).astype(np.float32),
                        device=device)
