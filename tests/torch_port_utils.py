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


# kernel P's cameras (ops/cuda/project.py): each camera model, with a
# global shutter and with each of the four rolling shutters once
PROJECTION_CAMERAS = ("pinhole", "pinhole_rolling", "pinhole_rolling_lr",
                      "fisheye", "fisheye_rolling", "ftheta0",
                      "ftheta1_rolling")


def _unit(q):
    q = np.asarray(q, np.float64)
    return (q / np.linalg.norm(q)).astype(np.float32)


def projection_camera(kind, device="cpu", resolution=(160, 120)):
    """A camera of PROJECTION_CAMERAS: a pinhole with non-zero radial,
    tangential and thin-prism terms, an OpenCV fisheye, or an FTheta lens
    whose reference polynomial is the forward one (``ftheta0``) or the
    inverse one, Newton-inverted (``ftheta1``); ``_rolling`` gives it a
    rolling shutter between two poses (top to bottom, left to right with
    ``_lr``, bottom to top for the fisheye, right to left for FTheta)."""
    from threedgrut_tpu_torch.ops.cameras import (ShutterType, make_fisheye,
                                                  make_ftheta, make_pinhole)

    w, h = resolution
    pose = dict(t=[0.1, -0.05, 0.2], q=_unit([1.0, 0.02, -0.03, 0.01]))
    if "rolling" in kind:
        shutter = {"pinhole": ShutterType.ROLLING_TOP_TO_BOTTOM,
                   "fisheye": ShutterType.ROLLING_BOTTOM_TO_TOP,
                   "ftheta1": ShutterType.ROLLING_RIGHT_TO_LEFT}[
                       kind.split("_")[0]]
        if kind.endswith("_lr"):
            shutter = ShutterType.ROLLING_LEFT_TO_RIGHT
        pose.update(t_end=[0.16, -0.02, 0.18],
                    q_end=_unit([1.0, 0.05, -0.01, 0.04]),
                    shutter_type=int(shutter))
    if kind.startswith("pinhole"):
        return make_pinhole(resolution, (0.6 * w, 0.62 * w), (w / 2, h / 2),
                            radial=[0.05, -0.01, 0.002, 0.01, -0.003, 0.001],
                            tangential=[0.002, -0.001],
                            thin_prism=[0.001, -0.0005, 0.0008, 0.0002],
                            device=device, **pose)
    if kind.startswith("fisheye"):
        return make_fisheye(resolution, (0.45 * w, 0.45 * w), (w / 2, h / 2),
                            [0.05, -0.01, 0.002, -0.0003], 1.4,
                            device=device, **pose)
    # an automotive lens (tests/test_cameras_shutter.py) scaled to w
    fwd = np.array([0.0, 540.0, 8.0, -22.0, 14.0, -3.0]) * (w / 1920.0)
    theta = np.linspace(0.0, 1.6, 512)
    dist = sum(c * theta ** i for i, c in enumerate(fwd))
    inv = np.polyfit(dist, theta, 5)[::-1]
    return make_ftheta(resolution, (w / 2, h / 2), fwd.astype(np.float32),
                       inv.astype(np.float32), int(kind[6]),
                       (1.0, 0.001, -0.002), 1.5, device=device, **pose)


def projection_cloud(n=3000, seed=3, device="cpu", config=None,
                     n_dead=100):
    """``synthetic.bench_cloud``'s rows (SH degree 3) with the rows kernel
    P must treat as the plain projection does: the last ``n_dead`` live
    rows past ``n_active`` (and the capacity's padding), rows behind the
    camera and under ``min_sensor_z``, faint rows under the opacity
    threshold, rows whose scale underflows to 0 in fp32 (a degenerate
    covariance without dilation) and rows wide enough to cross the
    image's edges. ``config`` may change the activations: the raw values
    are converted, so the activated ones stay the same."""
    from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                       GaussianModelConfig)
    from threedgrut_tpu_torch.synthetic import bench_cloud

    config = config or GaussianModelConfig()
    base = bench_cloud(n, seed=seed)
    a = {k: getattr(base, k).detach().numpy().copy()
         for k in ("positions", "rotation", "scale", "density",
                   "features_albedo", "features_specular")}
    rng = np.random.default_rng(seed + 1)
    a["positions"][0:40, 2] = -rng.uniform(0.5, 3.0, 40)
    a["positions"][40:80, 2] = rng.uniform(0.01, 0.3, 40)
    a["density"][80:120] = -8.0
    a["scale"][120:140] = -200.0
    a["scale"][140:160] = np.log(rng.uniform(0.5, 1.5, (20, 3)))
    if config.scale_activation == "none":
        a["scale"] = np.exp(a["scale"]).astype(np.float32)
    if config.density_activation == "exp":
        a["density"] = -np.log1p(np.exp(-a["density"])).astype(np.float32)
    return GaussianModel.from_numpy(a, n_active=n - n_dead,
                                    n_active_features=3, config=config,
                                    device=device)


def as_float64(model, cam, device="cpu"):
    """Copies of ``model``'s parameters and ``cam``'s tensors in float64 on
    ``device``: the plain projection's reference for its fp32 rounding."""
    import copy
    import dataclasses

    m = copy.deepcopy(model).to(device)
    for k in ("positions", "rotation", "scale", "density", "features_albedo",
              "features_specular"):
        getattr(m, k).data = getattr(m, k).data.double()
    return m, dataclasses.replace(cam, **{
        k: getattr(cam, k).detach().to(device).double()
        for k in CAMERA_TENSORS})


PROJECTION_FIELDS = ("center", "conic", "opacity", "extent", "depth")


def _sigma_points(model, cfg):
    """The UT's 7 sigma points [N, 7, 3] (ops/ut.py:unscented_projection)."""
    from threedgrut_tpu_torch.ops.quaternion import (quat_normalize,
                                                     quat_to_rotmat)

    rot = quat_to_rotmat(quat_normalize(model.rotation))
    deltas = cfg.delta * (rot * model.get_scale()[:, None, :]).transpose(1, 2)
    p = model.positions[:, None, :]
    return torch.cat([p, p + deltas, p - deltas], dim=1)


def projection_near(cam64, cfg, m64, shared, band=1e-5, pixel_band=1e-3):
    """[N] bool: the rows whose validity or values sit within rounding of
    a decision of the projection, from the float64 plain version: a
    threshold moved by ``band`` (relative for the opacity, the image's
    margin, min_sensor_z and the FTheta or fisheye field of view) flips
    the row's validity; a sigma point's pinhole distortion factor lies
    within ``band`` of 0.8 or 1.2 (between the shutter's start and end
    poses), or its camera z within ``band`` of 0; or, under a rolling
    shutter, a sigma point's pixel lies within ``pixel_band`` of a row
    (column) boundary, where floor() switches the shutter time."""
    import dataclasses

    from threedgrut_tpu_torch.ops.cameras import (CameraModelType,
                                                  project_point_with_shutter,
                                                  world_to_camera)
    from threedgrut_tpu_torch.ops.cuda.project import project_view_plain

    def valid(sign):
        c = dataclasses.replace(
            cfg, alpha_threshold=cfg.alpha_threshold * (1 - sign * band),
            min_sensor_z=cfg.min_sensor_z - sign * band,
            image_margin_factor=cfg.image_margin_factor + sign * band)
        cam = dataclasses.replace(
            cam64, max_angle=cam64.max_angle * (1 + sign * band))
        return project_view_plain(cam, c, m64, 0, shared).proj.valid

    with torch.no_grad():
        near = valid(1) != valid(-1)
        pts = _sigma_points(m64, cfg)
        if cam64.model_type == int(CameraModelType.OPENCV_PINHOLE):
            icd, z = [], []
            for t, q in ((cam64.t_start, cam64.q_start),
                         (cam64.t_end, cam64.q_end)):
                pc = world_to_camera(cam64, pts, t, q)
                uv = pc[..., :2] / pc[..., 2:3]
                r2 = (uv * uv).sum(-1)
                k = cam64.radial
                icd.append((1 + r2 * (k[0] + r2 * (k[1] + r2 * k[2])))
                           / (1 + r2 * (k[3] + r2 * (k[4] + r2 * k[5]))))
                z.append(pc[..., 2])
            lo, hi = torch.minimum(*icd) - band, torch.maximum(*icd) + band
            for b in (0.8, 1.2):
                near |= ((lo < b) & (b < hi)).any(dim=1)
            near |= ((torch.minimum(*z) < band)
                     & (torch.maximum(*z) > -band)).any(dim=1)
        if cam64.shutter_type != 0:
            proj, _ = project_point_with_shutter(
                cam64, pts, cfg.image_margin_factor,
                cfg.n_rolling_shutter_iterations)
            x = proj[..., 1 if cam64.shutter_type in (1, 3) else 0]
            near |= ((x - torch.round(x)).abs() < pixel_band).any(dim=1)
    return near


def _splat_outputs(proj, opacities, cfg):
    """conic [N, 3], opacity [N] and extent [N, 2] of the sigma points'
    pixels [N, 7, 2], by ops/ut.py:unscented_projection's expressions
    (extent before the validity mask)."""
    lam = cfg.alpha * cfg.alpha * (3 + cfg.kappa) - 3
    w0, wi = lam / (3 + lam), 1.0 / (2.0 * (3 + lam))
    w0_cov = w0 + (1.0 - cfg.alpha * cfg.alpha + cfg.beta)
    center = w0 * proj[:, 0, :] + wi * torch.sum(proj[:, 1:, :], dim=1)
    c = proj - center[:, None, :]
    wts = torch.tensor([w0_cov] + [wi] * 6, dtype=proj.dtype,
                       device=proj.device)
    xx = torch.sum(wts * c[..., 0] * c[..., 0], dim=1)
    xy = torch.sum(wts * c[..., 0] * c[..., 1], dim=1)
    yy = torch.sum(wts * c[..., 1] * c[..., 1], dim=1)
    dxx, dyy = xx + cfg.covariance_dilation, yy + cfg.covariance_dilation
    det = dxx * dyy - xy * xy
    safe = torch.where(det == 0.0, torch.ones_like(det), det)
    conic = torch.stack([dyy, -xy, dxx], dim=-1) / safe[:, None]
    opacity = opacities
    if cfg.mip_splatting_scaling:
        opacity = opacities * torch.sqrt(torch.clamp(
            (xx * yy - xy * xy) / safe, min=2.5e-5))
    power = torch.log(torch.clamp(opacity, min=1e-30) / cfg.alpha_threshold)
    factor = (torch.clamp(torch.sqrt(2.0 * torch.clamp(power, min=0.0)),
                          max=3.33) if cfg.tight_opacity_bounding
              else torch.full_like(power, 3.33))
    mid = 0.5 * (dxx + dyy)
    radius = factor * torch.sqrt(mid + torch.sqrt(
        torch.clamp(mid * mid - det, min=0.01)))
    extent = torch.stack([radius, radius], dim=-1)
    if cfg.rect_bounding:
        extent = torch.minimum(factor[:, None] * torch.sqrt(
            torch.stack([dxx, dyy], dim=-1)), radius[:, None])
    return {"conic": conic, "opacity": opacity, "extent": extent}


def projection_sensitivity(cam64, cfg, m64, ulps=2):
    """{conic, opacity, extent}: the first-order worst-case change of each
    in float64 when every sigma point's pixel coordinate moves by ``ulps``
    fp32 ulps, sum_j |d out / d u_j| ulps ulp(u_j): how far two fp32
    evaluations of the same projection may drift apart, large where the
    covariance cancels (sub-pixel splats, most of all without dilation).
    An infinite or undefined derivative gives an infinite bound."""
    from threedgrut_tpu_torch.ops.cameras import project_point_with_shutter

    with torch.no_grad():
        proj, _ = project_point_with_shutter(
            cam64, _sigma_points(m64, cfg), cfg.image_margin_factor,
            cfg.n_rolling_shutter_iterations)
        dens = m64.get_density()[:, 0]
        step = ulps * 2.0 ** -23 * torch.clamp(proj.abs(), min=1.0)
    with torch.enable_grad():
        proj = proj.requires_grad_(True)
        outs = _splat_outputs(proj, dens, cfg)
        sens = {}
        for name, t in outs.items():
            if not t.requires_grad:   # opacity without mip scaling
                sens[name] = torch.zeros_like(t.detach())
                continue
            cols = t.reshape(t.shape[0], -1)
            per = []
            for c in range(cols.shape[1]):
                g, = torch.autograd.grad(cols[:, c].sum(), proj,
                                         retain_graph=True)
                per.append(torch.nan_to_num(
                    (g.abs() * step).sum(dim=(1, 2)), nan=float("inf")))
            sens[name] = torch.stack(per, dim=-1).reshape(t.shape).detach()
    return sens


def projection_errors(got, ref, ref64, near, sens, rtol=1e-5, slack=4.0):
    """Kernel P's outputs ``got`` (a ProjectedView) against the plain
    version's in fp32 (``ref``) and float64 (``ref64``), all moved to the
    CPU in float64, on the rows not ``near`` (projection_near). Per field
    (the Projection's, ``table``): the elements compared, the largest
    |got - ref| / (rtol |ref| + atol), and the count past the bound
    rtol |ref| + slack (|ref - ref64| + sens) + atol: the relative
    tolerance, widened where the plain's own fp32 value lies further from
    float64 or where rounding moves the value more (``sens``:
    projection_sensitivity's, for conic, opacity and extent). atol is
    1e-6 of the column's largest finite |ref64|. extent and depth are
    compared on the rows whose validity agrees. Where ``ref`` is not
    finite ``got`` must equal it (an inf of the same sign, or NaN),
    counted in ``nonfinite``. Also: ``flips`` (rows whose validity
    differs), those of them not near (``flips_far``) and ``near`` rows."""
    valid_g = got.proj.valid.cpu()
    valid_r = ref.proj.valid.cpu()
    keep = ~near.cpu()
    same_valid = keep & (valid_g == valid_r)
    out = {"flips": int((valid_g != valid_r).sum()),
           "flips_far": int(((valid_g != valid_r) & keep).sum()),
           "near": int(near.sum()), "rows": int(valid_r.numel())}
    pairs = [(f, getattr(got.proj, f), getattr(ref.proj, f),
              getattr(ref64.proj, f)) for f in PROJECTION_FIELDS]
    pairs.append(("table", got.table, ref.table, ref64.table))
    for name, g, r, r64 in pairs:
        rows = same_valid if name in ("extent", "depth") else keep
        shape = (int(rows.sum()), -1)
        g = g.detach().cpu().double()[rows].reshape(shape)
        r = r.detach().cpu().double()[rows].reshape(g.shape)
        r64 = r64.detach().cpu().double()[rows].reshape(g.shape)
        spread = torch.nan_to_num((r - r64).abs(), nan=float("inf"))
        if name in sens:
            spread = spread + sens[name].detach().cpu()[rows].reshape(
                g.shape)
        fin = torch.isfinite(r)
        bad_nonfinite = int((~fin & ~((g == r) | (torch.isnan(g)
                                                  & torch.isnan(r)))).sum())
        col = torch.where(torch.isfinite(r64), r64.abs(),
                          torch.zeros_like(r64)).amax(dim=0)
        atol = 1e-6 * col + 1e-30
        err = (g - r).abs()
        ratio = torch.where(fin, err / (rtol * r.abs() + atol),
                            torch.zeros_like(err))
        over = fin & ~(err <= rtol * r.abs() + slack * spread + atol)
        out[name] = {"n": int(fin.sum()),
                     "max_ratio": float(ratio.max()) if ratio.numel() else 0.0,
                     "over": int(over.sum()), "nonfinite": bad_nonfinite}
    return out


def projection_check(cam, cfg, model, degree, shared, flip_share=1e-4,
                     near_share=0.05):
    """Kernel P against its plain version on ``model``'s device, in fp32
    and in float64 (projection_errors, with projection_sensitivity's
    bound): no validity flip away from a decision, at most ``flip_share``
    of the rows flipped, at most ``near_share`` near a decision, every
    compared element within its bound, the same non-finite values, and
    the AABB bit for bit (min and max are exact). Raises AssertionError;
    returns the errors."""
    from threedgrut_tpu_torch.ops.cuda.project import (project_view,
                                                       project_view_plain)

    with torch.no_grad():
        got = project_view(cam, cfg, model, degree, shared)
        ref = project_view_plain(cam, cfg, model, degree, shared)
        m64, c64 = as_float64(model, cam, cam.device)
        ref64 = project_view_plain(c64, cfg, m64, degree, shared)
        near = projection_near(c64, cfg, m64, shared)
        sens = projection_sensitivity(c64, cfg, m64)
    errs = projection_errors(got, ref, ref64, near, sens)
    if got.proj.view_dir is not None or got.table.shape != ref.table.shape:
        raise AssertionError("kernel P: a view_dir or the table's shape")
    if not (torch.equal(got.aabb_lo, ref.aabb_lo)
            and torch.equal(got.aabb_hi, ref.aabb_hi)):
        raise AssertionError(f"kernel P: AABB {got.aabb_lo} {got.aabb_hi} "
                             f"against {ref.aabb_lo} {ref.aabb_hi}")
    fields = ("center", "conic", "opacity", "extent", "depth", "table")
    if (errs["flips_far"] or errs["flips"] > flip_share * errs["rows"]
            or errs["near"] > near_share * errs["rows"]
            or any(errs[k]["over"] or errs[k]["nonfinite"] for k in fields)):
        raise AssertionError(f"kernel P against its plain version: {errs}")
    return errs


def projection_backward_check(cam, model, degree, shared, seed=5,
                              rtol=1e-5, slack=4.0):
    """Kernel P_b (the backward of ``ProjectFunction``) against its plain
    version, ``project_view_backward_plain``, on ``model``'s device, in
    fp32 and in float64, for a seeded normal cotangent of the table that
    is 0, as the raster leaves it, past n_active and on every 7th row.
    Per parameter, on the rows whose fp32 plain gradient is finite, every
    element within rtol |ref| + slack |ref - ref64| + atol (atol 1e-6 of
    the column's largest |ref64| there): both run the same operations in
    the same order, built without FMA contraction, so they part only
    where an ulp of the sensor position (PyTorch's product against the
    kernel's) or of expf moves a value, which the plain's own distance
    from float64 bounds. Where the plain's gradient is not finite, the
    kernel's must not be either; rows with a zero cotangent and the
    coefficients past ``degree`` must be exact zeros; one launch. Raises
    AssertionError; returns the errors."""
    from threedgrut_tpu_torch.models.gaussians import PARAM_NAMES
    from threedgrut_tpu_torch.ops.cuda.project import (
        ProjectFunction, project_view, project_view_backward_plain)
    from threedgrut_tpu_torch.ops.ut import UTConfig

    dev = model.device
    rng = np.random.default_rng(seed)
    d_table = torch.tensor(rng.standard_normal(
        (model.capacity, 16)).astype(np.float32), device=dev)
    zero = torch.zeros(model.capacity, dtype=torch.bool, device=dev)
    zero[model.n_active:] = True
    zero[::7] = True
    d_table[zero] = 0.0
    params = [getattr(model, k) for k in PARAM_NAMES]
    before = project_view.launches_backward
    table = ProjectFunction.apply(cam, UTConfig(), model, degree, shared,
                                  *params)[6]
    got = torch.autograd.grad(table, params, d_table)
    launches = project_view.launches_backward - before
    with torch.no_grad():
        ref = project_view_backward_plain(d_table, params, cam,
                                          model.config, degree, shared)
        m64, c64 = as_float64(model, cam, dev)
        ref64 = project_view_backward_plain(
            d_table.double(), [getattr(m64, k) for k in PARAM_NAMES], c64,
            model.config, degree, shared)
    errs = {"launches": launches, "rows": model.capacity}
    nb = (degree + 1) ** 2
    for name, g, r, r64 in zip(PARAM_NAMES, got, ref, ref64):
        g, r, r64 = (t.detach().double() for t in (g, r, r64))
        rows = torch.isfinite(r).all(dim=1)
        col = r64[rows].abs().amax(dim=0) if bool(rows.any()) else \
            torch.zeros(r.shape[1], dtype=torch.float64, device=dev)
        atol = 1e-6 * col + 1e-30
        fin = torch.isfinite(r)
        err = torch.where(fin, (g - r).abs(), torch.zeros_like(r))
        bound = rtol * r.abs() + slack * (r - r64).abs() + atol
        over = fin & ~(err <= bound)
        ratio = torch.where(fin, err / (rtol * r.abs() + atol),
                            torch.zeros_like(err))
        errs[name] = {
            "max_ratio": float(ratio.max()), "over": int(over.sum()),
            "finite_rows": int(rows.sum()),
            "nonfinite": int((~fin & torch.isfinite(g)).sum()),
            "zero_rows_nonzero": int((g[zero] != 0).sum())}
    errs["past_degree_nonzero"] = int(
        (got[5][:, 3 * (nb - 1):] != 0).sum())
    if (launches != 1 or errs["past_degree_nonzero"]
            or any(errs[k]["over"] or errs[k]["nonfinite"]
                   or errs[k]["zero_rows_nonzero"] for k in PARAM_NAMES)):
        raise AssertionError(f"kernel P_b against its plain version: {errs}")
    return errs
