"""Kernel P's and P_b's dispatch and their plain versions on the CPU
(``threedgrut_tpu_torch/ops/cuda/project.py``).

``project_view`` runs its plain version on CPU tensors; the plain version
is the composition the port rendered with before kernel P, and stays the
CPU's autograd path. These tests hold it to that composition bit for bit,
hold P_b's plain version (``project_view_backward_plain``) and
``ProjectFunction`` to the composition's autograd, hold
``prepare_view``'s choice between the kernel and the composition, and
hold the wrapper's launch arguments to ``csrc/project.cu``'s interface.
The kernels themselves run on the card only (tests/test_torch_gpu.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from threedgrut_tpu_torch.models.gaussians import (PARAM_NAMES,
                                                   GaussianModelConfig)
from threedgrut_tpu_torch.ops import ut as ut_ops
from threedgrut_tpu_torch.ops.cameras import (CameraModelType, ShutterType,
                                              _within_resolution)
from threedgrut_tpu_torch.ops.cuda import _wrappers, launch_counts
from threedgrut_tpu_torch.ops.cuda import project as P
from threedgrut_tpu_torch.ops.sh import eval_sh_radiance
from threedgrut_tpu_torch.render import gut
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.synthetic import nht_cloud
from torch_port_utils import (PROJECTION_CAMERAS, as_float64,
                              projection_camera, projection_cloud)

CSRC = (Path(__file__).resolve().parents[1] / "threedgrut_tpu_torch" / "csrc"
        / "project.cu").read_text()


def _same(a, b):
    """Bit for bit, NaN where NaN (the records of rows whose scale
    underflows to 0)."""
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.all((a == b) | (torch.isnan(a) & torch.isnan(b))))


def _composition(cam, cfg, model, sh_degree, shared):
    """What render/gut.py:prepare_view composed before kernel P."""
    proj = ut_ops.unscented_projection(
        cam, cfg, model.positions, model.rotation, model.get_scale(),
        model.get_density()[:, 0], model.active_mask())
    feats = torch.clamp(eval_sh_radiance(model.sh_coeffs(), proj.view_dir,
                                         sh_degree), min=0.0)
    table = gut.particle_table(
        model, ut_ops.sensor_position(cam) if shared else None, feats)
    lo, hi = gut._scene_aabb(model)
    return proj, table, lo, hi


@pytest.mark.parametrize("shutter", ["global", "rolling"])
@pytest.mark.parametrize("camera", ["pinhole", "fisheye"])
def test_plain_equals_the_composition(camera, shutter):
    """project_view on CPU tensors (its plain version) and prepare_view
    give the old composition's projection, table, AABB and t-ranges bit
    for bit, in the shared-origin and the general records."""
    kind = camera if shutter == "global" else f"{camera}_rolling"
    cam = projection_camera(kind)
    model = projection_cloud(1200)
    cfg = ut_ops.UTConfig()
    for shared in ([False, True] if shutter == "global" else [False]):
        with torch.no_grad():
            got = P.project_view(cam, cfg, model, 3, shared)
            proj, table, lo, hi = _composition(cam, cfg, model, 3, shared)
        for name, a, b in zip(ut_ops.Projection._fields, got.proj, proj):
            assert _same(a, b), name
        assert _same(got.table, table)
        assert torch.equal(got.aabb_lo, lo) and torch.equal(got.aabb_hi, hi)
    with torch.no_grad():
        v = gut.prepare_view(cam, cfg, RasterConfig(), model, 3)
    assert _same(v.table, table)   # the last, the camera's own mode
    ray_o, ray_d = gut.camera_rays_world(cam)
    tmin, tmax = gut._ray_aabb(ray_o, ray_d, lo, hi)
    assert torch.equal(v.tmin, tmin) and torch.equal(v.tmax, tmax)
    assert (v.ray_o is None) == (shutter == "global")


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_plain_takes_the_active_degree(degree):
    """Below the model's degree the radiance reads only the active
    coefficients, as eval_sh_radiance does."""
    cam = projection_camera("pinhole")
    model = projection_cloud(600)
    with torch.no_grad():
        got = P.project_view(cam, ut_ops.UTConfig(), model, degree, True)
        _, table, _, _ = _composition(cam, ut_ops.UTConfig(), model, degree,
                                      True)
        full = P.project_view(cam, ut_ops.UTConfig(), model, 3, True)
    assert _same(got.table, table)
    assert not _same(got.table[:, 13:], full.table[:, 13:])


def test_prepare_view_under_grad_keeps_autograd():
    """With a gradient the CPU's table comes from the composition: it
    requires grad, reaches every parameter, and equals the table without
    one."""
    cam = projection_camera("pinhole")
    model = projection_cloud(800)
    cfg, rc = ut_ops.UTConfig(), RasterConfig()
    v = gut.prepare_view(cam, cfg, rc, model, 3)
    assert v.table.requires_grad and v.proj.view_dir is not None
    # rows 0-99 (none of them degenerate: 0 x inf makes NaN elsewhere)
    v.table[:100].sum().backward()
    for name, p in model.params().items():
        g = p.grad[:100]
        assert bool(torch.isfinite(g).all() & (g.abs().sum() > 0)), name
    with torch.no_grad():
        w = gut.prepare_view(cam, cfg, rc, model, 3)
    assert not w.table.requires_grad
    assert _same(w.table, v.table.detach())
    assert torch.equal(w.proj.center, v.proj.center.detach())


# prepare_view's path by what its inputs show: kernel P's wrapper for an
# SH model whether a gradient can flow or not (under one, P_b is its
# backward), the composition for NHT
DISPATCH = {
    "no_grad": ("sh", "no_grad", True, "kernel"),
    "inference_mode": ("sh", "inference_mode", True, "kernel"),
    "frozen": ("sh", "grad", False, "kernel"),
    "grad": ("sh", "grad", True, "kernel"),
    "nht_no_grad": ("nht", "no_grad", True, "composition"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_prepare_view_dispatch(case, monkeypatch):
    features, mode, requires_grad, want = DISPATCH[case]
    calls = []

    def record(name, fn):
        def inner(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return inner

    monkeypatch.setattr(gut, "project_view",
                        record("kernel", P.project_view))
    monkeypatch.setattr(gut, "project_view_plain",
                        record("composition", P.project_view_plain))
    cam = projection_camera("pinhole")
    model = (projection_cloud(500) if features == "sh"
             else nht_cloud(500, dim=8))
    for p in model.parameters():
        p.requires_grad_(requires_grad)
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "grad": torch.enable_grad}[mode]
    with ctx():
        v = gut.prepare_view(cam, ut_ops.UTConfig(), RasterConfig(), model,
                             0 if features == "nht" else 3)
    assert calls == [want]
    assert v.table.requires_grad == (requires_grad and mode == "grad")


def test_project_view_refuses_what_the_kernel_lacks():
    """A degree past the model's and NHT features raise; a gradient no
    longer does (P_b is P's backward)."""
    cam = projection_camera("pinhole")
    model = projection_cloud(300)
    assert P.project_view(cam, ut_ops.UTConfig(), model, 3,
                          True).table.requires_grad
    with torch.no_grad():
        with pytest.raises(ValueError, match="sh_degree 4"):
            P.project_view(cam, ut_ops.UTConfig(), model, 4, True)
        with pytest.raises(NotImplementedError, match="NHT"):
            P.project_view(cam, ut_ops.UTConfig(), nht_cloud(300, dim=8), 0,
                           False)


def _counters():
    return (P.project_view.launches, P.project_view.launches_general,
            P.project_view.launches_backward)


def test_cpu_render_launches_nothing():
    """On the CPU the wrapper runs the plain version and counts nothing,
    with a gradient or without; the counters are among launch_counts'
    wrappers."""
    assert P.project_view in _wrappers()
    before = _counters()
    with torch.no_grad():
        gut.render_gut(projection_camera("pinhole"), ut_ops.UTConfig(),
                       RasterConfig(), projection_cloud(300), 3)
    gut.render_gut(projection_camera("pinhole"), ut_ops.UTConfig(),
                   RasterConfig(), projection_cloud(300), 3)[
                       "pred_features"].sum().backward()
    assert _counters() == before
    assert not any(k.startswith("project_view") for k in launch_counts())


def _cu_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC).group(1))


def test_launch_arguments_match_the_kernel_interface():
    """The wrapper's arrays against csrc/project.cu: their sizes, the
    order and sizes of the camera's fields, the Params fields, and the
    enums of the camera models, shutters and activations."""
    assert len(PARAM_NAMES) == _cu_int("kNumInputs")
    # the Projection's fields but view_dir, the table and the AABB
    assert len(ut_ops.Projection._fields) - 1 + 2 == _cu_int("kNumOutputs")
    assert (P.NUM_INTS, P.NUM_FLOATS) == (_cu_int("kNumInts"),
                                          _cu_int("kNumFloats"))
    assert len(P.CAMERA_FIELDS) == _cu_int("kNumCamFields")
    sizes = [s for _, s in P.CAMERA_FIELDS]
    assert sum(sizes) == _cu_int("kCamFloats")
    counts = re.search(r"count\[kNumCamFields\] = \{([\d,\s]+)\}", CSRC)
    assert [int(x) for x in counts.group(1).split(",")] == sizes
    cam = projection_camera("ftheta1_rolling")
    for name, size in P.CAMERA_FIELDS:
        assert getattr(cam, name).numel() == size, name
    params = re.search(r"struct Params \{(.*?)\};", CSRC, re.S).group(1)
    ints = re.search(r"((?:\s*int [^;]+;)+)", params).group(1)
    floats = params[params.index("float"):]
    int_names = re.findall(r"(\w+)[,;]", ints)
    float_names = re.findall(r"(\w+)[,;]", floats)
    assert len(int_names) == P.NUM_INTS and len(float_names) == P.NUM_FLOATS
    model = projection_cloud(300)
    got_i, got_f = P.launch_params(cam, ut_ops.UTConfig(), model, 2, False)
    assert len(got_i) == P.NUM_INTS and len(got_f) == P.NUM_FLOATS
    by_name = dict(zip(int_names, got_i))
    assert by_name["n"] == model.capacity
    assert by_name["n_active"] == model.n_active
    assert by_name["sh_degree"] == 2 and by_name["sh_stride"] == 45
    assert by_name["model"] == int(CameraModelType.FTHETA)
    assert by_name["shutter"] == int(ShutterType.ROLLING_RIGHT_TO_LEFT)
    assert by_name["ftheta_ref"] == 1 and by_name["shared"] == 0
    assert (by_name["width"], by_name["height"]) == cam.resolution
    enums = {"Model": {"kPinhole": 0, "kFisheye": 1, "kFTheta": 2},
             "Shutter": {"kGlobal": 0, "kTopToBottom": 1, "kLeftToRight": 2,
                         "kBottomToTop": 3, "kRightToLeft": 4},
             "Act": {"kNone": 0, "kExp": 1, "kSigmoid": 2}}
    for enum, want in enums.items():
        body = re.search(rf"enum {enum} \{{(.*?)\}};", CSRC, re.S).group(1)
        assert {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)} \
            == want
    assert [int(m) for m in CameraModelType] == [0, 1, 2]
    assert [int(s) for s in ShutterType] == [0, 1, 2, 3, 4]
    assert P.ACTIVATION_IDS == {"none": 0, "exp": 1, "sigmoid": 2}


def test_margin_bounds_are_the_plain_tests():
    """The kernel's margin bounds (launch_params' floats 4-7) decide as
    _within_resolution does, on points straddling each bound by an ulp."""
    cam = projection_camera("pinhole", resolution=(1920, 1080))
    cfg = ut_ops.UTConfig()
    _, floats = P.launch_params(cam, cfg, projection_cloud(300), 3, True)
    lo_x, lo_y, hi_x, hi_y = floats[4:8]
    pts = []
    for x in (lo_x, hi_x):
        for d in (-1, 0, 1):
            pts.append([np.nextafter(np.float32(x), np.float32(d * np.inf))
                        if d else np.float32(x), 500.0])
    for y in (lo_y, hi_y):
        for d in (-1, 0, 1):
            pts.append([700.0, np.nextafter(np.float32(y),
                                            np.float32(d * np.inf))
                        if d else np.float32(y)])
    p = torch.tensor(np.asarray(pts, np.float32))
    got = ((p[:, 0] > np.float32(lo_x)) & (p[:, 1] > np.float32(lo_y))
           & (p[:, 0] < np.float32(hi_x)) & (p[:, 1] < np.float32(hi_y)))
    assert torch.equal(got, _within_resolution(
        cam.resolution, cfg.image_margin_factor, p))


@pytest.mark.parametrize("kind", PROJECTION_CAMERAS)
def test_every_camera_of_the_card_cases_projects(kind):
    """Each camera of the card's cases projects some rows and misses
    others (edges, the rows behind it), and every kind of edge row of
    projection_cloud is invalid."""
    cam = projection_camera(kind)
    model = projection_cloud(1000)
    with torch.no_grad():
        pv = P.project_view(cam, ut_ops.UTConfig(), model, 3, False)
    valid = pv.proj.valid
    assert 0.3 * model.n_active < int(valid.sum()) < model.n_active
    assert not bool(valid[0:40].any())           # behind the camera
    assert not bool(valid[80:140].any())         # faint; scale 0
    assert not bool(valid[model.n_active:].any())
    dead = ~valid
    assert bool((pv.proj.extent[dead] == 0).all())
    assert bool(torch.isinf(pv.proj.depth[dead]).all())


def test_cloud_activations_keep_the_activated_values():
    """projection_cloud's activation variants (the card's cases) store
    raw values whose activations are the default model's."""
    base = projection_cloud(300)
    other = projection_cloud(300, config=GaussianModelConfig(
        scale_activation="none", density_activation="exp"))
    with torch.no_grad():
        assert torch.allclose(base.get_scale(), other.get_scale(),
                              rtol=1e-6, atol=0)
        assert torch.allclose(base.get_density(), other.get_density(),
                              rtol=1e-5, atol=0)


# the (scale, density) activations of P_b's cases: the default model's,
# projection_cloud's other variant, and the third of each
BACKWARD_ACTIVATIONS = {"exp_sigmoid": ("exp", "sigmoid"),
                        "none_exp": ("none", "exp"),
                        "sigmoid_none": ("sigmoid", "none")}
# rows of backward_cloud whose radiance sits exactly at the clamp (0), and
# rows whose cotangent is 0 though they are active
AT_CLAMP = slice(200, 210)
ZERO_ROWS = slice(210, 230)


def _at_clamp_albedo():
    """The float64 albedo a with SH_C0 a + 0.5 == 0 exactly."""
    from threedgrut_tpu_torch.ops.sh import SH_C0

    a = -0.5 / SH_C0
    for _ in range(8):
        if SH_C0 * a == -0.5:
            return a
        a = float(np.nextafter(a, -np.inf if SH_C0 * a > -0.5 else np.inf))
    raise AssertionError("no albedo puts the radiance at the clamp")


def backward_cloud(acts, n=600):
    """projection_cloud's rows in float64 on the given activations, with
    AT_CLAMP rows whose degree-0 radiance + 0.5 is exactly 0 (no specular
    coefficients), and a seeded cotangent of the table [C, 16]: normal
    everywhere (past n_active too) but the ZERO_ROWS."""
    scale_act, density_act = acts
    model = projection_cloud(n, config=GaussianModelConfig(
        scale_activation=scale_act, density_activation=density_act))
    model = model.to(torch.float64)
    with torch.no_grad():
        model.features_albedo[AT_CLAMP] = _at_clamp_albedo()
        model.features_specular[AT_CLAMP] = 0.0
    rng = np.random.default_rng(11)
    d_table = torch.tensor(rng.normal(size=(model.capacity, 16)))
    d_table[ZERO_ROWS] = 0.0
    return model, d_table


def _composition_grads(cam, model, d_table, degree, shared):
    """Autograd's gradients of <table, d_table> through
    project_view_plain."""
    for p in model.parameters():
        p.grad = None
        p.requires_grad_(True)
    pv = P.project_view_plain(cam, ut_ops.UTConfig(), model, degree, shared)
    pv.table.backward(d_table)
    return [getattr(model, k).grad.clone() for k in PARAM_NAMES]


def _close_where_finite(got, want, name):
    """got equals want to float64 rounding on the rows where want is
    finite (0 x inf makes NaN on the rows whose scale is 0)."""
    rows = torch.isfinite(want).all(dim=1)
    assert int(rows.sum()) >= 0.9 * rows.numel(), name
    torch.testing.assert_close(got[rows], want[rows], rtol=1e-10,
                               atol=1e-12 * float(want[rows].abs().max()),
                               msg=name)


@pytest.mark.parametrize("acts", sorted(BACKWARD_ACTIVATIONS))
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_backward_plain_equals_autograd(degree, shared, acts):
    """project_view_backward_plain (P_b's plain version) against autograd
    through the composition in float64, on a model of SH degree 3 at each
    active degree, in the shared-origin and the general records, for each
    pair of activations: equal to float64 rounding where the composition's
    gradient is finite; rows past n_active get their chain rule too,
    rows with a zero cotangent exact zeros, the coefficients past the
    active degree exact zeros, and the rows at the clamp their gradient
    (torch.clamp passes it at 0)."""
    cam = projection_camera("pinhole" if shared else "fisheye")
    cam64 = as_float64(projection_cloud(300), cam)[1]
    model, d_table = backward_cloud(BACKWARD_ACTIVATIONS[acts])
    want = _composition_grads(cam64, model, d_table, degree, shared)
    params = [getattr(model, k).detach() for k in PARAM_NAMES]
    got = P.project_view_backward_plain(d_table, params, cam64, model.config,
                                        degree, shared)
    for name, g, w, p in zip(PARAM_NAMES, got, want, params):
        assert g.shape == p.shape and g.dtype == torch.float64, name
        _close_where_finite(g, w, name)
        assert bool((g[ZERO_ROWS] == 0).all()), name
        if name != "features_specular" or degree > 0:
            assert bool(g[model.n_active:].abs().sum() > 0), name
    nb = (degree + 1) ** 2
    assert bool((got[5][:, 3 * (nb - 1):] == 0).all())
    albedo = got[4][AT_CLAMP]
    assert bool((albedo != 0).all()) and torch.equal(albedo,
                                                     want[4][AT_CLAMP])


@pytest.mark.parametrize("shared", [True, False])
def test_function_on_cpu_gives_the_composition(shared):
    """ProjectFunction on CPU tensors (the plain forward and backward)
    gives the composition's outputs and gradients; a frozen parameter
    gets None."""
    cam = projection_camera("pinhole")
    cam64 = as_float64(projection_cloud(300), cam)[1]
    model, d_table = backward_cloud(BACKWARD_ACTIVATIONS["exp_sigmoid"])
    want = _composition_grads(cam64, model, d_table, 3, shared)
    for p in model.parameters():
        p.grad = None
    model.rotation.requires_grad_(False)
    cfg = ut_ops.UTConfig()
    params = [getattr(model, k) for k in PARAM_NAMES]
    outs = P.ProjectFunction.apply(cam64, cfg, model, 3, shared, *params)
    with torch.no_grad():
        ref = P.project_view_plain(cam64, cfg, model, 3, shared)
    assert _same(outs[6], ref.table) and outs[6].requires_grad
    assert not any(o.requires_grad for k, o in enumerate(outs) if k != 6)
    assert torch.equal(outs[7], torch.stack([ref.aabb_lo, ref.aabb_hi]))
    outs[6].backward(d_table)
    assert model.rotation.grad is None
    for name, w in zip(PARAM_NAMES, want):
        if name != "rotation":
            _close_where_finite(getattr(model, name).grad, w, name)


def test_backward_launch_arguments_match_the_kernel_interface():
    """P_b's launch arguments against csrc/project.cu: the pointers (the
    six inputs, the cotangent, the six gradients, the camera's t_start
    and q_start) and BwdParams' fields by name."""
    assert _cu_int("kNumBwdPtrs") == 2 * len(PARAM_NAMES) + 3
    assert P.NUM_BWD_INTS == _cu_int("kNumBwdInts")
    body = re.search(r"struct BwdParams \{(.*?)\};", CSRC, re.S).group(1)
    names = re.findall(r"(\w+)[,;]", body)
    model = projection_cloud(300, config=GaussianModelConfig(
        scale_activation="none", density_activation="exp"))
    got = P.backward_params(model.capacity, model.config, 2, 45, True)
    assert len(names) == len(got) == P.NUM_BWD_INTS
    assert dict(zip(names, got)) == {
        "n": model.capacity, "sh_degree": 2, "sh_stride": 45,
        "scale_act": 0, "density_act": 1, "shared": 1}
    assert re.search(r"PROJECT_BWD_KERNELS\(X\) X\(0\) X\(1\) X\(2\) X\(3\)",
                     CSRC)
