"""Kernel P's dispatch and its plain version on the CPU
(``threedgrut_tpu_torch/ops/cuda/project.py``).

``project_view`` runs its plain version on CPU tensors; the plain version
is the composition the port rendered with before kernel P, and stays the
autograd path. These tests hold it to that composition bit for bit, hold
``prepare_view``'s choice between the kernel and the composition, and
hold the wrapper's launch arguments to ``csrc/project.cu``'s interface.
The kernel itself runs on the card only (tests/test_torch_gpu.py).
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
from torch_port_utils import (PROJECTION_CAMERAS, projection_camera,
                              projection_cloud)

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
    """With a gradient the table comes from the composition: it requires
    grad, reaches every parameter, and equals the table without one."""
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


# prepare_view's path by what its inputs show: kernel P where no gradient
# can flow into an SH model, the composition otherwise
DISPATCH = {
    "no_grad": ("sh", "no_grad", True, "kernel"),
    "inference_mode": ("sh", "inference_mode", True, "kernel"),
    "frozen": ("sh", "grad", False, "kernel"),
    "grad": ("sh", "grad", True, "composition"),
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
    assert v.table.requires_grad == (want == "composition"
                                     and requires_grad and mode == "grad")


def test_project_view_refuses_what_the_kernel_lacks():
    cam = projection_camera("pinhole")
    model = projection_cloud(300)
    with pytest.raises(ValueError, match="no backward"):
        P.project_view(cam, ut_ops.UTConfig(), model, 3, True)
    with torch.no_grad():
        with pytest.raises(ValueError, match="sh_degree 4"):
            P.project_view(cam, ut_ops.UTConfig(), model, 4, True)
        with pytest.raises(NotImplementedError, match="NHT"):
            P.project_view(cam, ut_ops.UTConfig(), nht_cloud(300, dim=8), 0,
                           False)


def test_cpu_render_launches_nothing():
    """On the CPU the wrapper runs the plain version and counts nothing;
    the counters are among launch_counts' wrappers."""
    assert P.project_view in _wrappers()
    before = (P.project_view.launches, P.project_view.launches_general)
    with torch.no_grad():
        gut.render_gut(projection_camera("pinhole"), ut_ops.UTConfig(),
                       RasterConfig(), projection_cloud(300), 3)
    assert (P.project_view.launches,
            P.project_view.launches_general) == before
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
