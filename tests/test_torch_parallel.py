"""Multi-GPU training of the PyTorch port (threedgrut_tpu_torch/parallel)
against the JAX package's shard_map steps and against the port's single
rank.

CPU: the port's ranks are processes of one ``run_ranks`` spawn (gloo, one
thread a rank, the rank function ``parallel/dryrun.py:cases_rank``); the
JAX sides run once, in module fixtures, on conftest's 8 virtual CPU
devices. Bounds, with reasons:
  * the 2-rank dp step against JAX's 2-device step: loss rtol 2e-3, and
    more than 99% of parameter entries within 2e-5 after one Adam step
    (tests/test_parallel.py:70-79: Adam's sign-like first step turns
    reassociation noise on near-zero gradients into +-lr moves);
  * the 2-rank sliced render against JAX's: features and opacity atol
    5e-4 with rtol 1e-3, distance atol 2e-3 (test_parallel.py:113-121,
    the kill threshold's effects);
  * the port's parallel steps against its single rank (the same step on
    a group of one, or render_gut and the loss): max |dParams| < 1e-4
    after one Adam step (the dry run's bound), losses rtol 3e-3 and atol
    1e-4 (test_parallel.py's sliced and dp x mp bound), sliced gradients
    within 1e-5 of each leaf's max |gradient| (measured ~1e-6 of it: the
    combine's exclusive product reassociates the composite; no ray of
    these scenes falls below the kill threshold, past which a back slab
    composites what the serial render skips, chip_smoke.py phase 50);
  * each collective's value and gradient within 1e-6 of the same
    composition in one process.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from threedgrut_tpu.ops.cameras import ShutterType as JShutter
from threedgrut_tpu.ops.cameras import make_pinhole as j_make_pinhole
from threedgrut_tpu.ops.cameras import relative_shutter_time as j_shutter_t
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.optimizers.adam import init_adam_state as j_init_adam
from threedgrut_tpu.parallel import dp as j_dp
from threedgrut_tpu.parallel.particle import make_sliced_render as j_sliced
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu_torch.models.gaussians import GaussianModel
from threedgrut_tpu_torch.ops.cameras import make_pinhole
from threedgrut_tpu_torch.ops.ssim import ssim
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.optimizers.adam import init_adam_state
from threedgrut_tpu_torch.parallel import comm, dryrun
from threedgrut_tpu_torch.parallel.dp import make_dp_train_step
from threedgrut_tpu_torch.parallel.launch import run_ranks
from threedgrut_tpu_torch.parallel.particle import make_dp_sliced_train_step
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.render.gut import render_gut

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("positions", "rotation", "scale", "density", "features_albedo",
         "features_specular")
J_RC = JRasterConfig(max_pairs=1 << 12)
DELTA_TOL = dryrun.DELTA_TOL


def _graft():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scene(n, res, seed=0):
    """(JAX camera, JAX model, the raw arrays): __graft_entry__'s scene."""
    cam, model = _graft()._build_scene(n=n, cap=n, res=res, seed=seed)
    return cam, model, {k: np.asarray(getattr(model.params, k))
                        for k in NAMES}


def _gt(seed, res, channels=3):
    return np.random.default_rng(seed).uniform(
        0, 1, (res[1], res[0], channels)).astype(np.float32)


def _camera(res, **kw):
    w, h = res
    return dict(resolution=res, focal=(1.1 * w, 1.1 * w),
                principal=(w / 2, h / 2), **kw)


def _case(kind, group, arrays, res, gt, sh_degree=1, **kw):
    return dict(kind=kind, group=group, arrays=arrays,
                n_active=arrays["positions"].shape[0], sh_degree=sh_degree,
                camera=kw.pop("camera", _camera(res)), gt=gt, **kw)


DP_RES, SLICED_RES, STEP_RES = (32, 32), (48, 32), (32, 32)
FISHEYE = dict(kind="fisheye", resolution=STEP_RES, focal=(19.2, 19.2),
               principal=(16.0, 16.0), radial4=(0.02, -0.01, 0.0, 0.0),
               max_angle=1.2)


def _cases():
    _, _, dp_arrays = _scene(128, DP_RES)
    _, _, sl_arrays = _scene(128, SLICED_RES)
    _, _, st_arrays = _scene(96, STEP_RES)
    nht = {k: st_arrays[k] for k in NAMES[:4]}
    nht["features"] = np.random.default_rng(3).uniform(
        -1.5, 1.5, (96, 16)).astype(np.float32)
    return {
        "dp": _case("dp", "pair", dp_arrays, DP_RES, _gt(0, DP_RES)),
        "sliced_render": _case("sliced_render", "pair", sl_arrays,
                               SLICED_RES, None),
        "sliced_step": _case("sliced_step", "pair", st_arrays, STEP_RES,
                             _gt(1, STEP_RES)),
        "grt": _case("dp", "pair", st_arrays, STEP_RES, _gt(4, STEP_RES),
                     raster=dict(sorted_compositing=True, sort_window=16,
                                 kernel_degree=4, min_transmittance=1e-3)),
        "fisheye": _case("dp", "pair", st_arrays, STEP_RES, _gt(5, STEP_RES),
                         camera=FISHEYE),
        "nht": _case("dp", "pair", nht, STEP_RES, _gt(6, STEP_RES, 8),
                     sh_degree=0, loss=dict(loss_lambda_ssim=0.0)),
        "dp_x_mp": _case("dp_x_mp", "mesh", st_arrays, STEP_RES,
                         _gt(2, STEP_RES)),
        "comm": dict(kind="comm", group="world"),
    }


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def ranks(cases):
    """Every case on 4 CPU ranks, in one spawn: each rank's outputs."""
    return run_ranks(dryrun.cases_rank, 4, device="cpu", args=(cases,))


@pytest.fixture(scope="module")
def jax_dp():
    """JAX's dp step on a 2-device mesh, SSIM on (test_parallel.py's)."""
    cam, model, arrays = _scene(128, DP_RES)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    step = j_dp.make_dp_train_step(mesh, cam, JUTConfig(), J_RC, model,
                                   sh_degree=1, loss_lambda_ssim=0.2)
    params = {k: jnp.asarray(v) for k, v in arrays.items()}
    lrs = {k: jnp.asarray(1e-3, jnp.float32) for k in params}
    new, _, metrics = step(
        j_dp.replicate_to_mesh(mesh, params),
        j_dp.replicate_to_mesh(mesh, j_init_adam(params)), lrs,
        j_dp.shard_image_rows(mesh, jnp.asarray(_gt(0, DP_RES))),
        model.n_active, cam)
    return {k: np.asarray(v) for k, v in new.items()}, float(
        metrics["total"]), float(metrics["l1"])


@pytest.fixture(scope="module")
def jax_sliced():
    cam, model, arrays = _scene(128, SLICED_RES)
    mesh = Mesh(np.array(jax.devices()[:2]), ("mp",))
    render = j_sliced(mesh, JUTConfig(), J_RC, model, sh_degree=1)
    params = j_dp.replicate_to_mesh(
        mesh, {k: jnp.asarray(v) for k, v in arrays.items()})
    return [np.asarray(x) for x in render(params, model.n_active, cam)]


def test_scene_copy_draws_jax_arrays():
    """dryrun.scene_arrays is __graft_entry__._build_scene's draws."""
    _, _, ref = _scene(256, (32, 32), seed=1)
    got = dryrun.scene_arrays(256, 256, seed=1)
    for k in NAMES:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_dp_step_matches_jax(ranks, jax_dp):
    ref_params, ref_total, ref_l1 = jax_dp
    got = ranks[0]["dp"]
    np.testing.assert_allclose(got["metrics"]["total"], ref_total,
                               rtol=2e-3)
    np.testing.assert_allclose(got["metrics"]["l1"], ref_l1, rtol=2e-3)
    off = sum(int((np.abs(got["params"][k] - ref_params[k]) > 2e-5).sum())
              for k in NAMES)
    total = sum(v.size for v in ref_params.values())
    assert off / total < 0.01, f"{off}/{total} entries past 2e-5"
    # both ranks hold the same replica after the step
    for k in NAMES:
        np.testing.assert_array_equal(ranks[1]["dp"]["params"][k],
                                      got["params"][k])


def test_sliced_render_matches_jax(ranks, jax_sliced):
    feat, opac, dist = ranks[0]["sliced_render"]
    np.testing.assert_allclose(feat, jax_sliced[0], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(opac, jax_sliced[1], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(dist, jax_sliced[2], atol=2e-3, rtol=1e-3)
    np.testing.assert_array_equal(ranks[1]["sliced_render"][0], feat)


def _model(c):
    return GaussianModel.from_numpy(c["arrays"], c["n_active"],
                                    c["sh_degree"])


def _camera_of(c):
    return dryrun._case_camera(c, "cpu")


def test_sliced_step_grads_match_single_device(cases, ranks):
    """The 2-rank depth-sliced step's loss and averaged gradients against
    render_gut's with the same loss (0.8 l1 + 0.2 DSSIM) in one process,
    and its parameters after one Adam step."""
    c = cases["sliced_step"]
    model, cam = _model(c), _camera_of(c)
    gt = torch.from_numpy(c["gt"])
    pred = render_gut(cam, UTConfig(), RasterConfig(), model,
                      1)["pred_features"]
    loss = 0.8 * torch.mean(torch.abs(pred - gt)) + 0.2 * (1.0 - ssim(
        pred.permute(2, 0, 1)[None], gt.permute(2, 0, 1)[None]))
    loss.backward()
    got = ranks[0]["sliced_step"]
    np.testing.assert_allclose(got["metrics"]["total"], float(loss.detach()),
                               rtol=3e-3, atol=1e-4)
    for k in NAMES:
        ref = getattr(model, k).grad.numpy()
        err = np.abs(got["grads"][k] - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (k, err)
    params = {k: v.detach().clone() for k, v in model.params().items()}
    opt = init_adam_state(params)
    from threedgrut_tpu_torch.optimizers.adam import adam_step
    adam_step(params, {k: getattr(model, k).grad for k in params}, opt,
              {k: 1e-3 for k in params},
              update_mask=model.active_mask())
    assert dryrun.max_delta(
        {k: torch.from_numpy(got["params"][k]) for k in NAMES},
        params) < DELTA_TOL


def _single_rank(c, make):
    """The case's step on one rank, in this process (no process group:
    a group of one)."""
    model, cam = _model(c), _camera_of(c)
    step = make(model, cam)
    params = dryrun.params_of(model)
    return dryrun._run(step, params, {k: 1e-3 for k in params},
                       torch.from_numpy(c["gt"]), model.n_active, cam)


@pytest.mark.parametrize("name", ["grt", "fisheye", "nht"])
def test_dp_modes_match_single_rank(cases, ranks, name):
    """3DGRT sorted compositing (W 16, degree 4), an OpenCV fisheye and
    NHT features (L1 on every ray feature, SSIM off) under 2-rank dp."""
    c = cases[name]
    ref, ref_m = _single_rank(c, lambda m, cam: make_dp_train_step(
        None, cam, UTConfig(), RasterConfig(**c.get("raster", {})), m,
        c["sh_degree"], **c.get("loss", {})))
    got = ranks[0][name]
    np.testing.assert_allclose(got["metrics"]["total"], ref_m["total"],
                               rtol=3e-3, atol=1e-4)
    delta = dryrun.max_delta({k: torch.from_numpy(v) for k, v in
                              got["params"].items()}, ref)
    assert delta < DELTA_TOL, delta


def test_dp_x_mp_matches_single_rank(cases, ranks):
    """dp x mp 2 x 2 (4 ranks) against the same step on a 1 x 1 mesh in
    this process, and its loss against render_gut's L1."""
    c = cases["dp_x_mp"]
    ref, ref_m = _single_rank(c, lambda m, cam: make_dp_sliced_train_step(
        (None, None), cam, UTConfig(), RasterConfig(), m, 1))
    outs = [r["dp_x_mp"] for r in ranks]
    model, cam = _model(c), _camera_of(c)
    with torch.no_grad():
        pred = render_gut(cam, UTConfig(), RasterConfig(), model,
                          1)["pred_features"]
    l1 = float(torch.mean(torch.abs(pred - torch.from_numpy(c["gt"]))))
    for out in outs:
        np.testing.assert_allclose(out["metrics"]["total"], l1, rtol=3e-3,
                                   atol=1e-4)
        delta = dryrun.max_delta({k: torch.from_numpy(v) for k, v in
                                  out["params"].items()}, ref)
        assert delta < DELTA_TOL, delta
    assert ref_m["total"] == pytest.approx(l1, rel=1e-6)


def _compose(name, xs):
    """Every rank's f(x) of ``comm_functions`` composed in one process."""
    n = len(xs)
    if name == "psum":
        return [sum(xs)] * n
    if name == "pmean":
        return [sum(xs) / n] * n
    if name == "all_gather":
        return [torch.stack(xs)] * n
    if name == "ppermute":
        return [xs[(i - 1) % n] for i in range(n)]
    if name == "ppermute_first":
        return [torch.zeros_like(xs[0]), xs[0]] + [
            torch.zeros_like(x) for x in xs[2:]]
    return [torch.cat([xs[(i - 1) % n][-5:], xs[i], xs[(i + 1) % n][:5]])
            for i in range(n)]


@pytest.mark.parametrize("name", sorted(dryrun.comm_functions()))
def test_collective_value_and_gradient(ranks, name):
    """Each comm.py collective over 4 ranks: f(x) and the gradient of
    sum_r sum(w_r f(x_r)) against the composition in one process."""
    outs = [r["comm"][name] for r in ranks]
    xs = [torch.tensor(o["x"], requires_grad=True) for o in outs]
    ys = _compose(name, xs)
    sum((y * torch.from_numpy(o["w"])).sum()
        for y, o in zip(ys, outs)).backward()
    for r, (x, y, o) in enumerate(zip(xs, ys, outs)):
        np.testing.assert_allclose(o["y"], y.detach().numpy(), atol=1e-6,
                                   err_msg=f"{name} value, rank {r}")
        ref = torch.zeros_like(x) if x.grad is None else x.grad
        np.testing.assert_allclose(o["grad"], ref.numpy(), atol=1e-6,
                                   err_msg=f"{name} gradient, rank {r}")


def test_collectives_act_on_a_group_of_one_without_a_process_group():
    """No process group: the collectives are the identity, index 0 of 1."""
    x = torch.arange(12.0).reshape(12, 1)
    assert comm.axis_index() == 0 and comm.axis_size() == 1
    for name, fn in dryrun.comm_functions().items():
        y = fn(x)
        ref = x[None] if name == "all_gather" else x
        if name == "ppermute_first":
            ref = torch.zeros_like(x)
        if name == "halo_rows":
            ref = torch.cat([x[-5:], x, x[:5]])
        assert torch.equal(y, ref), name


def test_dp_refuses_a_rolling_shutter():
    """Departure by design: band sharding refuses a rolling shutter, whose
    band cameras would restart the shutter (the JAX fault below)."""
    rolling = make_pinhole((32, 32), (35.2, 35.2), (16.0, 16.0),
                           shutter_type=1)
    glob = make_pinhole((32, 32), (35.2, 35.2), (16.0, 16.0))
    model = GaussianModel.from_numpy(dryrun.scene_arrays(64, 64), 64, 1)
    with pytest.raises(ValueError, match="rolling"):
        make_dp_train_step(None, rolling, UTConfig(), RasterConfig(),
                           model, 1)
    with pytest.raises(ValueError, match="rolling"):
        make_dp_sliced_train_step((None, None), rolling, UTConfig(),
                                  RasterConfig(), model, 1)
    step = make_dp_train_step(None, glob, UTConfig(), RasterConfig(),
                              model, 1)
    params = dryrun.params_of(model)
    with pytest.raises(ValueError, match="rolling"):
        step(params, init_adam_state(params), {k: 1e-3 for k in params},
             torch.zeros(32, 32, 3), 64, rolling)


def test_jax_band_camera_restarts_the_rolling_shutter():
    """The JAX fault the refusal avoids (parallel/dp.py:84-100 with
    ops/cameras.py:291-297): band 1 of a top-to-bottom rolling camera,
    cropped as JAX's dp step crops it, times its rows from 0 again,
    where the full camera's rows 400-799 run from 0.5 to 1: JAX's
    band-sharded render of a rolling-shutter view is not its
    single-device render."""
    full = j_make_pinhole((800, 800), (880.0, 880.0), (400.0, 400.0),
                          shutter_type=int(JShutter.ROLLING_TOP_TO_BOTTOM))
    band = j_dp.band_camera(full, 400)
    rows = jnp.arange(400, dtype=jnp.float32) + 0.5
    uv_band = jnp.stack([jnp.full_like(rows, 100.5), rows], -1)
    uv_full = uv_band + jnp.array([0.0, 400.0])
    t_band = np.asarray(j_shutter_t(band, uv_band))
    t_full = np.asarray(j_shutter_t(full, uv_full))
    assert t_band[0] == 0.0 and t_full[0] == pytest.approx(400 / 799)
    assert t_band[-1] == t_full[-1] == 1.0
    # every row but the last is timed early, by up to half the shutter
    assert (np.abs(t_band - t_full)[:-1] > 1e-3).all()
    assert np.abs(t_band - t_full).max() > 0.49


def test_run_ranks_refuses_more_ranks_than_gpus_without_gloo():
    """No card here: a card launch raises; with a card, more ranks than
    GPUs name backend="gloo"."""
    n = torch.cuda.device_count()
    with pytest.raises((RuntimeError, ValueError), match="cpu|gloo"):
        run_ranks(dryrun.dryrun_rank, n + 1, device="cuda")


def test_dryrun_front_end_on_cpu_ranks():
    """python -m threedgrut_tpu_torch.parallel.dryrun on 2 CPU ranks
    (gloo): every case of the dry run passes and prints its line."""
    import subprocess
    import sys

    res = subprocess.run(
        [sys.executable, "-m", "threedgrut_tpu_torch.parallel.dryrun",
         "--world-size", "2", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.endswith(" OK")]
    assert len(lines) == 7, res.stdout
    assert "dp x mp 1x2" in res.stdout and "nht" in res.stdout
