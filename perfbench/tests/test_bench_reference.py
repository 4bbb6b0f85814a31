"""The reference against the port at a small size on the CPU: the
render, its gradients, the count of contributing evaluations, the ISP
and SSIM copies, and whole runs of each cell."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness, program, run, scene
from perfbench.reference import render as ref
from perfbench.reference import train as ref_train
from perfbench.tests.conftest import ROOT, WINDOW_S

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small_view():
    conf = harness.resolve_cell("cusfm_3dgut_mcmc.train").config
    pose = scene.views(conf, "train")[1]
    pose = pose._replace(width=80, height=56, focal=1.111 * 56)
    return conf, pose


def port_render(params, pose, conf, degree):
    from threedgrut_tpu_torch.render.gut import render_gut

    tconf = program.trainer_config(conf, 0)
    model = program.gaussian_model(params, degree)
    return model, render_gut(program.camera(pose, CPU), tconf.ut,
                             tconf.raster, model, degree)


def test_render_and_pairs_match_the_port(small_view):
    conf, pose = small_view
    params = scene.standin_cloud(3000, 11, CPU)
    color, opac, n_pairs = ref.render(
        {k: v.clone() for k, v in params.items()}, pose.reference_camera(CPU),
        ref.settings_from(conf), 3)
    _, out = port_render(params, pose, conf, 3)
    assert n_pairs == int(out["num_pairs"])
    assert float(opac.amax()) > 0.5
    # fp32 here against the port's float64 plain versions on the CPU
    torch.testing.assert_close(color, out["pred_features"], atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(opac, out["pred_opacity"], atol=1e-5, rtol=0)


def test_gradients_match_the_port(small_view):
    conf, pose = small_view
    params = scene.standin_cloud(3000, 12, CPU)
    ref_params = {k: v.clone().requires_grad_() for k, v in params.items()}
    gen = torch.Generator().manual_seed(0)
    wc = torch.rand((pose.height, pose.width, 3), generator=gen)
    wo = torch.rand((pose.height, pose.width, 1), generator=gen)
    ref.render_backward(ref_params, pose.reference_camera(CPU),
                        ref.settings_from(conf), 3,
                        lambda c, o: (wc * c).sum() + (wo * o).sum())
    model, out = port_render(params, pose, conf, 3)
    ((wc * out["pred_features"]).sum()
     + (wo * out["pred_opacity"]).sum()).backward()
    for k, p in model.params().items():
        want = p.grad
        got = ref_params[k].grad
        scale = float(want.abs().max())
        assert scale > 0, k
        assert float((got - want).abs().max()) <= 1e-4 * scale, k


def test_counts_are_the_port_hit_counts(small_view):
    conf, pose = small_view
    params = scene.standin_cloud(3000, 13, CPU)
    c = {"evals": 0, "particles": torch.zeros(3000, dtype=torch.bool)}
    ref.render({k: v.clone() for k, v in params.items()},
               pose.reference_camera(CPU), ref.settings_from(conf), 3, counts=c)
    _, out = port_render(params, pose, conf, 3)
    assert c["evals"] == int(out["hits_count"].sum())
    assert 0 < int(c["particles"].sum()) < 3000


def test_relocate_and_add_at_the_cap_match_the_port():
    from threedgrut_tpu_torch.optimizers.adam import init_adam_state
    from threedgrut_tpu_torch.strategy import mcmc

    conf = harness.resolve_cell("colmap_3dgut_mcmc.train").config
    spec = ref_train.spec_from(dict(conf, max_n_gaussians=3000))
    params = scene.standin_cloud(3000, 14, CPU)
    gen = torch.Generator().manual_seed(3)
    want = {k: v.clone() for k, v in params.items()}
    mom = [{k: torch.rand(v.shape, generator=gen) for k, v in want.items()}
           for _ in range(2)]
    model = program.gaussian_model(params, 3)
    opt = init_adam_state(model.params())
    for mine, theirs in zip(mom, (opt.exp_avg, opt.exp_avg_sq)):
        for k, v in mine.items():
            theirs[k].copy_(v)
    g_port, g_ref = (torch.Generator().manual_seed(9) for _ in range(2))
    n = mcmc.relocate(model, opt, g_port, spec.opacity_threshold,
                      spec.binom_n_max)
    mcmc.add_gaussians(model, opt, g_port, max_n=3000,
                       n_max=spec.binom_n_max)
    dead, rows = ref_train.relocate(want, mom, g_ref, spec)
    assert int(dead.sum()) == n > 10 and int(rows.sum()) > n
    ref_train.add_at_cap(want, g_ref, spec)
    for k, p in model.params().items():
        torch.testing.assert_close(want[k], p.detach(), atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(mom[0][k], opt.exp_avg[k])
        torch.testing.assert_close(mom[1][k], opt.exp_avg_sq[k])
    # both generators have moved alike
    assert torch.equal(torch.rand(4, generator=g_port),
                       torch.rand(4, generator=g_ref))


def test_isp_and_ssim_copies_match_the_port():
    from threedgrut_tpu_torch.models.ppisp import apply_ppisp_full
    from threedgrut_tpu_torch.ops.ssim import ssim

    gen = torch.Generator().manual_seed(1)
    p = {k: torch.randn(v.shape, generator=gen) * 0.3
         for k, v in ref_train.ppisp_init(5, CPU).items()}
    img = torch.rand((24, 40, 3), generator=gen)
    torch.testing.assert_close(ref_train.ppisp(p, img, 3),
                               apply_ppisp_full(p, img, 0, 3), atol=1e-6,
                               rtol=1e-6)
    gt = torch.rand((24, 40, 3), generator=gen)
    torch.testing.assert_close(
        ref_train.ssim(img, gt),
        ssim(img.permute(2, 0, 1)[None], gt.permute(2, 0, 1)[None]),
        atol=1e-6, rtol=0)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    """To nearest, ties away from zero, as the card's cvt.rna.tf32."""
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11,
                      -(1.0 + 3 * 2.0 ** -12), 3.0])
    got = ref.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 3.0]


@pytest.mark.parametrize("cell", ["colmap_3dgut_mcmc.train",
                                  "cusfm_3dgut_mcmc.train",
                                  "cusfm_3dgut_mcmc.serve"])
def test_small_runs_are_correct(small, cell):
    out = run.run_cell(harness.resolve_cell(cell, small), 2 ** 31 + 5,
                       WINDOW_S, False, CPU)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in harness.resolve_cell(cell).end_to_end}
    assert set(out["metrics"]) == names


def test_small_root_keeps_the_published_settings(small):
    for cell in ("colmap_3dgut_mcmc.train", "cusfm_3dgut_mcmc.serve"):
        a = harness.resolve_cell(cell, small).config
        b = harness.resolve_cell(cell, ROOT).config
        assert a["train"] == b["train"] and a["render"] == b["render"]
