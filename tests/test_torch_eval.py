"""The port's evaluation path against the JAX package's: colour
correction, the sRGB transfer, LPIPS, the scene generator and the eval
CLI (render_torch.py against render.py).

CPU, small sizes. Tolerances, with reasons:
  * color_correct_affine, linear_to_srgb, srgb_to_linear: rtol 1e-5 (the
    same float32 arithmetic; the 4x4 solve's LU may round differently);
  * LPIPS with random_params(0) on two seeded 3x64x64 images: 1e-4
    relative (13 fp32 convolutions, summed in another order);
    lpips(a, a) is exactly 0;
  * the generator (--side 48 --teacher-n 2000 --n-train 2 --n-val 1):
    the JSON files equal; the PNGs at most one level apart, in at most
    0.5% of pixels. The JAX script runs with its package's full-f32 dots
    (``THREEDGRUT_MXU_F32MODE=fp32``, ops/pallas/mxu.py): its default
    split-bf16 dots leave ~5e-5 in the render (tests/test_torch_render.py),
    which truncation to uint8 turns into one-level flips on ~1-2% of these
    pixels (83 of 9,216 seen), and the opacity channel most;
  * render_torch.py against render.py on one checkpoint of a 3-step JAX
    Trainer (and on tests/fixtures/parity_cloud.ply): psnr and psnr_cc
    within 1e-3 dB, ssim within 1e-4, ssim_cc within 5e-4; the same keys
    and the same best and worst frame; JAX again with full-f32 dots.
    ssim_cc's wider tolerance is the float32 least squares of the colour
    correction, which both packages solve through the normal equations:
    on these dark, barely trained 32x32 frames A^T A reaches a condition
    number of ~3e5, so float32 rounding in its sum over the pixels moves
    the fit by up to ~1e-3 a pixel. JAX's own ssim_cc moves by up to
    1.1e-4 when only the order of the pixels changes, and the port's is
    up to 2.3e-4 from JAX's (the linear-to-srgb case; every other metric
    within 1e-5).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu.ops.pallas import mxu as j_mxu
from threedgrut_tpu.utils import color_correct as j_cc
from threedgrut_tpu.utils import lpips as j_lpips
from threedgrut_tpu.utils import misc as j_misc
from threedgrut_tpu_torch.utils import color_correct as t_cc
from threedgrut_tpu_torch.utils import lpips as t_lpips
from threedgrut_tpu_torch.utils import misc as t_misc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

GEN_ARGS = ["--side", "48", "--teacher-n", "2000", "--n-train", "2",
            "--n-val", "1"]
PNG_FLIP_SHARE = 0.005
PSNR_TOL, SSIM_TOL, SSIM_CC_TOL = 1e-3, 1e-4, 5e-4


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def test_color_correct_and_srgb_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    gt = np.clip(pred @ rng.uniform(0.5, 1.2, (3, 3)).astype(np.float32)
                 * 0.5 + 0.1 + rng.normal(0, 0.02, pred.shape), 0,
                 1).astype(np.float32)
    for clip in (True, False):
        got = t_cc.color_correct_affine(torch.from_numpy(pred),
                                        torch.from_numpy(gt), clip=clip)
        ref = j_cc.color_correct_affine(jnp.asarray(pred), jnp.asarray(gt),
                                        clip=clip)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    x = np.concatenate([rng.uniform(-0.2, 1.2, 4000),
                        [0.0, 1.0, 0.0031308, 0.04045, 1e-9]]
                       ).astype(np.float32)
    for t_fn, j_fn in ((t_misc.linear_to_srgb, j_misc.linear_to_srgb),
                       (t_misc.srgb_to_linear, j_misc.srgb_to_linear)):
        np.testing.assert_allclose(_np(t_fn(torch.from_numpy(x))),
                                   np.asarray(j_fn(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-7)


def test_lpips_matches_jax():
    jp, tp = j_lpips.random_params(0), t_lpips.random_params(0)
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]), k)
    a = np.random.default_rng(0).uniform(0, 1, (1, 3, 64, 64)).astype(
        np.float32)
    b = np.random.default_rng(1).uniform(0, 1, (1, 3, 64, 64)).astype(
        np.float32)
    got = float(t_lpips.lpips(tp, torch.from_numpy(a), torch.from_numpy(b)))
    ref = float(j_lpips.lpips(jp, jnp.asarray(a), jnp.asarray(b)))
    print(f"lpips port {got!r} jax {ref!r}")
    assert got > 0 and got == pytest.approx(ref, rel=1e-4)
    assert float(t_lpips.lpips(tp, torch.from_numpy(a),
                               torch.from_numpy(a))) == 0.0


def test_lpips_weight_loading_matches_jax(tmp_path, monkeypatch):
    """convert_torch_state on a synthetic torchvision-layout dict (the
    test of tests/test_gsplat_parity.py:117-137) equals JAX's; .npz in the
    JAX layout loads; no file gives None."""
    torch.manual_seed(0)
    vgg, layer, in_ch = {}, 0, 3
    for ch, n_convs in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        for _ in range(n_convs):
            vgg[f"features.{layer}.weight"] = torch.randn(ch, in_ch, 3, 3)
            vgg[f"features.{layer}.bias"] = torch.randn(ch)
            in_ch = ch
            layer += 2
        layer += 1
    lin = {f"lin{k}.model.1.weight": torch.rand(1, c, 1, 1) - 0.2
           for k, c in enumerate((64, 128, 256, 512, 512))}
    path = str(tmp_path / "w.pth")
    torch.save({"vgg": vgg, "lin": lin}, path)
    got, ref = t_lpips.load_weights(path), j_lpips.load_weights(path)
    assert set(got) == set(ref) and got["conv0_w"].shape == (64, 3, 3, 3)
    assert got["lin4_w"].shape == (512,) and float(got["lin0_w"].min()) >= 0
    for k in ref:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]), k)
    a = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 3, 16, 16)).astype(np.float32))
    assert float(t_lpips.lpips(got, a, a)) == 0.0
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **{k: np.asarray(v) for k, v in ref.items()})
    back = t_lpips.load_weights(npz)
    for k in ref:
        np.testing.assert_array_equal(_np(back[k]), np.asarray(ref[k]), k)
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    monkeypatch.setenv("HOME", str(tmp_path))
    assert t_lpips.load_weights() is None and not t_lpips.available()


def _jax_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               THREEDGRUT_MXU_F32MODE="fp32")
    return env


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """The port's and the JAX script's scenes at GEN_ARGS."""
    import gen_synthetic_scene_torch

    root = tmp_path_factory.mktemp("gen")
    port, ref = str(root / "port"), str(root / "jax")
    gen_synthetic_scene_torch.main(["--out", port, "--device", "cpu",
                                    *GEN_ARGS])
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "gen_synthetic_scene.py"),
         "--out", ref, *GEN_ARGS],
        cwd=REPO, env=_jax_env(), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return port, ref


def test_generator_matches_jax(generated):
    from PIL import Image

    port, ref = generated
    flips = total = 0
    for split in ("train", "val", "test"):
        with open(os.path.join(port, f"transforms_{split}.json")) as f:
            got = json.load(f)
        with open(os.path.join(ref, f"transforms_{split}.json")) as f:
            want = json.load(f)
        assert got == want, split
        for fr in got["frames"]:
            name = fr["file_path"][2:] + ".png"
            a = np.asarray(Image.open(os.path.join(port, name)), np.int32)
            b = np.asarray(Image.open(os.path.join(ref, name)), np.int32)
            assert a.shape == b.shape == (48, 48, 4), name
            d = np.abs(a - b)
            assert d.max() <= 1, name
            flips += int((d.max(axis=-1) > 0).sum())
            total += a.shape[0] * a.shape[1]
    print(f"generator: {flips} of {total} pixels one level apart")
    assert flips <= PNG_FLIP_SHARE * total


def test_generator_prints_pairs_and_refuses_without_card(generated,
                                                         monkeypatch):
    import gen_synthetic_scene_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        gen_synthetic_scene_torch.main(["--out", generated[0]])


# ---------------------------------------------------------------------------
# render_torch.py against render.py
# ---------------------------------------------------------------------------

SCENE_ARGS = ["--side", "32", "--teacher-n", "2000", "--n-train", "3",
              "--n-val", "2"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A tiny NeRF-format scene from the port's generator, and a
    checkpoint of 3 JAX Trainer steps on it (config embedded)."""
    import gen_synthetic_scene_torch
    import train as j_train
    from threedgrut_tpu.config.loader import load_config, to_trainer_config
    from threedgrut_tpu.train.trainer import Trainer

    root = tmp_path_factory.mktemp("eval")
    data = str(root / "data")
    gen_synthetic_scene_torch.main(["--out", data, "--device", "cpu",
                                    *SCENE_ARGS])
    conf = load_config("apps/nerf_synthetic_3dgut", overrides=[
        f"path={data}", "initialization.num_gaussians=300",
        "render.max_pairs=8192", "render.auto_max_pairs=false"])
    ds = j_train.make_dataset(conf, "train")
    tr = Trainer(to_trainer_config(conf), ds,
                 j_train.make_model(conf, ds), raw_conf=conf)
    for i in range(3):
        tr.train_iteration(ds[i])
    ckpt = str(root / "ckpt_3.npz")
    tr.save_checkpoint(ckpt)
    return data, ckpt, root


@pytest.fixture
def f32_dots():
    """JAX's kernels with full-f32 dots (mxu.py's fp32 mode)."""
    old = j_mxu._FP32_MODE
    j_mxu._FP32_MODE = True
    yield
    j_mxu._FP32_MODE = old


def _jax_render(argv, monkeypatch):
    import render as j_render

    monkeypatch.setattr(sys, "argv", ["render.py", *argv])
    j_render.main()


CASES = {
    "checkpoint": [],
    "linear_to_srgb": ["post_processing.method=linear-to-srgb"],
    "ply": ["--config-name", "apps/nerf_synthetic_3dgut"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_cli_matches_jax(scene, case, f32_dots, monkeypatch):
    import render_torch

    data, ckpt, root = scene
    if case == "ply":
        ckpt = os.path.join(REPO, "tests", "fixtures", "parity_cloud.ply")
    out_p, out_j = str(root / f"{case}_port"), str(root / f"{case}_jax")
    argv = ["--checkpoint", ckpt, "--path", data, "--save-images",
            *CASES[case]]
    render_torch.main([*argv, "--out-dir", out_p, "--device", "cpu"])
    _jax_render([*argv, "--out-dir", out_j], monkeypatch)
    with open(os.path.join(out_p, "metrics.json")) as f:
        got = json.load(f)
    with open(os.path.join(out_j, "metrics.json")) as f:
        ref = json.load(f)
    assert list(got) == list(ref)
    assert got["lpips"] == ref["lpips"]      # no weights: the same string
    assert (got["best_frame"], got["worst_frame"]) == \
        (ref["best_frame"], ref["worst_frame"])
    assert len(got["per_frame"]) == len(ref["per_frame"]) == 2
    for g, r in zip([got] + got["per_frame"], [ref] + ref["per_frame"]):
        for k, tol in (("psnr", PSNR_TOL), ("psnr_cc", PSNR_TOL),
                       ("ssim", SSIM_TOL), ("ssim_cc", SSIM_CC_TOL)):
            assert g[k] == pytest.approx(r[k], abs=tol), (case, k)
    for i in range(2):
        assert os.path.exists(os.path.join(out_p, f"pred_{i:04d}.png"))
    print(case, {k: got[k] for k in ("psnr", "ssim", "psnr_cc", "ssim_cc")})


def test_render_cli_refuses_nht_where_jax_cannot_score(scene, monkeypatch):
    """render.py composites an NHT checkpoint's ray features without the
    decoder and fails; render_torch.py refuses it, naming why. It also
    refuses PPISP and a missing card."""
    import render_torch
    import train_torch
    from threedgrut_tpu_torch.config.loader import load_config
    from threedgrut_tpu_torch.train.trainer import Trainer

    data, ckpt, root = scene
    conf = load_config("apps/nerf_synthetic_3dgut_mcmc_nht", overrides=[
        f"path={data}", "initialization.num_gaussians=300",
        "strategy.add.max_n_gaussians=512"])
    ds = train_torch.make_dataset(conf, "train")
    tr = Trainer(train_torch.trainer_config(conf), ds,
                 train_torch.make_model(conf, ds, "cpu"), raw_conf=conf)
    nht_ckpt = str(root / "nht.npz")
    tr.save_checkpoint(nht_ckpt)
    argv = ["--checkpoint", nht_ckpt, "--path", data]
    with pytest.raises(SystemExit, match="render.py:96-99"):
        render_torch.main([*argv, "--out-dir", str(root / "nht_port"),
                           "--device", "cpu"])
    with pytest.raises(Exception) as err:
        _jax_render([*argv, "--out-dir", str(root / "nht_jax")], monkeypatch)
    print("render.py on an NHT checkpoint:", type(err.value).__name__,
          str(err.value)[:200])
    with pytest.raises(SystemExit, match="ppisp"):
        render_torch.main(["--checkpoint", ckpt, "--path", data,
                           "--device", "cpu",
                           "post_processing.method=ppisp"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        render_torch.main(["--checkpoint", ckpt, "--path", data])
