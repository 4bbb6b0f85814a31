"""The port's playground denoisers and video helpers against the JAX
package's: playground/{denoise,denoise_cnn,video}.py and the engine's
denoiser pass.

CPU, no Pallas. Tolerances, with reasons:
  * the à-trous filter within 1e-6: the same 25 taps of exp-weighted
    sums in float32, four iterations;
  * the CNN within 2e-6: six fp32 3x3 convolutions (XLA's and oneDNN's
    sums in different orders) and a clip;
  * the bilateral filter within 1e-6 (49 taps in float32);
  * interpolate_poses bit for bit (the same numpy code);
  * the engine's denoised frame within 2e-6 of JAX's denoiser applied to
    the port's undenoised frame (which tests/test_torch_playground.py
    holds to JAX's engine).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu.playground import denoise as j_atrous
from threedgrut_tpu.playground import denoise_cnn as j_cnn
from threedgrut_tpu.playground import video as j_video
from threedgrut_tpu_torch.playground import denoise as t_atrous
from threedgrut_tpu_torch.playground import denoise_cnn as t_cnn
from threedgrut_tpu_torch.playground import video as t_video


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _guides(seed, lead=()):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=lead + (20, 24, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dep = rng.uniform(1, 9, lead + (20, 24)).astype(np.float32)
    return nrm, dep


@pytest.mark.parametrize("guides", ["none", "normals", "depth2d",
                                    "depth3d", "both"])
def test_atrous_matches_jax(guides):
    rgb = _frame(0, (20, 24, 3))
    nrm, dep = _guides(1)
    kw = {}
    if guides in ("normals", "both"):
        kw["normals"] = nrm
    if guides in ("depth2d", "both"):
        kw["depth"] = dep
    if guides == "depth3d":
        kw["depth"] = dep[..., None]
    ref = np.asarray(j_atrous.atrous_denoise(
        jnp.asarray(rgb), **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = t_atrous.atrous_denoise(
        torch.tensor(rgb), **{k: torch.tensor(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    assert np.abs(ref - rgb).max() > 1e-2      # it filters


def _jax_params_as_torch(params):
    return {layer: {k: torch.tensor(np.asarray(v)) for k, v in leaves.items()}
            for layer, leaves in params.items()}


def test_weights_file_is_a_byte_copy():
    assert os.path.dirname(t_cnn.WEIGHTS_PATH).endswith(
        os.path.join("threedgrut_tpu_torch", "playground"))
    with open(t_cnn.WEIGHTS_PATH, "rb") as a, open(j_cnn.WEIGHTS_PATH,
                                                   "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("weights", ["committed", "guided"])
@pytest.mark.parametrize("batched", [False, True])
def test_apply_cnn_matches_jax(weights, batched):
    """The committed weights (RGB in, guides ignored) and a guided net of
    JAX's init_params with a random output layer, with and without the
    guides, on one frame and on a batch of two."""
    if weights == "committed":
        with np.load(j_cnn.WEIGHTS_PATH) as raw:
            jp = {}
            for k in raw.files:
                layer, leaf = k.rsplit("/", 1)
                jp.setdefault(layer, {})[leaf] = jnp.asarray(raw[k])
        tp = t_cnn.load_params()
    else:
        jp = j_cnn.init_params(jax.random.PRNGKey(3), guides=True)
        jp["conv_out"]["w"] = 0.05 * jax.random.normal(
            jax.random.PRNGKey(4), jp["conv_out"]["w"].shape)
        tp = _jax_params_as_torch(jp)
    lead = (2,) if batched else ()
    rgb = _frame(5, lead + (20, 24, 3))
    nrm, dep = _guides(6, lead)
    for kw in ({}, {"normals": nrm, "depth": dep},
               {"depth": dep[..., None]}):
        ref = np.asarray(j_cnn.apply_cnn(
            jp, jnp.asarray(rgb), **{k: jnp.asarray(v)
                                     for k, v in kw.items()}))
        got = t_cnn.apply_cnn(tp, torch.tensor(rgb),
                              **{k: torch.tensor(v) for k, v in kw.items()})
        assert got.shape == rgb.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)
        assert np.abs(ref - rgb).max() > 1e-3


def test_init_params_is_identity_and_seeded():
    g = torch.Generator().manual_seed(0)
    p = t_cnn.init_params(g, guides=True)
    assert p["conv_in"]["w"].shape == (3, 3, 7, 24)
    assert sum(v.numel() for leaves in p.values()
               for v in leaves.values()) == sum(
        np.asarray(v).size for leaves in j_cnn.init_params(
            jax.random.PRNGKey(0)).values() for v in leaves.values())
    rgb = torch.tensor(_frame(2, (12, 16, 3)))
    torch.testing.assert_close(t_cnn.apply_cnn(p, rgb), rgb, atol=0, rtol=0)
    again = t_cnn.init_params(torch.Generator().manual_seed(0), guides=True)
    assert all(torch.equal(again[k]["w"], p[k]["w"]) for k in p)
    q = t_cnn.init_params(torch.Generator().manual_seed(1), guides=False)
    assert q["conv_in"]["w"].shape == (3, 3, 3, 24)
    assert not torch.equal(q["res0_a"]["w"], p["res0_a"]["w"])


def test_load_params_is_keyed_by_path(tmp_path):
    """Two weights files load as two nets (JAX's load_params keeps one
    cache whatever the path); a missing path gives None, and
    denoise_frame then falls through to the à-trous filter."""
    a = t_cnn.load_params()
    assert a is t_cnn.load_params()                     # cached
    other = str(tmp_path / "other.npz")
    t_cnn.save_params({k: {n: v * 0.5 for n, v in leaves.items()}
                       for k, leaves in a.items()}, other)
    b = t_cnn.load_params(other)
    torch.testing.assert_close(b["res0_a"]["w"], 0.5 * a["res0_a"]["w"])
    assert t_cnn.load_params() is a
    rgb = torch.tensor(_frame(7, (16, 20, 3)))
    assert not torch.equal(t_cnn.denoise_frame(rgb),
                           t_cnn.denoise_frame(rgb, path=other))
    missing = str(tmp_path / "none.npz")
    assert t_cnn.load_params(missing) is None
    torch.testing.assert_close(t_cnn.denoise_frame(rgb, path=missing),
                               t_atrous.atrous_denoise(rgb), atol=0, rtol=0)
    torch.testing.assert_close(t_cnn.denoise_frame(rgb),
                               t_cnn.apply_cnn(a, rgb), atol=0, rtol=0)


def test_engine_render_denoises_like_jax():
    """Engine3DGRUT.render with each denoiser: JAX's pass (engine.py:
    366-374) on the port's undenoised frame of a tiny scene."""
    from scene_utils import make_test_scene
    from threedgrut_tpu_torch.convert import model_from_state
    from threedgrut_tpu_torch.ops.cameras import orbit_camera
    from threedgrut_tpu_torch.playground import engine as t_engine
    from threedgrut_tpu_torch.playground import mesh as t_mesh

    _, state = make_test_scene(n=48, seed=3)
    eng = t_engine.Engine3DGRUT(model_from_state(state),
                                t_engine.EngineConfig(max_bounces=2))
    eng.add_primitive(t_mesh.make_icosphere((0, 0, 4.0), 0.4, 1),
                      t_engine.PBRMaterial(kind="glass"))
    cam = orbit_camera(0.2, 0.1, 4.0, center=(0, 0, 4.0),
                       resolution=(24, 20))
    plain = eng.render(cam)
    refs = {"cnn": j_cnn.denoise_frame(jnp.asarray(plain)),
            "atrous": j_atrous.atrous_denoise(jnp.asarray(plain))}
    for name, ref in refs.items():
        eng.config = t_engine.EngineConfig(max_bounces=2, denoise=True,
                                           denoiser=name)
        got = eng.render(cam)
        np.testing.assert_allclose(got, np.clip(np.asarray(ref), 0, 1),
                                   atol=2e-6, rtol=0, err_msg=name)
        assert np.abs(got - plain).max() > 1e-3


def test_interpolate_poses_and_bilateral_match_jax():
    from threedgrut_tpu_torch.synthetic import orbit_poses

    poses = np.stack(orbit_poses(5, seed=2)).astype(np.float32)
    for n in (7, 24):
        np.testing.assert_array_equal(t_video.interpolate_poses(poses, n),
                                      j_video.interpolate_poses(poses, n))
    img = _frame(8, (18, 22, 3))
    for kw in ({}, {"sigma_spatial": 1.0, "sigma_color": 0.3,
                    "radius": 2}):
        np.testing.assert_allclose(t_video.bilateral_denoise(img, **kw),
                                   j_video.bilateral_denoise(img, **kw),
                                   atol=1e-6, rtol=0)
    got = t_video.bilateral_denoise(torch.tensor(img))
    assert isinstance(got, np.ndarray) and got.shape == img.shape


def test_write_video_falls_back_to_png_frames(tmp_path, monkeypatch):
    """Where imageio encodes (a GIF through its Pillow plugin) the file is
    written; with imageio made unimportable both packages write the same
    PNG frames beside the path."""
    from PIL import Image

    frames = [(_frame(i, (12, 16, 3)) * 255).astype(np.uint8)
              for i in range(3)]
    pytest.importorskip("imageio")
    gif = str(tmp_path / "a.gif")
    assert t_video.write_video(frames, gif, fps=5) == gif
    assert os.path.getsize(gif) > 100
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    got = t_video.write_video(frames, str(tmp_path / "t" / "v.mp4"))
    ref = j_video.write_video(frames, str(tmp_path / "j" / "v.mp4"))
    assert got == str(tmp_path / "t" / "v_frames")
    assert sorted(os.listdir(got)) == sorted(os.listdir(ref)) == [
        "00000.png", "00001.png", "00002.png"]
    for name in os.listdir(got):
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(got, name))),
            np.asarray(Image.open(os.path.join(ref, name))))
