"""The playground of the PyTorch port against the JAX package's, on the
CPU: the samplers, the microfacet BRDF, the meshes and their closest
hits, the engine's path tracer, the web viewer and ``playground_torch.py``.

Tolerances, with reasons:
  * PCG3D, Sobol with Owen scrambling and the low-discrepancy jitter:
    bit for bit (uint32 arithmetic on both sides);
  * ``sample_microfacet_brdf``: 1e-5 relative (fp32 transcendental
    functions of two libraries);
  * closest hits: equal triangles and materials, t and normals 1e-5;
  * ``render_rays`` at 8x8 rays, 2 bounces, glass, mirror and PBR
    primitives over 64 Gaussians: 1e-4 (trace's tolerance; measured
    ~5e-6).
The random jitter of the ``independent_random`` and ``msaa`` modes and
the aperture seeds come from a ``torch.Generator``, not ``jax.random``:
those draws are held to their ranges, not to JAX's values.
"""

import os
import sys
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from test_playground import write_test_glb, write_textured_glb
from threedgrut_tpu.playground import engine as j_engine
from threedgrut_tpu.playground import mesh as j_mesh
from threedgrut_tpu.playground import sampling as j_sampling
from threedgrut_tpu.playground.materials import \
    sample_microfacet_brdf as j_brdf
from threedgrut_tpu_torch.convert import model_from_state, save_checkpoint
from threedgrut_tpu_torch.playground import engine as t_engine
from threedgrut_tpu_torch.playground import mesh as t_mesh
from threedgrut_tpu_torch.playground import sampling as t_sampling
from threedgrut_tpu_torch.playground.materials import \
    sample_microfacet_brdf as t_brdf
from threedgrut_tpu_torch.playground.web_gui import (ViewerServer,
                                                     orbit_camera)
from torch_port_utils import np32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import playground_torch  # noqa: E402


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def test_hashes_and_sobol_bit_for_bit():
    rng = np.random.default_rng(0)
    v = _u32(rng, (2000, 3))
    tv = torch.tensor(v.astype(np.int64))
    np.testing.assert_array_equal(
        t_sampling.pcg3d(tv).numpy(),
        np.asarray(j_sampling.pcg3d(jnp.asarray(v))).astype(np.int64))
    np.testing.assert_array_equal(
        t_sampling.pcg3d_float(tv).numpy(),
        np.asarray(j_sampling.pcg3d_float(jnp.asarray(v))))
    idx, seed = _u32(rng, 1000), _u32(rng, 1000)
    ref = j_sampling.shuffled_scrambled_sobol2d(jnp.asarray(idx),
                                                jnp.asarray(seed))
    got = t_sampling.shuffled_scrambled_sobol2d(
        torch.tensor(idx.astype(np.int64)), torch.tensor(seed.astype(
            np.int64)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(r).astype(np.int64))
    # the low-discrepancy jitter of the first two accumulation steps
    j_spp = j_sampling.SPP("low_discrepancy_seq", spp=4)
    t_spp = t_sampling.SPP("low_discrepancy_seq", spp=4)
    for _ in range(2):
        np.testing.assert_array_equal(t_spp(6, 9).numpy(),
                                      np.asarray(j_spp(6, 9)))
    u, w = (rng.uniform(size=300).astype(np.float32) for _ in range(2))
    for g, r in zip(t_sampling.concentric_disc(torch.tensor(u),
                                               torch.tensor(w)),
                    j_sampling.concentric_disc(jnp.asarray(u),
                                               jnp.asarray(w))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_random_modes_and_depth_of_field():
    """The generator-driven draws: within their ranges, reproducible from
    the seed, and the SPP accumulation contract."""
    for mode in ("none", "independent_random", "msaa"):
        spp = t_sampling.SPP(mode, spp=4)
        spp.reset_accumulation()
        frames = []
        while spp.has_more_to_accumulate():
            frames.append(spp(5, 7))
        assert len(frames) == 4
        # msaa: a pattern point, perturbed within its stratum
        assert all(f.shape == (5, 7, 2) and float(f.abs().max()) <= 0.65
                   for f in frames)
        again = t_sampling.SPP(mode, spp=4)
        again.reset_accumulation()
        assert torch.equal(again(5, 7), frames[0])
    dof = t_sampling.DepthOfField(spp=2, aperture_size=0.1, focus_z=2.0)
    o = torch.zeros((50, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(50, 3)
    new_o, new_d = dof(torch.tensor([1.0, 0, 0]), torch.tensor([0, 1.0, 0]),
                       o, d)
    assert float(new_o.norm(dim=-1).max()) <= 0.1 + 1e-6
    # every ray still passes through its focus point
    focus = new_o + new_d * (2.0 / new_d[:, 2:3])
    torch.testing.assert_close(focus, d * 2.0, atol=1e-5, rtol=0)


def test_microfacet_brdf_matches_jax():
    rng = np.random.default_rng(1)
    r = 1000

    def unit(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    args = [unit(rng.normal(size=(r, 3))), unit(rng.normal(size=(r, 3))),
            rng.uniform(size=(r, 3)), rng.uniform(size=(r, 1)),
            rng.uniform(0.05, 1.0, (r, 1)), rng.uniform(size=(r, 1)),
            rng.uniform(1.0, 2.0, (r, 1)), rng.uniform(size=(r, 3))]
    args = [a.astype(np.float32) for a in args]
    got = t_brdf(*[torch.tensor(a) for a in args])
    ref = j_brdf(*[jnp.asarray(a) for a in args])
    for g, rr in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rr), rtol=1e-5,
                                   atol=1e-5)


def _demo_meshes(mod, center):
    return [mod.make_icosphere(np.asarray(center) + [0.3, 0, -1.0], 0.3, 1,
                               material_id=1),
            mod.make_box(np.asarray(center) + [-0.4, 0, -1.0],
                         (0.3, 0.3, 0.3), material_id=2)]


@pytest.mark.parametrize("kind", ["soup", "clustered"])
def test_closest_hit_matches_jax(kind):
    rng = np.random.default_rng(2)
    ro = np.zeros((600, 3), np.float32)
    ro[:, 2] = -3.0
    rd = rng.normal(size=(600, 3)).astype(np.float32) * 0.3
    rd[:, 2] = 1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    meshes = {m: _demo_meshes(m, (0.0, 0.0, 0.0)) + [m.make_icosphere(
        (0.2, 0.1, 0.5), 0.5, 3, material_id=3)] for m in (j_mesh, t_mesh)}
    if kind == "soup":
        j_x, t_x = (j_mesh.TriangleSoup(meshes[j_mesh]),
                    t_mesh.TriangleSoup(meshes[t_mesh]))
    else:
        j_x, t_x = (j_mesh.ClusteredTriangles(meshes[j_mesh], 8),
                    t_mesh.ClusteredTriangles(meshes[t_mesh], 8))
    ref = j_x.closest_hit(jnp.asarray(ro), jnp.asarray(rd))
    got = t_x.closest_hit(torch.tensor(ro), torch.tensor(rd))
    assert (np.asarray(ref[3]) >= 0).sum() > 100
    for i, (g, r) in enumerate(zip(got, ref)):
        if i in (1, 3):      # triangle and material ids
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                       rtol=1e-6)


def test_glb_round_trip(tmp_path):
    """The GLB loaders (numpy and PIL): node transforms, u16 indices,
    TEXCOORD_0 and an embedded PNG texture, as JAX reads them."""
    quad, tex = str(tmp_path / "quad.glb"), str(tmp_path / "tex.glb")
    write_test_glb(quad)
    write_textured_glb(tex)
    for path in (quad, tex):
        got, gm = t_mesh.load_glb_scene(path)
        ref, rm = j_mesh.load_glb_scene(path)
        assert len(got) == len(ref) == 1
        np.testing.assert_array_equal(got[0].vertices, ref[0].vertices)
        np.testing.assert_array_equal(got[0].faces, ref[0].faces)
        assert (got[0].uvs is None) == (ref[0].uvs is None)
        assert [m["base_color"] for m in gm] == [m["base_color"] for m in rm]
    meshes, mats = t_mesh.load_glb_scene(tex)
    np.testing.assert_allclose(meshes[0].uvs[2], [1, 1])
    img = mats[0]["diffuse_map"]
    assert img.shape == (2, 2, 3)
    np.testing.assert_allclose(img[0, 0], [1, 0, 0])
    np.testing.assert_allclose(img[0, 1], [0, 1, 0])
    hit = t_mesh.TriangleSoup(t_mesh.load_mesh_file(quad)).closest_hit(
        torch.tensor([[0.5, 0.5, 0.0]]), torch.tensor([[0.0, 0.0, 1.0]]))
    assert float(hit[0][0]) == pytest.approx(5.0, abs=1e-5)
    # a textured render samples the map: the left half red, right green
    _, state = make_test_scene(n=8, seed=0)
    eng = t_engine.Engine3DGRUT(model_from_state(state),
                                t_engine.EngineConfig(max_bounces=1),
                                t_engine.EnvironmentMap(constant=(1, 1, 1)))
    assert eng.add_glb(tex, kind="diffuse") == 1
    ro = torch.tensor([[-0.5, 0.0, 0.0], [0.5, 0.0, 0.0]])
    rgb = eng.render_rays(ro, torch.tensor([[0.0, 0.0, 1.0]] * 2))
    assert float(rgb[0, 0]) > 0.5 > float(rgb[0, 1])
    assert float(rgb[1, 1]) > 0.5 > float(rgb[1, 0])


def _engines(state):
    """The JAX and port engines over one scene: a glass icosphere, a
    mirror box and a PBR box (transmission 0.5) in front of it."""
    center = np.asarray(state.params.positions[:64]).mean(0)
    out = []
    for eng_mod, mesh_mod, model in ((j_engine, j_mesh, state),
                                     (t_engine, t_mesh,
                                      model_from_state(state))):
        e = eng_mod.Engine3DGRUT(model, eng_mod.EngineConfig(max_bounces=2))
        glass, mirror = _demo_meshes(mesh_mod, center)
        e.add_primitive(glass, eng_mod.PBRMaterial(
            kind="glass", base_color=(0.95, 0.95, 1.0)))
        e.add_primitive(mirror, eng_mod.PBRMaterial(
            kind="mirror", base_color=(0.9, 0.9, 0.9)))
        e.add_primitive(mesh_mod.make_box(center + [0.0, 0.5, 0.0],
                                          (0.3, 0.2, 0.3)),
                        eng_mod.PBRMaterial(kind="pbr",
                                            base_color=(0.7, 0.3, 0.2),
                                            roughness=0.3,
                                            transmission=0.5))
        out.append(e)
    return center, out


def test_render_rays_matches_jax():
    _, state = make_test_scene(n=64, seed=2, res=(32, 32))
    center, (je, te) = _engines(state)
    rng = np.random.default_rng(0)
    ro = np.tile(np.asarray(center * [1, 1, 0] + [0, 0, -1.0], np.float32),
                 (64, 1))
    target = center + rng.uniform(-0.6, 0.6, (64, 3)) * [1, 1, 0]
    rd = (target - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ref = np.asarray(je.render_rays(jnp.asarray(ro), jnp.asarray(rd)))
    got = te.render_rays(torch.tensor(ro), torch.tensor(rd))
    hits = te._get_soup().closest_hit(torch.tensor(ro), torch.tensor(rd))[3]
    assert 10 < int((hits >= 0).sum()) < 60   # meshes and Gaussians both
    np.testing.assert_allclose(np32(got), ref, atol=1e-4, rtol=0)


def test_frames_and_refusals():
    """render (SPP and depth of field), the fisheye frame, and render
    with each denoiser (which the port once refused): a frame in [0, 1]
    of the same shape (tests/test_torch_denoise.py holds the values)."""
    _, state = make_test_scene(n=32, seed=0)
    eng = t_engine.Engine3DGRUT(
        model_from_state(state),
        t_engine.EngineConfig(max_bounces=2, spp=2, spp_mode="msaa",
                              aperture=0.05),
        t_engine.EnvironmentMap(constant=(0.2, 0.3, 0.4)))
    eng.add_primitive(t_mesh.make_icosphere((0, 0, 4.0), 0.5, 1),
                      t_engine.PBRMaterial(kind="mirror"))
    cam = orbit_camera(0.0, 0.0, 4.0, center=(0, 0, 4.0),
                       resolution=(16, 12))
    frames = list(eng.render_progressive(cam))
    assert len(frames) == 2 and frames[-1].shape == (12, 16, 3)
    assert np.isfinite(frames[-1]).all() and frames[-1].max() <= 1.0
    fish = eng.render_fisheye(np.eye(4), np.pi, 12, 12)
    assert fish.shape == (12, 12, 3) and fish[0, 0].sum() == 0.0
    for denoiser in ("cnn", "atrous"):
        eng.config = t_engine.EngineConfig(max_bounces=2, denoise=True,
                                           denoiser=denoiser)
        img = eng.render(cam)
        assert img.shape == (12, 16, 3) and np.isfinite(img).all()
        assert img.min() >= 0.0 and img.max() <= 1.0


def test_viewer_serves_frames():
    calls = []

    def render(az, el, dist):
        calls.append((az, el, dist))
        return np.full((24, 32, 3), 128, np.uint8)

    server = ViewerServer(render, resolution=(32, 24), port=0,
                          host="127.0.0.1")
    url = server.start()
    try:
        page = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "frame.jpg" in page and 'width="32"' in page
        jpg = urllib.request.urlopen(url + "frame.jpg?az=0.5&el=0.1&dist=3",
                                     timeout=10).read()
        assert jpg[:2] == b"\xff\xd8"
        assert calls == [(0.5, 0.1, 3.0)]
    finally:
        server.stop()


def test_playground_cli(tmp_path, monkeypatch):
    """playground_torch.py: refuses without a card unless --device cpu;
    loads a checkpoint, adds the demo primitives and renders a frame."""
    _, state = make_test_scene(n=32, seed=1)
    ckpt = str(tmp_path / "ckpt.npz")
    save_checkpoint(model_from_state(state), ckpt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        playground_torch.main(["--asset", ckpt])
    model = playground_torch.load_model(ckpt, torch.device("cpu"))
    engine, center = playground_torch.build_engine(model,
                                                   demo_primitives=True)
    assert len(engine.meshes) == 2
    img = playground_torch.frame_renderer(engine, center, (16, 16))(
        0.3, 0.1, 2.5)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
