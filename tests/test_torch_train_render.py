"""Gradients of the PyTorch port's 3DGUT render against the JAX package.

CPU: the port's ``render_gut`` backward (the plain versions of kernels C
and D: autograd through the float64 compositing, and a float64
``index_add`` fold) against JAX ``render_gut`` with the exact kill and
the wide interval fold (its Pallas kernels in interpret mode) and against
the JAX oracle, for the loss of tests/test_render_parity.py:49-61.
Tolerance: max-normalised atol 2e-3 (that test's own; the JAX kernels
emulate fp32 products with split-bf16 matmuls) and cosine >= 0.9999.

Also: the plain fold against ``fold_sorted_intervals_wide`` on the same
pairs, the fold metadata of the binning, the response derivative, and
the JAX gradient fixture that chip_smoke.py phase 10 reads.

The kernels against their plain versions on the card:
tests/test_torch_gpu.py.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from threedgrut_tpu.ops import hit as j_hit
from threedgrut_tpu.ops.pallas.fold import fold_sorted_intervals_wide
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu.render.gut import render_gut as j_render_gut
from threedgrut_tpu.render.oracle import render_oracle as j_render_oracle
from threedgrut_tpu_torch.ops import hit as t_hit
from threedgrut_tpu_torch.ops.cuda.fold import fold_pairs
from threedgrut_tpu_torch.ops.cuda.raster import (rasterize_tiles,
                                                  rasterize_tiles_backward)
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.render.gut import prepare_view, render_gut
from torch_port_utils import np32, torch_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures",
                       "torch_port_grad_small.npz")
NAMES = ("positions", "rotation", "scale", "density", "features_albedo",
         "features_specular")
J_RC = JRasterConfig(max_pairs=1 << 14, exact_kill=True, grad_fold=True,
                     fold_wide=True)
SH_DEGREE = 1
# (n, resolution, seed); the last one is the fixture's scene
SCENES = {"n48": (48, (32, 32), 3), "n96": (96, (64, 48), 0)}


def _loss(out):
    """tests/test_render_parity.py:49-61 with a zero target."""
    return (jnp.mean(out["pred_features"] ** 2)
            + 0.1 * jnp.mean(out["pred_opacity"])
            + 0.01 * jnp.mean(out["pred_dist"]))


def jax_grads(cam, state, oracle=False):
    """(loss, {leaf: grad}) of JAX render_gut (interpret mode) or of the
    JAX oracle."""
    def loss(params):
        m = state.replace(params=params)
        if oracle:
            out = j_render_oracle(cam, JUTConfig(), J_RC, m, SH_DEGREE)
        else:
            out = j_render_gut(cam, JUTConfig(), J_RC, m, SH_DEGREE,
                               interpret=True)
        return _loss(out)

    val, g = jax.value_and_grad(loss)(state.params)
    return float(val), {k: np.asarray(getattr(g, k)) for k in NAMES}


def torch_grads(cam, state):
    tcam, model = torch_scene(cam, state)
    out = render_gut(tcam, UTConfig(), RasterConfig(), model, SH_DEGREE)
    loss = (out["pred_features"].square().mean()
            + 0.1 * out["pred_opacity"].mean()
            + 0.01 * out["pred_dist"].mean())
    loss.backward()
    return float(loss.detach()), {k: getattr(model, k).grad.numpy()
                                  for k in NAMES}


def assert_grads_close(got, ref):
    for k in NAMES:
        a, b = got[k].astype(np.float64), ref[k].astype(np.float64)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-3, rtol=0,
                                   err_msg=k)
        cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.9999, (k, cos)


@pytest.fixture(scope="module")
def jax_runs():
    """Per scene: (cam, state, JAX render_gut loss and grads)."""
    runs = {}
    for name, (n, res, seed) in SCENES.items():
        cam, state = make_test_scene(n=n, seed=seed, res=res)
        runs[name] = (cam, state, jax_grads(cam, state))
    return runs


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_render_grads_match_jax(jax_runs, scene):
    cam, state, (j_loss, j_grads) = jax_runs[scene]
    launches = (rasterize_tiles.launches, rasterize_tiles_backward.launches,
                fold_pairs.launches)
    t_loss, t_grads = torch_grads(cam, state)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    assert_grads_close(t_grads, j_grads)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (rasterize_tiles.launches, rasterize_tiles_backward.launches,
            fold_pairs.launches) == launches


def test_render_grads_match_jax_oracle(jax_runs):
    cam, state, _ = jax_runs["n48"]
    _, ref = jax_grads(cam, state, oracle=True)
    _, got = torch_grads(cam, state)
    assert_grads_close(got, ref)


def test_plain_fold_matches_jax_wide_fold():
    """fold_pairs_plain against fold_sorted_intervals_wide (interpret
    mode) and _grf_bwd's rank -> particle map, on one view's pairs with
    random per-pair gradients. Both sum in f32-or-better; 1e-5 of the
    largest row."""
    cam, state = make_test_scene(n=96, seed=1, res=(64, 48))
    tcam, model = torch_scene(cam, state)
    with torch.no_grad():
        b = prepare_view(tcam, UTConfig(), RasterConfig(), model, 3).binning
    rng = np.random.default_rng(0)
    d_rec = torch.tensor(rng.normal(size=(b.limit, 16)).astype(np.float32))
    got = fold_pairs(d_rec, b.perm, b.order, b.excl, b.counts, b.limit,
                     model.capacity).numpy()
    # the JAX fold's inputs: rows in pre-sort slot order with their depth
    # rank as an f32 label, and each rank's [slot, next) run
    perm = b.perm.numpy().astype(np.int64)
    pre = np.empty_like(d_rec.numpy())
    pre[perm] = d_rec.numpy()
    counts = b.counts.numpy().astype(np.int64)
    rank = np.repeat(np.arange(counts.size), counts)[:b.limit]
    excl = b.excl.numpy().astype(np.int64)
    slot = np.minimum(excl, b.limit).astype(np.int32)
    nxt = np.minimum(excl + counts, b.limit).astype(np.int32)
    d_rank = np.asarray(fold_sorted_intervals_wide(
        jnp.asarray(pre), jnp.asarray(rank.astype(np.float32)),
        jnp.asarray(slot), jnp.asarray(nxt), interpret=True))
    ref = d_rank[np.argsort(b.order.numpy())]
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0)
    # every pair lands somewhere: the folded total is the pair total
    np.testing.assert_allclose(got.sum(0), d_rec.numpy().sum(0), atol=1e-3)


def test_binning_fold_metadata():
    """perm undoes the tile sort, and the slot runs of the depth ranks
    give every kept pair's particle."""
    cam, state = make_test_scene(n=96, seed=2, res=(64, 48))
    tcam, model = torch_scene(cam, state)
    with torch.no_grad():
        b = prepare_view(tcam, UTConfig(), RasterConfig(), model, 3).binning
    perm = b.perm.numpy()
    assert sorted(perm.tolist()) == list(range(b.limit))
    owner = np.repeat(np.arange(b.counts.numel()),
                      b.counts.numpy())[:b.limit]
    np.testing.assert_array_equal(b.order.numpy()[owner][perm],
                                  b.pair_particle.numpy())
    assert b.limit == b.pair_particle.numel()


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4, 5, 8])
def test_particle_response_dsq_matches_jax(degree):
    sq = np.random.default_rng(degree).uniform(0.0, 9.0, 256).astype(
        np.float32)
    resp = np32(t_hit.particle_response(torch.tensor(sq), degree))
    got = np32(t_hit.particle_response_dsq(torch.tensor(sq),
                                           torch.tensor(resp), degree))
    ref = np.asarray(j_hit.particle_response_dsq(jnp.asarray(sq),
                                                 jnp.asarray(resp), degree))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)


def make_grad_fixture(cam, state, loss, grads):
    """Scene inputs and the JAX gradients (the chip's phase-10 data)."""
    data = {f"params/{k}": np.asarray(getattr(state.params, k))
            for k in NAMES}
    data.update({f"grad/{k}": np.asarray(v, np.float32)
                 for k, v in grads.items()})
    data.update(
        n_active=np.int32(state.n_active),
        n_active_features=np.int32(state.n_active_features),
        density_activation=state.config.density_activation,
        scale_activation=state.config.scale_activation,
        resolution=np.asarray(cam.resolution, np.int32),
        focal=np.asarray(cam.focal), principal=np.asarray(cam.principal),
        t=np.asarray(cam.t_start), q=np.asarray(cam.q_start),
        sh_degree=np.int32(SH_DEGREE), loss=np.float32(loss))
    return data


def test_grad_fixture_is_current(jax_runs):
    """The saved JAX gradients agree with a fresh JAX run within 1e-6, so
    the fixture the chip smoke test reads cannot drift."""
    cam, state, (loss, grads) = jax_runs["n96"]
    fresh = make_grad_fixture(cam, state, loss, grads)
    with np.load(FIXTURE) as saved:
        assert set(saved.files) == set(fresh)
        for k, v in fresh.items():
            if saved[k].dtype.kind in "fi":
                scale = max(1.0, float(np.abs(v).max()))
                np.testing.assert_allclose(saved[k], v, atol=1e-6 * scale,
                                           rtol=0, err_msg=k)
            else:
                assert str(saved[k]) == str(v), k
    assert os.path.getsize(FIXTURE) < 200_000


if __name__ == "__main__":
    # regenerate the fixture: PYTHONPATH=. python tests/test_torch_train_render.py
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (JAX on the CPU, highest precision)
    n, res, seed = SCENES["n96"]
    cam, state = make_test_scene(n=n, seed=seed, res=res)
    np.savez_compressed(FIXTURE, **make_grad_fixture(
        cam, state, *jax_grads(cam, state)))
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
