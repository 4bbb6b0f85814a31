"""The layout ops of the PyTorch port (kernels G and H) and the JAX
flat-grid and aligned-segment routes against the port's render.

CPU, plain versions against the JAX functions in Pallas interpret mode:
  * ``expand_sorted_rows`` (kernel G's plain version) against JAX
    ``expand_sorted_rows`` on the cases of tests/test_expand.py, equal bit
    for bit (atol 0): both copy values, and ids ride as floats up to 2^24;
  * ``forward_fill`` and ``segmented_fill_rows`` (kernel H's plain
    versions) against JAX's, equal bit for bit, with the carry across
    JAX's 8192-lane slabs and dropped slots; the port's rule for rows that
    share a slot (the last in input order) against a loop, and its
    refusal of a negative slot, which JAX wraps modulo its padded buffer;
  * JAX ``render_gut`` with ``flat_grid`` and ``aligned_segments`` (the
    TPU's kernels 11, 12 and 13 and the aligned gradient fold, in
    interpret mode) against the port's ``render_gut`` (kernels B, C and
    D's plain versions), which serves rows 11-12 with the same function:
    the image within tests/test_torch_render.py's tolerances (1e-4; depth
    1e-3) and the gradients within tests/test_torch_train_render.py's
    (2e-3 max-normalised, cosine >= 0.9999).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from threedgrut_tpu.ops.pallas.expand import BLK
from threedgrut_tpu.ops.pallas.expand import \
    expand_sorted_rows as j_expand_sorted_rows
from threedgrut_tpu.ops.pallas.fill import SLAB
from threedgrut_tpu.ops.pallas.fill import forward_fill as j_forward_fill
from threedgrut_tpu.ops.pallas.fill import \
    segmented_fill_rows as j_segmented_fill_rows
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu.render.gut import render_gut as j_render_gut
from threedgrut_tpu_torch.ops.cuda.expand import expand_sorted_rows
from threedgrut_tpu_torch.ops.cuda.fill import (FILL_SPAN, fill_spans,
                                                forward_fill,
                                                segmented_fill_rows)
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.render.gut import render_gut
from torch_port_utils import torch_scene

NAMES = ("positions", "rotation", "scale", "density", "features_albedo",
         "features_specular")
SH_DEGREE = 1
# a scene whose densest tiles hold more than one 128-pair chunk, so the
# flat grid visits them twice and carries their state between visits
SCENE = dict(n=200, seed=4, res=(48, 32), scale_range=(0.1, 0.3))
J_RC = JRasterConfig(max_pairs=1 << 14, exact_kill=True, grad_fold=True,
                     fold_wide=True, flat_grid=True, aligned_segments=True)
KEYS = ("pred_features", "pred_opacity", "pred_dist", "hits_count")

# tests/test_expand.py's cases: (counts, max_pairs, slab, seed)
EXPAND_CASES = {
    "basic": (np.array([3, 0, 5, 1, 0, 7, 120, 2, 0, 0, 4] + [0] * 50),
              256, 256, 0),
    "multi_slab_overflow": (None, 1024, 256, 3),
    "empty": (np.zeros(64, np.int64), 256, 256, 0),
    "passthrough": (np.array([17, 40, 3, 100, 96]), 256, 256, 9),
}


def _expand_counts(name):
    counts, max_pairs, slab, seed = EXPAND_CASES[name]
    if counts is None:
        counts = np.random.default_rng(3).integers(0, 9, 300)
        counts[120] = 700          # one interval over several slabs
    return counts, max_pairs, slab, seed


@pytest.mark.parametrize("name", sorted(EXPAND_CASES))
def test_expand_rows_matches_jax(name):
    counts, max_pairs, slab, seed = _expand_counts(name)
    rng = np.random.default_rng(seed)
    n, d = len(counts), 11
    vals = rng.normal(size=(n, d)).astype(np.float32)
    # ids ride as floats up to 2^24 (not denormals: XLA's CPU matmul
    # flushes them to zero)
    vals[:, 0] = rng.integers(0, 1 << 24, n).astype(np.float32)
    offsets = np.cumsum(counts)
    starts = np.minimum(offsets - counts, max_pairs).astype(np.int32)
    ends = np.minimum(offsets, max_pairs).astype(np.int32)

    table = np.zeros(((n + BLK - 1) // BLK * BLK + BLK, 128), np.float32)
    table[:n, :d] = vals
    table[:n, 11] = starts
    table[:n, 12] = ends
    bounds = np.arange(max_pairs // slab)
    src_start = np.searchsorted(ends, bounds * slab, side="right")
    src_end = np.searchsorted(starts, (bounds + 1) * slab, side="left")
    ref = np.asarray(j_expand_sorted_rows(
        jnp.asarray(table), jnp.asarray(src_start, jnp.int32),
        jnp.asarray(src_end, jnp.int32), len(bounds), slab=slab,
        interpret=True))[:, :d, :].transpose(0, 2, 1).reshape(max_pairs, d)

    before = expand_sorted_rows.launches
    got = expand_sorted_rows(torch.from_numpy(vals), torch.from_numpy(starts),
                             torch.from_numpy(ends), max_pairs).numpy()
    assert expand_sorted_rows.launches == before      # CPU: plain
    np.testing.assert_array_equal(got, ref)
    if counts.sum():
        assert np.abs(ref).max() > 0


def _jax_fill(vals, marked):
    """JAX forward_fill on [L, D] values and an [L] mask (L a multiple of
    SLAB), through its slab layout."""
    length, d = vals.shape
    slabs = np.concatenate([vals, marked[:, None].astype(np.float32)], 1)
    slabs = slabs.reshape(length // SLAB, SLAB, d + 1).transpose(0, 2, 1)
    out = np.asarray(j_forward_fill(jnp.asarray(slabs), interpret=True))
    return out.transpose(0, 2, 1).reshape(length, d + 1)[:, :d]


@pytest.mark.parametrize("marks", ["sparse", "none", "first"])
def test_forward_fill_matches_jax(marks):
    rng = np.random.default_rng(5)
    length, d = 2 * SLAB, 5
    vals = rng.normal(size=(length, d)).astype(np.float32)
    marked = {"sparse": rng.random(length) < 0.002,
              "none": np.zeros(length, bool),
              "first": np.arange(length) == 0}[marks]
    if marks == "sparse":
        # one mark carries over the slab boundary, none near the start
        marked[:100] = False
        marked[SLAB - 300:SLAB + 200] = False
        marked[SLAB - 400] = True
    ref = _jax_fill(vals, marked)
    before = forward_fill.launches
    got = forward_fill(torch.from_numpy(vals), torch.from_numpy(marked))
    assert forward_fill.launches == before            # CPU: plain
    np.testing.assert_array_equal(got.numpy(), ref)


def test_segmented_fill_rows_matches_jax():
    rng = np.random.default_rng(6)
    n, d, length = 60, 4, 3000
    # distinct slots (JAX leaves a shared slot's winner unspecified), some
    # past ``length``: inside JAX's padded buffer and beyond it
    slots = rng.choice(length + 600, n, replace=False).astype(np.int32)
    slots[0] = SLAB + 5
    rows = rng.normal(size=(n, d)).astype(np.float32)
    ref = np.asarray(j_segmented_fill_rows(
        jnp.asarray(rows), jnp.asarray(slots), length, interpret=True))
    got = segmented_fill_rows(torch.from_numpy(rows), torch.from_numpy(slots),
                              length)
    assert got.shape == (length, d)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_segmented_fill_rows_shared_slot_keeps_last_row():
    rows = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    slots = torch.tensor([3, 1, 3, 7, 6, 1], dtype=torch.int32)
    got = segmented_fill_rows(rows, slots, 6).numpy()
    ref = np.zeros((6, 2), np.float32)
    last = {}
    for i, s in enumerate(slots.tolist()):
        if 0 <= s < 6:
            last[s] = i            # later rows overwrite earlier ones
    cur = np.zeros(2, np.float32)
    for slot in range(6):
        if slot in last:
            cur = rows[last[slot]].numpy()
        ref[slot] = cur
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[1], rows[5].numpy())
    np.testing.assert_array_equal(got[3], rows[2].numpy())


@pytest.mark.parametrize("length", [3000, SLAB])
def test_segmented_fill_rows_refuses_negative_slots(length):
    """JAX wraps a negative slot modulo its buffer padded to SLAB slots:
    slot -1 is dropped at 3000 slots and lands on the last at SLAB. The
    port keeps no such padding and refuses the slot."""
    rows = np.arange(4, dtype=np.float32).reshape(2, 2) + 1
    slots = np.array([5, -1], np.int32)
    ref = np.asarray(j_segmented_fill_rows(
        jnp.asarray(rows), jnp.asarray(slots), length, interpret=True))
    np.testing.assert_array_equal(ref[-1], rows[0 if length < SLAB else 1])
    with pytest.raises(ValueError, match="negative slot -1"):
        segmented_fill_rows(torch.from_numpy(rows), torch.from_numpy(slots),
                            length)


@pytest.mark.parametrize("length, spans", [(0, 0), (1, 1), (1024, 1),
                                           (1025, 2), (1 << 20, 1024)])
def test_fill_spans_match_the_kernel(length, spans):
    """The wrapper sizes kernel H's aggregates one int a span of
    csrc/fill.cu's kSpan (kThreads x kItems slots); the launch refuses a
    smaller workspace."""
    src = (Path(__file__).resolve().parents[1] / "threedgrut_tpu_torch"
           / "csrc" / "fill.cu").read_text()
    threads, items = (int(re.search(rf"constexpr int {k} = (\d+);",
                                    src).group(1))
                      for k in ("kThreads", "kItems"))
    assert FILL_SPAN == threads * items
    assert fill_spans(length) == spans


def _loss(out):
    """tests/test_render_parity.py:49-61 with a zero target."""
    return (out["pred_features"] ** 2).mean() \
        + 0.1 * out["pred_opacity"].mean() + 0.01 * out["pred_dist"].mean()


@pytest.fixture(scope="module")
def flat_aligned_run():
    """The scene, and JAX render_gut's outputs and gradients with the flat
    grid and aligned segments (interpret mode), one run."""
    cam, state = make_test_scene(**SCENE)

    def loss(params):
        out = j_render_gut(cam, JUTConfig(), J_RC,
                           state.replace(params=params), SH_DEGREE,
                           interpret=True)
        return _loss(out), out

    (val, out), g = jax.value_and_grad(loss, has_aux=True)(state.params)
    return cam, state, float(val), {k: np.asarray(out[k]) for k in KEYS}, \
        {k: np.asarray(getattr(g, k)) for k in NAMES}


def test_flat_aligned_render_matches_port(flat_aligned_run):
    cam, state, _, ref, _ = flat_aligned_run
    tcam, model = torch_scene(cam, state)
    with torch.no_grad():
        out = render_gut(tcam, UTConfig(), RasterConfig(), model, SH_DEGREE)
    for k, tol in (("pred_features", 1e-4), ("pred_opacity", 1e-4),
                   ("pred_dist", 1e-3)):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=tol, rtol=0,
                                   err_msg=k)
    flips = out["hits_count"].numpy() != ref["hits_count"]
    assert flips.mean() < 0.01
    assert float(out["pred_opacity"].max()) > 0.5


def test_flat_aligned_grads_match_port(flat_aligned_run):
    cam, state, j_loss, _, ref = flat_aligned_run
    tcam, model = torch_scene(cam, state)
    loss = _loss(render_gut(tcam, UTConfig(), RasterConfig(), model,
                            SH_DEGREE))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-4)
    for k in NAMES:
        a = getattr(model, k).grad.numpy().astype(np.float64)
        b = ref[k].astype(np.float64)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-3, rtol=0,
                                   err_msg=k)
        cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.9999, (k, cos)
