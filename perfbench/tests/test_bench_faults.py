"""The correctness check at a small size on the CPU: a run with the timed
path broken underneath comes out not correct, once for each fault the
cells can have; the control (the reference in TF32 in the program's
place) and the planted faults read above the limits, the program
below."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import control, harness, run
from perfbench.tests.conftest import WINDOW_S

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def small_run(small, cell):
    return run.run_cell(harness.resolve_cell(cell, small), SEED, WINDOW_S,
                        False, CPU)


@pytest.mark.parametrize("cell", ["colmap_3dgut_mcmc.train",
                                  "cusfm_3dgut_mcmc.train"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(small, cell,
                                                          monkeypatch):
    from threedgrut_tpu_torch.optimizers import adam

    def still(params, grads, state, lrs, **kw):
        return dataclasses.replace(state, step=state.step + 1)

    monkeypatch.setattr(adam, "adam_step", still)
    out = small_run(small, cell)
    assert not out["correct"]
    # the moments stay 0, so every row reads as one relocate involved, and
    # rows are compared one by one
    assert out["checks"]["relocate_gap"]["value"] > 0.5


@pytest.mark.parametrize("cell", ["colmap_3dgut_mcmc.train",
                                  "cusfm_3dgut_mcmc.train"])
def test_half_the_batch_left_out_is_caught(small, cell, monkeypatch):
    from threedgrut_tpu_torch.train.trainer import Trainer

    loss = Trainer.loss

    def half(self, out, rgb_gt, frame_idx=0):
        h = rgb_gt.shape[0] // 2
        cut = {k: (v[:h] if k.startswith("pred_") else v)
               for k, v in out.items()}
        total, losses, pred = loss(self, cut, rgb_gt[:h], frame_idx)
        return total, losses, torch.cat([pred, rgb_gt[h:]])

    monkeypatch.setattr(Trainer, "loss", half)
    out = small_run(small, cell)
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > 0.05


@pytest.mark.parametrize("cell", ["colmap_3dgut_mcmc.train",
                                  "cusfm_3dgut_mcmc.train"])
def test_a_skipped_relocate_is_caught(small, cell, monkeypatch):
    from threedgrut_tpu_torch.strategy import mcmc

    monkeypatch.setattr(mcmc, "relocate", lambda *a, **kw: 0)
    out = small_run(small, cell)
    assert not out["correct"]
    assert out["checks"]["relocate_gap"]["value"] > 0.5


@pytest.mark.parametrize("cell", ["colmap_3dgut_mcmc.train",
                                  "cusfm_3dgut_mcmc.train"])
def test_a_relocate_without_its_rescale_is_caught(small, cell, monkeypatch):
    from threedgrut_tpu_torch.strategy import mcmc

    monkeypatch.setattr(mcmc, "compute_relocation",
                        lambda op, scales, ratios, n_max=51: (op, scales))
    out = small_run(small, cell)
    assert not out["correct"]
    assert out["checks"]["relocate_gap"]["value"] > 0.5


def test_an_altered_frame_is_caught(small, monkeypatch):
    from threedgrut_tpu_torch.render import serve

    render_gut = serve.render_gut

    def altered(*a, **kw):
        out = dict(render_gut(*a, **kw))
        img = out["pred_features"].clone()
        img[:img.shape[0] // 10] += 2.0 / 255.0
        out["pred_features"] = img
        return out

    monkeypatch.setattr(serve, "render_gut", altered)
    out = small_run(small, "cusfm_3dgut_mcmc.serve")
    assert not out["correct"]
    assert out["checks"]["flip_share"]["value"] > 0.05


@pytest.mark.parametrize("cell", ["colmap_3dgut_mcmc.train",
                                  "cusfm_3dgut_mcmc.train",
                                  "cusfm_3dgut_mcmc.serve"])
def test_control_and_faults_read_above_the_limits(small, cell):
    c = harness.resolve_cell(cell, small)
    r = control.readings(c, SEED + 1, WINDOW_S, CPU)
    assert all(v <= c.limits[k] for k, v in r.pop("program").items())
    for kind, numbers in r.items():
        assert any(v > c.limits[k] for k, v in numbers.items()), kind
