"""The port's own data loaders, a rolling-shutter train step and the
training CLI on a generated ScanNet++ (fisheye COLMAP) capture, against
the JAX package (CPU).

Tolerances: poses, intrinsics and points equal to float32 rounding (the
same arithmetic on the same bytes); the train step's loss within 1e-4
relative and its parameters within 1e-4, as tests/test_torch_trainer.py
holds a pinhole step.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_colmap import write_synthetic_colmap
from test_torch_trainer import _trainers
from threedgrut_tpu.data.colmap import ColmapDataset as JColmapDataset
from threedgrut_tpu.data.protocols import Batch
from threedgrut_tpu_torch.data.colmap import ColmapDataset
from threedgrut_tpu_torch.models.gaussians import PARAM_NAMES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (48, 32)


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    return write_synthetic_colmap(str(tmp_path_factory.mktemp("colmap")))


@pytest.mark.parametrize("split", ["train", "test"])
def test_colmap_dataset_matches_jax(colmap_dir, split):
    """The port's COLMAP loader on tests/test_colmap.py's capture (one
    OPENCV camera): poses, intrinsics, images, rays and points."""
    got = ColmapDataset(colmap_dir, split)
    ref = JColmapDataset(colmap_dir, split)
    assert len(got) == len(ref) > 0
    np.testing.assert_array_equal(got.get_poses(), ref.get_poses())
    assert got.get_scene_extent() == ref.get_scene_extent()
    for i in range(len(got)):
        g, r = got[i], ref[i]
        np.testing.assert_array_equal(g.rgb_gt, r.rgb_gt)
        np.testing.assert_array_equal(g.rays_dir, r.rays_dir)
        assert g.intrinsics == r.intrinsics
        gi = g.intrinsics_OpenCVPinholeCameraModelParameters
        ri = r.intrinsics_OpenCVPinholeCameraModelParameters
        assert set(gi) == set(ri)
        for k in gi:
            np.testing.assert_array_equal(np.asarray(gi[k]),
                                          np.asarray(ri[k]), err_msg=k)
    for a, b in zip(got.load_points3d(), ref.load_points3d()):
        np.testing.assert_array_equal(a, b)


class RollingViews:
    """Two views behind a rolling shutter (top to bottom; the end pose
    0.06 to the right and turned 0.01 rad), GT seeded noise."""

    def __init__(self):
        rng = np.random.default_rng(3)
        w, h = RES
        self.batches = []
        for v in range(2):
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, 3] = [0.1 * v, -0.05, 0.0]
            end = c2w.copy()
            end[0, 3] += 0.06
            c, s = np.cos(0.01), np.sin(0.01)
            end[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            self.batches.append(Batch(
                rays_ori=np.zeros((h, w, 3), np.float32),
                rays_dir=np.zeros((h, w, 3), np.float32), T_to_world=c2w,
                T_to_world_end=end, shutter_type="rolling_top_to_bottom",
                rgb_gt=rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
                intrinsics=[0.9 * w, 0.9 * w, w / 2, h / 2], frame_idx=v))

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return self.batches[i]

    def get_scene_extent(self):
        return 3.0

    def get_poses(self):
        return np.stack([b.T_to_world for b in self.batches])


def test_rolling_train_step_matches_jax():
    """Two rolling-shutter train steps of the port's Trainer (the general
    mode's kernels' plain versions, the shutter-aware UT) against the JAX
    trainer's steps: the losses and every updated parameter."""
    views = RollingViews()
    jt, tt = _trainers(views)
    for step in range(2):
        jm = jt.train_iteration(views[step])
        tm = tt.train_iteration(views[step])
        np.testing.assert_allclose(tm["total"], float(jm["total"]),
                                   rtol=1e-4, err_msg=f"step {step}")
    assert tt.model.n_active == int(jt.model.n_active)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(getattr(tt.model, k).detach().numpy(),
                                   np.asarray(getattr(jt.model.params, k)),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_train_cli_scannetpp_fisheye(tmp_path):
    """train_torch.py --config-name apps/scannetpp_3dgut on a generated
    6-view fisheye ScanNet++ capture at 64x48 (synthetic.py:
    write_colmap_scene), initialised from its COLMAP points: 5 steps,
    a checkpoint and final_metrics.json on the held-out view."""
    import torch

    from threedgrut_tpu_torch.synthetic import (build_teacher,
                                                teacher_dataset,
                                                write_colmap_scene)

    teacher = build_teacher(2000, seed=0)
    ds = teacher_dataset(teacher, n_views=6, camera="fisheye",
                         resolution=(64, 48), background=0.0)
    data = str(tmp_path / "scannetpp")
    write_colmap_scene(data, ds, teacher, n_points=400)
    out = str(tmp_path / "out")
    res = subprocess.run(
        [sys.executable, "train_torch.py", "--config-name",
         "apps/scannetpp_3dgut", "--device", "cpu", f"path={data}",
         "n_iterations=5", f"out_dir={out}", "experiment_name=cli",
         "log_frequency=0.05"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "step 5:" in res.stdout
    with np.load(os.path.join(out, "cli", "ckpt_last.npz")) as f:
        assert int(f["global_step"]) == 5
        assert int(f["n_active"]) == 400            # the COLMAP points
    with open(os.path.join(out, "cli", "final_metrics.json")) as f:
        final = json.load(f)
    assert final["n_iterations"] == 5 and np.isfinite(final["psnr"])
    assert torch.tensor(0.0).device.type == "cpu"


def test_train_cli_refuses_ncore():
    """apps/ncore_3dgut needs the NCore SDK, which is not in the
    repository: the CLI says so."""
    import train_torch
    from threedgrut_tpu_torch.config.loader import load_config

    conf = load_config("apps/ncore_3dgut", overrides=["path=none"])
    with pytest.raises(NotImplementedError, match="NCore SDK"):
        train_torch.make_dataset(conf, "train")
    tconf = train_torch.trainer_config(conf)
    assert tconf.ut.n_rolling_shutter_iterations == 5
