"""validate_torch.py against validate.py.

CPU. The 3DGUT + SH experiment (validate.py:run_experiment: MCMC,
capacity 256, SH degree 2, 128 seeded initial points) trains 3 steps in
both packages on the same 32x32 teacher views; steps 1-3 come before
relocate and add (from step 20), and the per-step perturbation gets the
same normal noise in both, so no random draw differs. Validation PSNR
within 1e-3 dB and SSIM within 1e-3 (the trainer tests' tolerances),
the same Gaussian count. The CLI runs its
three experiments through the port only.
"""

import os
import sys

import numpy as np
import pytest
import torch

from threedgrut_tpu.data.protocols import Batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class TeacherViews:
    """synthetic.py:teacher_dataset's views as JAX Batches (numpy
    fields), which both trainers read."""

    def __init__(self, n_views=3, side=32):
        from threedgrut_tpu_torch.synthetic import (build_teacher,
                                                    teacher_dataset)

        ds = teacher_dataset(build_teacher(20000, seed=0), n_views=n_views,
                             side=side, background=0.0)
        self.extent = ds.get_scene_extent()
        self.batches = [Batch(
            rays_ori=np.zeros((side, side, 3), np.float32),
            rays_dir=np.zeros((side, side, 3), np.float32),
            T_to_world=np.asarray(v.T_to_world, np.float32),
            rgb_gt=v.rgb_gt.numpy(), intrinsics=list(v.intrinsics),
            frame_idx=i) for i, v in enumerate(ds.views)]

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return self.batches[i]

    def get_scene_extent(self):
        return self.extent

    def get_poses(self):
        return np.stack([b.T_to_world for b in self.batches])


def test_gut_sh_experiment_matches_jax(monkeypatch):
    """MCMC perturbs the positions every step from step 0 with normal
    noise: both packages get the same noise (as
    tests/test_torch_mcmc.py::test_perturb_matches_jax_given_noise)."""
    import jax
    import jax.numpy as jnp
    import validate
    import validate_torch
    from threedgrut_tpu_torch.strategy import mcmc as t_mcmc

    noise = np.random.default_rng(6).normal(size=(256, 3)).astype(np.float32)
    normal = jax.random.normal

    def fixed_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise, dtype)
        return normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", fixed_normal)
    perturb = t_mcmc.perturb
    monkeypatch.setattr(t_mcmc, "perturb", lambda *a, **k: perturb(
        *a, noise=torch.from_numpy(noise), **k))
    views = TeacherViews()
    ref = validate.run_experiment("3DGUT + SH", "sh", False, views, 3)
    got = validate_torch.run_experiment("3DGUT + SH", "sh", False, views, 3)
    print("jax", ref, "port", got)
    assert got["name"] == ref["name"]
    assert got["psnr"] == pytest.approx(ref["psnr"], abs=1e-3)
    assert got["ssim"] == pytest.approx(ref["ssim"], abs=1e-3)
    assert got["n_gaussians"] == ref["n_gaussians"] == 128


def test_validate_cli_writes_three_rows(tmp_path, monkeypatch):
    import validate_torch

    out = str(tmp_path / "report.md")
    rows = validate_torch.main(["--iterations", "3", "--out", out,
                                "--device", "cpu"])
    assert [r["name"] for r in rows] == [e[0] for e in
                                         validate_torch.EXPERIMENTS]
    for r in rows:
        assert np.isfinite(r["psnr"]) and np.isfinite(r["ssim"]), r
        assert r["n_gaussians"] == 128
    with open(out) as f:
        text = f.read()
    assert "dataset: 6 views 64x64 of synthetic.py:build_teacher" in text
    assert sum(ln.startswith("| 3D") for ln in text.splitlines()) == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        validate_torch.main(["--out", out])
