"""The port's export modules (threedgrut_tpu_torch/export/: USD, USDC,
USDZ, PPISP and NuRec writers and readers, transcode, partition,
transforms, SH rotation, view interpolation and the SH bake) and their
front ends against the JAX package's (CPU).

Inputs come from numpy seeds. Tolerances, with reasons:
  * the writers, ``transcode`` and the numpy copies byte for byte and
    array for array: the same numpy arithmetic on the same inputs (the
    port's SH basis is the same float32 expression as ``jnp``'s, so the
    rotation's least squares see equal bytes);
  * NuRec: the payload equal after ``unpack_nurec`` and the volume layer
    byte for byte, not the file: the payload's gzip header holds the time
    of the write;
  * ``export_model_usda`` within 1e-6 relative: the rotation norm and
    the activations round their last bit differently in XLA and PyTorch;
  * SH rotation within 1e-5 (equal in practice, see above);
  * the toy bake's baked SH within 1e-5 (~7e-7 seen) and its loss
    history within 1e-5: Adam on gradients equal to ~6e-8, its fp32
    update formed in another order. With a warm start of 1.2 the losses
    are 1-12 and their residuals ~1, so the SH's ~7e-7 differences move
    the loss by up to ~4e-5: there the history is held within 5e-5
    relative;
  * ``bake_ppisp``'s targets (render, then the ISP) within 6.1e-5 of one
    jitted JAX render through JAX's ISP: the render parity tolerance of
    the port (the JAX raster kernel's split-bf16 products in interpret
    mode); its cameras and warm start equal to JAX's.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from scene_utils import make_test_scene
from threedgrut_tpu.export import crate as j_crate
from threedgrut_tpu.export import nurec as j_nurec
from threedgrut_tpu.export import partition as j_part
from threedgrut_tpu.export import sh_bake as j_bake
from threedgrut_tpu.export import sh_rotation as j_rot
from threedgrut_tpu.export import transcode as j_tc
from threedgrut_tpu.export import transforms as j_tf
from threedgrut_tpu.export import usd as j_usd
from threedgrut_tpu.export import view_interpolation as j_vi
from threedgrut_tpu.models.post_processing import apply_ppisp as j_apply_ppisp
from threedgrut_tpu.ops.ut import UTConfig as JUTConfig
from threedgrut_tpu.render.common import RasterConfig as JRasterConfig
from threedgrut_tpu.render.gut import render_gut as j_render_gut
from threedgrut_tpu.train.trainer import camera_from_batch as j_cam_from_batch
from threedgrut_tpu_torch.convert import model_from_state
from threedgrut_tpu_torch.data.protocols import Batch
from threedgrut_tpu_torch.export import crate as t_crate
from threedgrut_tpu_torch.export import nurec as t_nurec
from threedgrut_tpu_torch.export import partition as t_part
from threedgrut_tpu_torch.export import sh_bake as t_bake
from threedgrut_tpu_torch.export import sh_rotation as t_rot
from threedgrut_tpu_torch.export import transcode as t_tc
from threedgrut_tpu_torch.export import transforms as t_tf
from threedgrut_tpu_torch.export import usd as t_usd
from threedgrut_tpu_torch.export import view_interpolation as t_vi
from threedgrut_tpu_torch.models.gaussians import (GaussianModelConfig,
                                                   random_initialization)
from threedgrut_tpu_torch.ops.ut import UTConfig
from threedgrut_tpu_torch.render.common import RasterConfig
from threedgrut_tpu_torch.synthetic import nht_cloud
from threedgrut_tpu_torch.train import trainer as t_tr
from test_torch_trainer import _write_nerf_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
RENDER_TOL = 6.1e-5
BAKE_RES = (32, 32)


def _rand_attrs(n=40, deg=2, seed=0):
    """Post-activation attributes (tests/test_export.py's layout)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(positions=rng.normal(size=(n, 3)).astype(np.float32),
                orientations=q,
                scales=np.exp(rng.normal(-3, 1, (n, 3))).astype(np.float32),
                opacities=rng.uniform(0.01, 0.99, n).astype(np.float32),
                sh_coefficients=(rng.normal(size=(n, (deg + 1) ** 2, 3))
                                 * 0.3).astype(np.float32),
                sh_degree=deg)


def _ppisp_tables(rng, n_frames=3, n_cams=1):
    return {
        "exposure": (rng.normal(size=n_frames) * 0.3).astype(np.float32),
        "color_latents": (rng.normal(size=(n_frames, 8)) * 0.2).astype(
            np.float32),
        "responsivity": (rng.normal(size=n_cams) * 0.1).astype(np.float32),
        "vig_center": (rng.normal(size=(n_cams, 3, 2)) * 0.1).astype(
            np.float32),
        "vig_alpha": (rng.normal(size=(n_cams, 3, 3)) * 0.1 - 0.1).astype(
            np.float32),
        "crf": (rng.normal(size=(n_cams, 3, 4)) * 0.2).astype(np.float32),
    }


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_same_files(paths_a, paths_b):
    assert [os.path.basename(p) for p in paths_a] == \
        [os.path.basename(p) for p in paths_b]
    for a, b in zip(paths_a, paths_b):
        assert _read(a) == _read(b), (a, b)


def _assert_attrs_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)


# --- writers and readers ---------------------------------------------------

WRITERS = ("usda", "usda_half", "usdc", "usdz", "ppisp", "ppisp_append",
           "container", "add_file")


def _write(mod, case, path, attrs, ppisp, tmp):
    deg = attrs["sh_degree"]
    cams = [{"transform": np.eye(4) * 1.5, "focal": 24.0},
            {"transform": np.arange(16.0).reshape(4, 4)}]
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    if case in ("usda", "usda_half"):
        mod.export_usda(path, attrs, deg, cameras=cams, background_color=bg,
                        half=case == "usda_half")
    elif case == "usdc":
        mod.export_usda(path, attrs, deg, cameras=cams, background_color=bg)
    elif case == "usdz":
        mod.export_usdz(path, attrs, deg)
    elif case == "ppisp":
        mod.export_ppisp_usda(path, ppisp)
    elif case == "ppisp_append":
        mod.export_usda(path, attrs, deg)
        mod.export_ppisp_usda(path, ppisp, append=True)
    elif case == "container":
        mod.write_usdz_container(path, [("a.usda", b"#usda 1.0\n"),
                                        ("b.bin", bytes(range(200))),
                                        ("c/d.txt", b"x" * 77)])
    elif case == "add_file":
        mesh = os.path.join(tmp, "proxy.glb")
        with open(mesh, "wb") as f:
            f.write(bytes(range(256)) * 3)
        j_usd.export_usdz(path, attrs, deg)
        mod.add_file_to_usdz(path, mesh)
        mod.add_file_to_usdz(path, mesh, entry_name="meshes/proxy.glb")


@pytest.mark.parametrize("case", WRITERS)
def test_writers_are_byte_equal_to_jax(case, tmp_path):
    """export_usda (full, half, cameras and background), export_usdc,
    export_usdz, export_ppisp_usda (alone and appended),
    write_usdz_container and add_file_to_usdz write JAX's bytes."""
    attrs = _rand_attrs(seed=WRITERS.index(case))
    ppisp = _ppisp_tables(np.random.default_rng(7), n_frames=4, n_cams=2)
    ext = {"usdc": ".usdc", "usdz": ".usdz", "container": ".usdz",
           "add_file": ".usdz"}.get(case, ".usda")
    out = []
    for name, mod in (("jax", j_usd), ("port", t_usd)):
        path = str(tmp_path / f"{name}{ext}")
        _write(mod, case, path, attrs, ppisp, str(tmp_path))
        out.append(_read(path))
    assert out[0] == out[1]
    assert len(out[0]) > 100


READERS = ("usda", "usda_half", "usdc", "usdz", "ppisp")


@pytest.mark.parametrize("case", READERS)
def test_readers_return_jax_arrays(case, tmp_path):
    """import_usda, import_usdc (through crate.read), import_usdz and
    import_ppisp_usda on a file the JAX package wrote."""
    attrs = _rand_attrs(n=33, deg=3, seed=11)
    ppisp = _ppisp_tables(np.random.default_rng(3), n_frames=5)
    ext = {"usdc": ".usdc", "usdz": ".usdz"}.get(case, ".usda")
    path = str(tmp_path / f"in{ext}")
    _write(j_usd, case, path, attrs, ppisp, str(tmp_path))
    reader = {"usdc": "import_usdc", "usdz": "import_usdz",
              "ppisp": "import_ppisp_usda"}.get(case, "import_usda")
    got = getattr(t_usd, reader)(path)
    _assert_attrs_equal(got, getattr(j_usd, reader)(path))
    if case == "usdc":
        assert t_crate.read(path).prims().keys() == \
            j_crate.read(path).prims().keys()
    if case == "usda":   # 7 significant digits in the text
        np.testing.assert_allclose(got["positions"], attrs["positions"],
                                   rtol=1e-6)


def test_export_model_usda_writes_what_jax_writes(tmp_path):
    """The port's GaussianModel (rows past n_active, raw rotations,
    activated scale and density) against JAX's GaussianState export; an
    NHT model is refused."""
    _, state = make_test_scene(n=60, capacity=72, n_active=50, seed=4,
                               max_sh=2)
    model = model_from_state(state)
    j_usd.export_model_usda(state, str(tmp_path / "j.usda"))
    t_usd.export_model_usda(model, str(tmp_path / "t.usda"))
    ref = j_usd.import_usda(str(tmp_path / "j.usda"))
    got = t_usd.import_usda(str(tmp_path / "t.usda"))
    assert got["sh_degree"] == ref["sh_degree"] == 2
    assert got["positions"].shape == (50, 3)
    for k in ("positions", "orientations", "scales", "opacities",
              "sh_coefficients"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    with pytest.raises(ValueError, match="NHT"):
        t_usd.export_model_usda(nht_cloud(300, dim=16),
                                str(tmp_path / "n.usda"))


# --- NuRec -----------------------------------------------------------------

def _pre_attrs(n=37, seed=5):
    rng = np.random.default_rng(seed)
    return dict(positions=rng.normal(size=(n, 3)).astype(np.float32),
                rotations=rng.normal(size=(n, 4)).astype(np.float32),
                scales=rng.normal(-3, 1, (n, 3)).astype(np.float32),
                densities=rng.normal(size=(n, 1)).astype(np.float32),
                features_albedo=rng.normal(size=(n, 3)).astype(np.float32),
                features_specular=rng.normal(size=(n, 45)).astype(
                    np.float32))


def test_nurec_payload_matches_jax(tmp_path):
    """The volume layer byte for byte, the .nurec payload equal after
    unpack_nurec, and import_nurec_usdz's arrays and config."""
    attrs = _pre_attrs()
    tf = np.diag([2.0, 2.0, 2.0, 1.0])
    tf[:3, 3] = [0.5, -1.0, 2.0]
    paths = []
    for name, mod in (("j", j_nurec), ("t", t_nurec)):
        paths.append(mod.export_nurec_usdz(
            str(tmp_path / f"{name}.usdz"), attrs, 3,
            normalizing_transform=tf, ut_alpha=0.7, k_buffer_size=8))
    zips = [zipfile.ZipFile(p) for p in paths]
    assert zips[0].namelist() == zips[1].namelist() == ["gauss.usda",
                                                        "gauss.nurec"]
    assert zips[0].read("gauss.usda") == zips[1].read("gauss.usda")
    payloads = [t_nurec.unpack_nurec(z.read("gauss.nurec")) for z in zips]
    assert payloads[0] == payloads[1]
    assert j_nurec.unpack_nurec(zips[1].read("gauss.nurec")) == payloads[0]
    _assert_attrs_equal(
        {k: v for k, v in t_nurec.import_nurec_usdz(paths[1]).items()
         if k != "config"},
        {k: v for k, v in j_nurec.import_nurec_usdz(paths[0]).items()
         if k != "config"})
    assert t_nurec.import_nurec_usdz(paths[1])["config"] == \
        payloads[0]["nre_data"]["config"]


def test_nurec_raises_without_msgpack(monkeypatch, tmp_path):
    """No fallback encoding: without msgpack, packing, unpacking and the
    NuRec export raise."""
    template = t_nurec.build_nre_template(*_pre_attrs().values(), 3)
    data = t_nurec.pack_nurec(template)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="msgpack"):
        t_nurec.pack_nurec(template)
    with pytest.raises(ImportError, match="msgpack"):
        t_nurec.unpack_nurec(data)
    with pytest.raises(ImportError, match="msgpack"):
        t_nurec.export_nurec_usdz(str(tmp_path / "x.usdz"), _pre_attrs(), 3)
    assert not os.path.exists(tmp_path / "x.usdz")


# --- SH rotation, transforms, partition, view interpolation ----------------

def _rotation(seed):
    from scipy.spatial.transform import Rotation
    return Rotation.from_rotvec(np.random.default_rng(seed).normal(
        size=3)).as_matrix()


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_rotation_matches_jax(degree):
    rng = np.random.default_rng(degree)
    coeffs = rng.normal(size=(50, (degree + 1) ** 2, 3)).astype(np.float32)
    rot = _rotation(degree)
    got = t_rot.rotate_sh_coefficients(coeffs, rot, degree)
    ref = j_rot.rotate_sh_coefficients(coeffs, rot, degree)
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(t_rot.band_rotation_matrix(rot, degree),
                               j_rot.band_rotation_matrix(rot, degree),
                               atol=TOL, rtol=0)


def _poses(n=9, seed=0):
    """Camera-to-world poses on a jittered ring, looking inward."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        th = 2 * np.pi * i / n + rng.normal() * 0.2
        eye = np.array([3 * np.sin(th), 0.5 + rng.normal() * 0.3,
                        3 * np.cos(th)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, -1.0, 0.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
        c2w[:3, 3] = eye
        out.append(c2w)
    return np.stack(out)[rng.permutation(n)]


def _raw_attrs(n=200, seed=2):
    rng = np.random.default_rng(seed)
    return dict(positions=rng.normal(size=(n, 3)) * [3.0, 1.0, 0.5],
                rotation=rng.normal(size=(n, 4)),
                scale=rng.normal(-3, 1, (n, 3)),
                density=rng.normal(size=(n, 1)))


def _numpy_copy_case(case):
    """(port's, JAX's) results of one numpy-copy case."""
    poses = _poses()
    tf_mods, part_mods, vi_mods = (t_tf, j_tf), (t_part, j_part), (t_vi, j_vi)
    if case == "normalizing_transform":
        return [m.estimate_normalizing_transform(poses) for m in tf_mods]
    if case == "apply_transform":
        tf = j_tf.estimate_normalizing_transform(poses)
        return [m.apply_transform_to_gaussians(_raw_attrs(), tf)
                for m in tf_mods]
    if case == "kd_partition":
        pos = _raw_attrs(333)["positions"]
        out = []
        for m in part_mods:
            parts = m.kd_partition(pos, 50)
            out.append(dict(
                manifest=json.dumps(m.partitions_manifest(
                    parts, [f"p{i}" for i in range(len(parts))])),
                indices=np.concatenate([p.indices for p in parts]),
                sizes=np.asarray([p.num_gaussians for p in parts]),
                sliced=m.partition_attributes(_raw_attrs(333), parts)[3]))
        return out
    if case == "trajectory_order":
        return [dict(zip(("order", "cum"),
                         m.order_views_along_trajectory(poses)))
                for m in vi_mods]
    if case == "slerp_pose":
        return [np.stack([m.slerp_pose(poses[0], poses[k], s)
                          for k in (1, 4) for s in (0.0, 0.3, 1.0)])
                for m in vi_mods]
    if case == "view_sampler":
        out = []
        for m in vi_mods:
            smp = m.TrajectoryViewSampler(poses, seed=3)
            draws = [smp.sample(x) for x in (0.0, 0.17, 0.5, 0.99, 1.0)]
            draws += [smp.sample_random() for _ in range(3)]
            vals = np.arange(9 * 8, dtype=np.float32).reshape(9, 8)
            out.append(dict(
                poses=np.stack([p for p, _ in draws]),
                frames=np.asarray([f for _, f in draws]),
                lerp=np.stack([smp.interpolate_frame_values(vals, *f)
                               for _, f in draws])))
        return out
    raise ValueError(case)


NUMPY_CASES = ("normalizing_transform", "apply_transform", "kd_partition",
               "trajectory_order", "slerp_pose", "view_sampler")


@pytest.mark.parametrize("case", NUMPY_CASES)
def test_numpy_copies_match_jax(case):
    """estimate_normalizing_transform, apply_transform_to_gaussians,
    kd_partition with its manifest and partition_attributes,
    order_views_along_trajectory, slerp_pose and TrajectoryViewSampler
    equal JAX's."""
    got, ref = _numpy_copy_case(case)
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            if isinstance(ref[k], dict):
                _assert_attrs_equal(got[k], ref[k])
            elif isinstance(ref[k], str):
                assert got[k] == ref[k]
            else:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(ref[k]), err_msg=k)
    else:
        np.testing.assert_array_equal(got, ref)


# --- transcode on the port's checkpoint ------------------------------------

class _Views:
    """Port Batches (numpy fields both packages read) at ``poses``."""

    def __init__(self, poses, res=BAKE_RES):
        w, h = res
        self.batches = [Batch(
            rays_ori=np.zeros((h, w, 3), np.float32),
            rays_dir=np.zeros((h, w, 3), np.float32),
            T_to_world=np.asarray(p, np.float32),
            rgb_gt=np.zeros((h, w, 3), np.float32),
            intrinsics=[0.9 * w, 0.9 * w, w / 2, h / 2], frame_idx=i)
            for i, p in enumerate(poses)]

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return self.batches[i]

    def get_poses(self):
        return np.stack([b.T_to_world for b in self.batches])

    def get_scene_extent(self):
        return 3.0


def _port_checkpoint(path, nht=False):
    """A checkpoint that the port's Trainer.save_checkpoint wrote: 300
    live rows of 512, SH degree 2 with non-zero higher bands, or NHT."""
    if nht:
        model = nht_cloud(300, dim=16)
    else:
        model = random_initialization(GaussianModelConfig(max_sh_degree=2),
                                      300, extent=2.0, seed=1)
        rng = np.random.default_rng(1)
        model.set_params(features_specular=torch.tensor(rng.normal(
            size=tuple(model.features_specular.shape)).astype(np.float32)
            * 0.2))
    trainer = t_tr.Trainer(t_tr.TrainerConfig(), _Views(_poses(3)), model)
    trainer.save_checkpoint(path)
    return path


TRANSCODE_CASES = ("ply_to_usda", "merge", "partition", "transform")


@pytest.mark.parametrize("case", TRANSCODE_CASES)
def test_transcode_is_byte_equal_to_jax(case, tmp_path):
    """PLY -> USDA, a merge, a KD partition (files and manifest), and a
    normalizing transform with SH rotation, from a checkpoint the port's
    Trainer wrote: JAX's bytes. load_checkpoint_attrs reads JAX's
    arrays."""
    ckpt = _port_checkpoint(str(tmp_path / "ckpt.npz"))
    _assert_attrs_equal(t_tc.load_checkpoint_attrs(ckpt),
                        j_tc.load_checkpoint_attrs(ckpt))
    written = []
    for name, mod in (("j", j_tc), ("t", t_tc)):
        d = tmp_path / name
        d.mkdir()
        ply = str(d / "m.ply")
        mod.transcode([ckpt], ply)
        if case == "ply_to_usda":
            out = mod.transcode([ply], str(d / "m.usda"))
        elif case == "merge":
            out = mod.transcode([ckpt, ply], str(d / "merged.usda"))
        elif case == "partition":
            out = mod.transcode([ckpt], str(d / "parts.usdz"),
                                max_particles_per_partition=70)
            out.append(str(d / "parts_partitions.json"))
        else:
            tf = j_tf.estimate_normalizing_transform(_poses())
            out = mod.transcode([ply], str(d / "norm.usdc"), transform=tf)
            out += mod.transcode([ckpt], str(d / "norm.usda"), transform=tf)
        written.append([ply] + out)
    _assert_same_files(*written)
    if case == "partition":
        assert len(written[1]) == 1 + 8 + 1


def test_transcode_refuses_nht_checkpoint(tmp_path):
    """A departure by design: JAX stops on a KeyError (no
    features_specular); the port refuses by name, writing nothing."""
    ckpt = _port_checkpoint(str(tmp_path / "nht.npz"), nht=True)
    with pytest.raises(KeyError):
        j_tc.load_checkpoint_attrs(ckpt)
    with pytest.raises(ValueError, match="NHT"):
        t_tc.transcode([ckpt], str(tmp_path / "out.usdz"))
    assert not os.path.exists(tmp_path / "out.usdz")


# --- the SH bake -----------------------------------------------------------

@pytest.mark.parametrize("warm", [None, 1.2])
def test_toy_bake_matches_jax(warm):
    """tests/test_ppisp.py:139-169's toy linear renderer, 50 Adam
    iterations: the loss history and the baked SH."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    n, k = 32, 4
    alb = rng.normal(0, 0.2, (n, 1, 3)).astype(np.float32)
    spec = rng.normal(0, 0.05, (n, k - 1, 3)).astype(np.float32)
    basis = rng.normal(0, 1, (3, 8, n)).astype(np.float32)

    def j_render(a, s, fr):
        coeff = jnp.concatenate([a, s], axis=1)
        img = jnp.einsum("fpn,nkc->fpc", jnp.asarray(basis[fr:fr + 1]),
                         jnp.sum(coeff, axis=1, keepdims=True))[0]
        return (img + 0.5).reshape(2, 4, 3)

    def t_render(a, s, fr):
        coeff = torch.cat([a, s], dim=1)
        img = torch.einsum("fpn,nkc->fpc", torch.from_numpy(basis[fr:fr + 1]),
                           coeff.sum(dim=1, keepdim=True))[0]
        return (img + 0.5).reshape(2, 4, 3)

    kw = dict(frames=[0, 1, 2], iters=50, lr=5e-3, warm_start_scale=warm)
    ref = j_bake.bake_post_processing(j_render, lambda x, fr: x * 1.35,
                                      jnp.asarray(alb), jnp.asarray(spec),
                                      **kw)
    got = t_bake.bake_post_processing(t_render, lambda x, fr: x * 1.35,
                                      torch.from_numpy(alb),
                                      torch.from_numpy(spec), **kw)
    # the warm start leaves losses of ~1-12 that amplify the SH's ~1e-6
    # differences about 30 times (module docstring)
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"],
                               atol=TOL, rtol=0 if warm is None else 5e-5)
    for key in ("features_albedo", "features_specular"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=TOL, rtol=0, err_msg=key)
    assert got["loss_history"][-1] < got["loss_history"][0]


def test_warm_start_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    alb = rng.normal(size=(64, 3)).astype(np.float32)
    spec = rng.normal(size=(64, 45)).astype(np.float32)
    for s in (0.7, 1.0, 1.8123):
        ref = j_bake.scale_sh_warm_start(jnp.asarray(alb), jnp.asarray(spec),
                                         s)
        got = t_bake.scale_sh_warm_start(torch.from_numpy(alb),
                                         torch.from_numpy(spec), s)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


J_RC = JRasterConfig(max_pairs=4096, grad_fold=False, exact_kill=True)


@pytest.fixture(scope="module")
def bake_scene():
    """A 300-Gaussian scene, three 32x32 views around its front, ISP
    tables of three frames, and one jitted JAX render."""
    cam0, state = make_test_scene(n=300, seed=3, res=BAKE_RES, max_sh=2)
    poses = []
    for i, yaw in enumerate((-0.12, 0.0, 0.15)):
        c, s = np.cos(yaw), np.sin(yaw)
        c2w = np.eye(4)
        c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        c2w[:3, 3] = [0.4 * i - 0.4, 0.05 * i, 0.1 * i]
        poses.append(c2w)
    tables = _ppisp_tables(np.random.default_rng(21))
    render = jax.jit(j_render_gut, static_argnums=(1, 2, 4))
    return state, _Views(poses), tables, render


@pytest.mark.parametrize("sampling", ["training", "trajectory"])
def test_bake_ppisp_on_a_scene(bake_scene, sampling):
    """bake_ppisp on the CPU: its cameras and warm start equal JAX's
    (JAX sh_bake.py:130-165 on the same views), its first target (the
    port's render_gut, then apply_ppisp) within the render tolerance of
    JAX's render through JAX's ISP, and its loss falls."""
    import jax.numpy as jnp

    state, views, tables, j_render = bake_scene
    model = model_from_state(state)
    ppisp = {k: torch.tensor(v) for k, v in tables.items()}
    bv = t_bake.bake_views(ppisp, views, sampling, n_views=3)
    # JAX's views, as its bake_ppisp builds them
    ut = JUTConfig()
    if sampling == "trajectory":
        smp = j_vi.TrajectoryViewSampler(views.get_poses())
        j_cams, j_over = [], []
        for t in np.linspace(0.0, 1.0, 3):
            pose, (lo, hi, s) = smp.sample(float(t))
            b = dataclasses.replace(views[0],
                                    T_to_world=pose.astype(np.float32))
            j_cams.append(j_cam_from_batch(b, ut))
            j_over.append(tuple(jnp.asarray(smp.interpolate_frame_values(
                tables[k], lo, hi, s), jnp.float32)
                for k in ("exposure", "color_latents")))
        exp_warm = np.asarray([float(e) for e, _ in j_over])
        j_frames = [0] * 3
    else:
        j_cams = [j_cam_from_batch(views[i], ut) for i in range(3)]
        j_over = [(None, None)] * 3
        exp_warm = tables["exposure"][np.arange(3)]
        j_frames = [0, 1, 2]
    warm = 2.0 ** (float(tables["responsivity"][0])
                   + float(np.mean(exp_warm)))
    assert bv.warm_start_scale == warm
    assert bv.isp_frames == j_frames
    for tc, jc in zip(bv.cams, j_cams):
        for k in ("t_start", "q_start", "focal", "principal"):
            np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                          np.asarray(getattr(jc, k)),
                                          err_msg=k)
    for (te, tl), (je, jl) in zip(bv.isp_overrides, j_over):
        if je is None:
            assert te is None and tl is None
        else:
            np.testing.assert_array_equal(te.numpy(), np.asarray(je))
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))

    out = t_bake.bake_ppisp(model, ppisp, views, UTConfig(), RasterConfig(),
                            2, iters=9, lr=5e-3, view_sampling=sampling,
                            n_views=3)
    j_out = j_render(j_cams[0], ut, J_RC, state, 2)
    assert int(j_out["pairs_overflow"]) == 0
    ref = j_apply_ppisp({k: jnp.asarray(v) for k, v in tables.items()},
                        j_out["pred_features"], 0, j_frames[0],
                        exposure=j_over[0][0], color_latents=j_over[0][1])
    got = out["targets"][0].numpy()
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    np.testing.assert_allclose(got, np.asarray(ref), atol=RENDER_TOL, rtol=0)
    hist = np.asarray(out["loss_history"])
    assert hist.shape == (9,) and np.all(np.isfinite(hist))
    # the objective is the mean over the views cycled through: a view
    # whose exposure is far from the others' may rise while it falls
    assert hist[-3:].mean() < hist[:3].mean()
    assert out["features_albedo"].shape == model.features_albedo.shape
    # the model is left as it was
    np.testing.assert_array_equal(model.features_albedo.detach().numpy(),
                                  np.asarray(state.params.features_albedo))


# --- front ends --------------------------------------------------------------

def _run(args, cwd=REPO):
    return subprocess.Popen([sys.executable, *args], cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out + err
    return out


def _launches(out):
    line = [ln for ln in out.splitlines() if ln.startswith("launches:")]
    return json.loads(line[-1].split(":", 1)[1])


def test_front_ends_run_on_the_cpu(tmp_path):
    """Each _torch export script and the bake tool, once, as a CPU
    subprocess on a PPISP checkpoint of a 48 px NeRF-synthetic capture
    (the port's Trainer wrote it with its config): export_usd with a
    transform, transcode with --normalize and a partition,
    filter_visibility, the three bake modes, then ply_to_usd on the
    filtered PLY, sh_bake_validation on the export and add_mesh_to_usdz.
    Where they write what an in-process call writes, the bytes agree."""
    from threedgrut_tpu_torch.config.loader import load_config
    from train_torch import make_dataset, make_model, trainer_config

    data = str(tmp_path / "data")
    _write_nerf_dataset(data)
    over = [f"path={data}", "post_processing.method=ppisp",
            "initialization.num_gaussians=300"]
    conf = load_config("apps/nerf_synthetic_3dgut", overrides=over)
    ds = make_dataset(conf, "train")
    trainer = t_tr.Trainer(trainer_config(conf), ds,
                           make_model(conf, ds, "cpu"), raw_conf=conf)
    tables = _ppisp_tables(np.random.default_rng(4), n_frames=len(ds))
    for k, v in tables.items():
        trainer.ppisp_params[k].data.copy_(torch.tensor(v))
    trainer.n_active_features = 1
    ckpt = str(tmp_path / "ckpt.npz")
    trainer.save_checkpoint(ckpt)
    tf = str(tmp_path / "tf.npy")
    np.save(tf, t_tf.estimate_normalizing_transform(ds.get_poses()))
    p = {k: str(tmp_path / k) for k in (
        "model.usdz", "parts.usda", "vis.ply", "vis.usdz", "ppisp.usda",
        "bake", "mesh.glb")}
    procs = [
        _run(["scripts/export_usd_torch.py", ckpt, p["model.usdz"],
              "--transform", tf]),
        _run(["scripts/transcode_torch.py", ckpt, p["parts.usda"],
              "--normalize", "--max-particles", "160"]),
        _run(["scripts/filter_visibility_torch.py", "--checkpoint", ckpt,
              "--out", p["vis.ply"], "--device", "cpu", *over]),
        _run(["tools/ppisp_export/bake_modes_benchmark_torch.py",
              "--checkpoint", ckpt, "--path", data, "--iters", "4",
              "--n-views", "2", "--out-dir", p["bake"], "--device", "cpu"])]
    export, parts, vis, bake = [_finish(q) for q in procs]

    assert "300 particles, sh_degree=3" in export
    ref = str(tmp_path / "ref.usdz")
    attrs = t_tc.load_checkpoint_attrs(ckpt)
    raw = t_tf.apply_transform_to_gaussians(t_tc.activated_to_raw(attrs),
                                            np.load(tf))
    rs = np.load(tf)[:3, :3]
    sh = t_rot.rotate_sh_coefficients(
        attrs["sh_coefficients"], rs / np.cbrt(abs(np.linalg.det(rs))), 3)
    raw.update(features_albedo=sh[:, 0], features_specular=sh[:, 1:].reshape(
        300, -1))
    t_usd.export_usdz(ref, t_tc.raw_to_activated(raw), 3)
    assert _read(ref) == _read(p["model.usdz"])
    assert len(parts.split()) == 2
    with open(str(tmp_path / "parts_partitions.json")) as f:
        assert [q["num_gaussians"] for q in json.load(f)["partitions"]] == \
            [150, 150]

    n_vis = int(vis.split("visible: ")[1].split(" /")[0])
    assert 0 < n_vis <= 300
    assert _launches(vis) == {}       # the CPU runs the plain versions
    rows = [json.loads(ln) for ln in bake.splitlines() if ln.startswith("{")]
    assert [r["mode"] for r in rows] == ["simple", "fit-training",
                                         "fit-trajectory"]
    assert all(np.isfinite(r["psnr_mean"]) for r in rows)
    assert all(r["loss_last"] < r["loss_first"] for r in rows[1:])
    with open(os.path.join(p["bake"], "metrics.json")) as f:
        assert len(json.load(f)) == 3

    t_usd.export_ppisp_usda(p["ppisp.usda"], tables)
    with open(p["mesh.glb"], "wb") as f:
        f.write(b"glTF" + bytes(60))
    shutil.copy(p["model.usdz"], str(tmp_path / "mesh.usdz"))
    procs = [
        _run(["scripts/ply_to_usd_torch.py", p["vis.ply"]]),
        _run(["scripts/sh_bake_validation_torch.py", p["model.usdz"],
              p["ppisp.usda"], "--frame", "2", "--device", "cpu"]),
        _run(["scripts/add_mesh_to_usdz_torch.py",
              str(tmp_path / "mesh.usdz"), p["mesh.glb"]])]
    to_usd, valid, mesh = [_finish(q) for q in procs]
    assert to_usd.split() == [p["vis.usdz"]]
    assert t_usd.import_usdz(p["vis.usdz"])["positions"].shape == (n_vis, 3)
    assert valid.splitlines()[-1] == "OK"
    assert mesh.split() == ["model.usda", "mesh.glb"]


CARD_FRONT_ENDS = {
    "scripts/filter_visibility_torch.py": ["--checkpoint", "c.npz",
                                           "--out", "o.ply"],
    "scripts/sh_bake_validation_torch.py": ["a.usdz", "p.usda"],
    "tools/ppisp_export/bake_modes_benchmark_torch.py": [
        "--checkpoint", "c.npz", "--path", "d"],
}


@pytest.mark.parametrize("script", sorted(CARD_FRONT_ENDS))
def test_card_front_ends_refuse_without_a_card(script, monkeypatch):
    """Without a card and without --device cpu, the rendering front ends
    stop naming the flag."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "front_end", os.path.join(REPO, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        mod.main(CARD_FRONT_ENDS[script])
