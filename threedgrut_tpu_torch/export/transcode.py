"""Any-to-any transcoding between PLY (pre-activation) and USDA
(post-activation) gaussian assets, with optional multi-input merge,
normalizing transform and partitioning (copied from
threedgrut_tpu/export/transcode.py, on the port's ``export/ply.py``).

One departure: ``load_checkpoint_attrs`` refuses an NHT checkpoint,
which has no SH coefficients to write (the JAX function stops there
with a ``KeyError`` on ``features_specular``).

Reference: threedgrut/export/scripts/transcode.py (768 LoC) + the
adapter/accessor layer (export/{accessor,adapter}.py).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from . import ply as ply_mod
from . import usd as usd_mod
from .partition import kd_partition, partition_attributes, partitions_manifest
from .transforms import apply_transform_to_gaussians


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _logit(x):
    x = np.clip(x, 1e-7, 1.0 - 1e-7)
    return np.log(x / (1.0 - x))


def raw_to_activated(raw: dict) -> dict:
    """PLY raw params -> post-activation USD attrs (exp scale, sigmoid
    density, normalized quats, coefficient-major SH [N,K,3])."""
    n = raw["positions"].shape[0]
    spec = raw["features_specular"]
    k = spec.shape[1] // 3 + 1
    sh = np.concatenate([raw["features_albedo"][:, None, :],
                         spec.reshape(n, k - 1, 3)], axis=1)
    q = raw["rotation"]
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    return dict(positions=raw["positions"],
                orientations=q,
                scales=np.exp(raw["scale"]),
                opacities=_sigmoid(raw["density"][:, 0]),
                sh_coefficients=sh,
                sh_degree=int(np.sqrt(k)) - 1)


def activated_to_raw(attrs: dict) -> dict:
    """USD attrs -> PLY raw params (inverse activations)."""
    sh = attrs["sh_coefficients"]
    n, k, _ = sh.shape
    return dict(positions=attrs["positions"],
                rotation=attrs["orientations"],
                scale=np.log(np.maximum(attrs["scales"], 1e-30)),
                density=_logit(attrs["opacities"])[:, None],
                features_albedo=sh[:, 0, :],
                features_specular=sh[:, 1:, :].reshape(n, -1))


def load_checkpoint_attrs(path: str) -> dict:
    """Trainer checkpoint (.npz, see trainer.save_checkpoint; both
    trainers write the same keys) -> attrs. SH checkpoints only."""
    with np.load(path) as data:
        if "params/features" in data.files:
            raise ValueError(
                f"{path} is an NHT checkpoint: its particles carry NHT "
                "features, not SH coefficients, so there is no SH asset "
                "to write")
        n = int(data["n_active"]) if "n_active" in data else None
        raw = {k.split("/", 1)[1]: np.asarray(data[k])
               for k in data.files if k.startswith("params/")
               and k.count("/") == 1}
    if n is not None:
        raw = {k: v[:n] if v.ndim >= 1 and v.shape[0] >= n else v
               for k, v in raw.items()}
    return raw_to_activated(raw)


def load_any(path: str) -> dict:
    """Load a gaussian asset -> post-activation attrs dict."""
    if path.endswith(".ply"):
        return raw_to_activated(ply_mod.import_ply(path))
    if path.endswith(".usda"):
        return usd_mod.import_usda(path)
    if path.endswith(".usdc"):
        return usd_mod.import_usdc(path)
    if path.endswith(".usdz"):
        return usd_mod.import_usdz(path)
    if path.endswith(".npz"):
        return load_checkpoint_attrs(path)
    raise ValueError(f"unsupported input format: {path}")


def save_any(path: str, attrs: dict):
    if path.endswith(".ply"):
        raw = activated_to_raw(attrs)
        ply_mod.export_ply(path, raw["positions"], raw["rotation"],
                           raw["scale"], raw["density"],
                           raw["features_albedo"], raw["features_specular"])
        return
    if path.endswith((".usda", ".usdc")):
        usd_mod.export_usda(path, attrs, sh_degree=attrs.get("sh_degree", 3))
        return
    if path.endswith(".usdz"):
        usd_mod.export_usdz(path, attrs, sh_degree=attrs.get("sh_degree", 3))
        return
    raise ValueError(f"unsupported output format: {path}")


def merge(attr_list: List[dict]) -> dict:
    """Concatenate multiple assets (degrees must match)."""
    deg = attr_list[0].get("sh_degree", 3)
    if any(a.get("sh_degree", 3) != deg for a in attr_list):
        raise ValueError("cannot merge assets with different SH degrees")
    keys = ["positions", "orientations", "scales", "opacities",
            "sh_coefficients"]
    out = {k: np.concatenate([a[k] for a in attr_list]) for k in keys}
    out["sh_degree"] = deg
    return out


def transcode(inputs: List[str], output: str,
              transform: Optional[np.ndarray] = None,
              max_particles_per_partition: Optional[int] = None) -> List[str]:
    """Convert/merge/transform/partition assets. Returns written paths."""
    attrs = merge([load_any(p) for p in inputs]) if len(inputs) > 1 \
        else load_any(inputs[0])

    if transform is not None:
        raw = activated_to_raw(attrs)
        raw = apply_transform_to_gaussians(raw, transform)
        deg = attrs["sh_degree"]
        from .sh_rotation import rotate_sh_coefficients
        rot_scale = transform[:3, :3]
        s = float(np.cbrt(abs(np.linalg.det(rot_scale))))
        sh = rotate_sh_coefficients(attrs["sh_coefficients"],
                                    rot_scale / s, deg)
        attrs = raw_to_activated(dict(raw, features_albedo=sh[:, 0, :],
                                      features_specular=sh[:, 1:, :].reshape(
                                          sh.shape[0], -1)))
        attrs["sh_degree"] = deg

    if not max_particles_per_partition:
        save_any(output, attrs)
        return [output]

    parts = kd_partition(attrs["positions"], max_particles_per_partition)
    if len(parts) == 1:
        save_any(output, attrs)
        return [output]
    stem, ext = os.path.splitext(output)
    attr_keys = {k: v for k, v in attrs.items() if isinstance(v, np.ndarray)
                 and v.ndim >= 1 and v.shape[0] == attrs["positions"].shape[0]}
    written = []
    import json
    for i, sub in enumerate(partition_attributes(attr_keys, parts)):
        sub["sh_degree"] = attrs["sh_degree"]
        path = f"{stem}_partition_{i:03d}{ext}"
        save_any(path, sub)
        written.append(path)
    manifest = partitions_manifest(parts, [os.path.basename(w)
                                           for w in written])
    with open(f"{stem}_partitions.json", "w") as f:
        json.dump(manifest, f, indent=2)
    return written
