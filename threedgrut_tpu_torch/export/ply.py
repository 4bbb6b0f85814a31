"""3DGS-compatible PLY export and import, and the plain point-cloud
reader (copied from threedgrut_tpu/export/ply.py:21-167, numpy and
struct only; ``import_model`` is ``GaussianModel.from_ply``).

Binary little-endian vertex properties x, y, z, nx, ny, nz (zeros),
f_dc_0..2, f_rest_0..(3K-4) (channel-major on disk, coefficient-major
in memory), opacity (raw), scale_0..2 (raw log-scale), rot_0..3 (raw
wxyz quaternion): the file the reference and the wider 3DGS ecosystem
read, written byte for byte as the JAX package writes it.
"""

from __future__ import annotations

import numpy as np


def export_ply(path: str, positions: np.ndarray, rotation: np.ndarray,
               scale: np.ndarray, density: np.ndarray,
               features_albedo: np.ndarray, features_specular: np.ndarray):
    """Write raw (pre-activation) parameters as a 3DGS PLY."""
    n = positions.shape[0]
    spec_dim = features_specular.shape[1]
    fields = (
        [("x", "f4"), ("y", "f4"), ("z", "f4"),
         ("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
        + [(f"f_dc_{i}", "f4") for i in range(3)]
        + [(f"f_rest_{i}", "f4") for i in range(spec_dim)]
        + [("opacity", "f4")]
        + [(f"scale_{i}", "f4") for i in range(3)]
        + [(f"rot_{i}", "f4") for i in range(4)]
    )
    arr = np.zeros(n, dtype=fields)
    arr["x"], arr["y"], arr["z"] = positions.T.astype(np.float32)
    for i in range(3):
        arr[f"f_dc_{i}"] = features_albedo[:, i]
    # f_rest is channel-major on disk ([3, K-1] per point), coefficient-
    # major ([K-1, 3]) in memory
    k1 = spec_dim // 3
    spec = features_specular.reshape(n, k1, 3).transpose(0, 2, 1).reshape(
        n, spec_dim)
    for i in range(spec_dim):
        arr[f"f_rest_{i}"] = spec[:, i]
    arr["opacity"] = density[:, 0]
    for i in range(3):
        arr[f"scale_{i}"] = scale[:, i]
    for i in range(4):
        arr[f"rot_{i}"] = rotation[:, i]

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in fields]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(arr.tobytes())


def _read_vertices(path: str):
    """(structured vertex array, property names) of a binary little-endian
    PLY's vertex element."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    n = 0
    props = []
    fmt = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property" and len(parts) == 3:
            props.append((parts[2], parts[1]))
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    typemap = {"float": "f4", "float32": "f4", "double": "f8",
               "uchar": "u1", "int": "i4", "uint": "u4"}
    dtype = np.dtype([(name, typemap[t]) for name, t in props])
    arr = np.frombuffer(data[header_end:header_end + n * dtype.itemsize],
                        dtype=dtype)
    return arr, [name for name, _ in props]


def import_ply(path: str):
    """Read a 3DGS PLY -> dict of raw parameter arrays.

    Returns dict(positions [N,3], rotation [N,4], scale [N,3],
    density [N,1], features_albedo [N,3], features_specular [N,S]).
    """
    arr, names = _read_vertices(path)
    n = arr.shape[0]

    def col(name):
        return np.ascontiguousarray(arr[name]).astype(np.float32)

    positions = np.stack([col("x"), col("y"), col("z")], axis=1)
    rotation = np.stack([col(f"rot_{i}") for i in range(4)], axis=1)
    scale = np.stack([col(f"scale_{i}") for i in range(3)], axis=1)
    density = col("opacity")[:, None]
    albedo = np.stack([col(f"f_dc_{i}") for i in range(3)], axis=1)
    rest_names = sorted([nm for nm in names if nm.startswith("f_rest_")],
                        key=lambda s: int(s.split("_")[-1]))
    if rest_names:
        spec = np.stack([col(nm) for nm in rest_names], axis=1)
        k1 = spec.shape[1] // 3
        # channel-major on disk -> coefficient-major in memory
        spec = spec.reshape(-1, 3, k1).transpose(0, 2, 1).reshape(
            spec.shape[0], -1)
    else:
        spec = np.zeros((n, 0), np.float32)
    return dict(positions=positions, rotation=rotation, scale=scale,
                density=density, features_albedo=albedo,
                features_specular=spec)


def export_model(model, path: str):
    """Export a ``GaussianModel``'s live particles (threedgrut
    PLYExporter). SH models only, as in the JAX package, whose NHT
    models have no albedo to write."""
    if model.config.feature_type != "sh":
        raise ValueError("export_model writes SH models only: the PLY "
                         "holds f_dc and f_rest, which an NHT model lacks")
    n = model.n_active

    def live(name):
        return getattr(model, name)[:n].detach().cpu().numpy()

    export_ply(path, live("positions"), live("rotation"), live("scale"),
               live("density"), live("features_albedo"),
               live("features_specular"))


def read_point_cloud_ply(path: str):
    """Read a plain point-cloud PLY (cuSFM fused point clouds,
    initialization/fused_point_cloud.yaml): returns (xyz [N,3] f32,
    rgb [N,3] f32 in [0,1]; mid-gray when the file has no colors)."""
    arr, names = _read_vertices(path)
    xyz = np.stack([arr["x"], arr["y"], arr["z"]],
                   axis=1).astype(np.float32)
    if {"red", "green", "blue"} <= set(names):
        rgb = np.stack([arr["red"], arr["green"], arr["blue"]],
                       axis=1).astype(np.float32)
        if rgb.max() > 1.5:
            rgb = rgb / 255.0
    else:
        rgb = np.full((arr.shape[0], 3), 0.5, np.float32)
    return xyz, rgb
