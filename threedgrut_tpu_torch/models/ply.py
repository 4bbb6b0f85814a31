"""3DGS PLY reader (copied from threedgrut_tpu/export/ply.py:62-113,
``import_ply``): binary little-endian vertex properties x/y/z, rot_*,
scale_*, opacity, f_dc_*, f_rest_* to raw parameter arrays."""

from __future__ import annotations

import numpy as np


def import_ply(path: str):
    """Read a 3DGS PLY -> dict of raw parameter arrays.

    Returns dict(positions [N,3], rotation [N,4], scale [N,3],
    density [N,1], features_albedo [N,3], features_specular [N,S]).
    """
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

    def col(name):
        return np.ascontiguousarray(arr[name]).astype(np.float32)

    positions = np.stack([col("x"), col("y"), col("z")], axis=1)
    rotation = np.stack([col(f"rot_{i}") for i in range(4)], axis=1)
    scale = np.stack([col(f"scale_{i}") for i in range(3)], axis=1)
    density = col("opacity")[:, None]
    albedo = np.stack([col(f"f_dc_{i}") for i in range(3)], axis=1)
    rest_names = sorted([nm for nm, _ in props if nm.startswith("f_rest_")],
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
