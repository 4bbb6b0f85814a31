"""Triangle meshes for the hybrid playground renderer
(port of threedgrut_tpu/playground/mesh.py).

The OBJ and binary glTF loaders and the demo primitives are the JAX
module's numpy code; glTF textures decode with PIL. Ray-triangle closest
hits (Moller-Trumbore) run on torch tensors: ``TriangleSoup`` tests
every ray against every triangle, in ray chunks so the [rays, faces]
temporaries stay bounded (memory is not a semantic), and
``ClusteredTriangles`` culls Morton-ordered 64-triangle clusters per
256-ray block first, for large meshes.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
from typing import List, Optional

import numpy as np
import torch

# elements of a [rays, faces] temporary in one chunk of TriangleSoup
_SOUP_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray    # [V, 3]
    faces: np.ndarray       # [F, 3] int32
    material_id: int = 0
    # per-vertex texture coordinates (glTF TEXCOORD_0, v down); None:
    # untextured (uv interpolates to 0)
    uvs: Optional[np.ndarray] = None   # [V, 2]

    @property
    def num_faces(self):
        return len(self.faces)


def load_obj(path: str, material_id: int = 0) -> Mesh:
    """Minimal OBJ parser: v and f lines (polygons as fans)."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(vertices=np.asarray(verts, np.float32),
                faces=np.asarray(faces, np.int32), material_id=material_id)


_GLTF_DTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
               5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _gltf_accessor(gltf: dict, bin_chunk: bytes, idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = np.dtype(_GLTF_DTYPE[acc["componentType"]])
    ncomp = _GLTF_NCOMP[acc["type"]]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    elem = ncomp * dtype.itemsize
    stride = view.get("byteStride") or elem
    count = acc["count"]
    raw = np.frombuffer(bin_chunk, np.uint8,
                        count=count * stride - (stride - elem),
                        offset=offset)
    if stride == elem:
        return raw.view(dtype).reshape(count, ncomp)
    # interleaved vertex buffer: de-stride per element
    return np.stack([raw[i * stride:i * stride + elem].view(dtype)
                     for i in range(count)])


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], np.float32)
    if "rotation" in node:  # glTF quaternion xyzw
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)]], np.float32)
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _gltf_image(gltf: dict, bin_chunk: bytes, idx: int,
                base_dir: str) -> Optional[np.ndarray]:
    """gltf images[idx] as float32 [H, W, C] in [0, 1], decoded with PIL
    (embedded in a bufferView, or an external file beside the asset);
    None where it cannot be decoded (the constant factors then apply)."""
    from PIL import Image

    img = gltf.get("images", [])[idx]
    try:
        if "bufferView" in img:
            view = gltf["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            out = np.asarray(Image.open(io.BytesIO(
                bytes(bin_chunk[off:off + view["byteLength"]]))))
        elif "uri" in img and not img["uri"].startswith("data:"):
            out = np.asarray(Image.open(os.path.join(base_dir, img["uri"])))
        else:
            return None
    except (OSError, ValueError):
        return None
    return np.asarray(out, np.float32) / (
        255.0 if out.dtype == np.uint8 else 1.0)


def _gltf_material(gltf: dict, bin_chunk: bytes, idx: Optional[int],
                   base_dir: str) -> dict:
    """gltf materials[idx] as a plain dict of the reference PBRMaterial's
    texture semantics (threedgrut_playground/engine.py:98)."""
    out = dict(base_color=(0.8, 0.8, 0.8), metallic=0.0, roughness=0.4,
               emissive=(0.0, 0.0, 0.0), transmission=0.0, ior=1.45,
               alpha_cutoff=0.5, diffuse_map=None, emissive_map=None)
    if idx is None or idx >= len(gltf.get("materials", [])):
        return out
    m = gltf["materials"][idx]
    pbr = m.get("pbrMetallicRoughness", {})
    out["base_color"] = tuple(pbr.get("baseColorFactor",
                                      [1.0, 1.0, 1.0, 1.0])[:3])
    out["metallic"] = pbr.get("metallicFactor", 1.0)
    out["roughness"] = pbr.get("roughnessFactor", 1.0)
    out["emissive"] = tuple(m.get("emissiveFactor", [0.0, 0.0, 0.0]))
    out["alpha_cutoff"] = m.get("alphaCutoff", 0.5)
    ext = m.get("extensions", {})
    if "KHR_materials_transmission" in ext:
        out["transmission"] = ext["KHR_materials_transmission"].get(
            "transmissionFactor", 0.0)
    if "KHR_materials_ior" in ext:
        out["ior"] = ext["KHR_materials_ior"].get("ior", 1.45)
    textures = gltf.get("textures", [])

    def tex_image(tinfo):
        if tinfo is None:
            return None
        src = textures[tinfo["index"]].get("source")
        return None if src is None else _gltf_image(gltf, bin_chunk, src,
                                                    base_dir)

    out["diffuse_map"] = tex_image(pbr.get("baseColorTexture"))
    out["emissive_map"] = tex_image(m.get("emissiveTexture"))
    return out


def load_glb_scene(path: str):
    """Binary glTF (.glb): POSITION, TEXCOORD_0, indices, materials and
    the default scene's node transforms, flattened into world-space
    meshes, one per triangle primitive (the reference's pygltflib asset
    path, threedgrut_playground/utils/mesh_io.py:44-112). Returns
    (meshes, materials): each mesh's ``material_id`` indexes the
    materials list (plain dicts)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version, _length = struct.unpack_from("<4sII", data, 0)
    if magic != b"glTF":
        raise ValueError(f"{path}: not a GLB file")
    pos, json_chunk, bin_chunk = 12, None, b""
    while pos + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, pos)
        chunk = data[pos + 8:pos + 8 + clen]
        if ctype == 0x4E4F534A:      # 'JSON'
            json_chunk = chunk
        elif ctype == 0x004E4942:    # 'BIN\0'
            bin_chunk = chunk
        pos += 8 + clen + (-clen % 4)
    if json_chunk is None:
        raise ValueError(f"{path}: GLB missing JSON chunk")
    gltf = json.loads(json_chunk)
    base_dir = os.path.dirname(os.path.abspath(path))

    meshes: List[Mesh] = []
    materials: List[dict] = []
    mat_local: dict = {}   # gltf material index (or None) -> local id

    def local_mat(gidx):
        if gidx not in mat_local:
            mat_local[gidx] = len(materials)
            materials.append(_gltf_material(gltf, bin_chunk, gidx,
                                            base_dir))
        return mat_local[gidx]

    def emit(mesh_idx: int, xform: np.ndarray):
        for prim in gltf["meshes"][mesh_idx].get("primitives", []):
            attrs = prim.get("attributes", {})
            if prim.get("mode", 4) != 4 or "POSITION" not in attrs:
                continue           # triangles only
            verts = _gltf_accessor(gltf, bin_chunk,
                                   attrs["POSITION"]).astype(np.float32)
            verts = verts @ xform[:3, :3].T + xform[:3, 3]
            if "indices" in prim:
                faces = _gltf_accessor(gltf, bin_chunk, prim["indices"])
                faces = faces.astype(np.int32).reshape(-1, 3)
            else:
                faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
            uvs = None
            if "TEXCOORD_0" in attrs:
                uvs = _gltf_accessor(gltf, bin_chunk, attrs["TEXCOORD_0"])
                ctype = gltf["accessors"][attrs["TEXCOORD_0"]][
                    "componentType"]
                if ctype == 5121:      # normalized u8
                    uvs = uvs.astype(np.float32) / 255.0
                elif ctype == 5123:    # normalized u16
                    uvs = uvs.astype(np.float32) / 65535.0
                uvs = uvs.astype(np.float32)
            meshes.append(Mesh(vertices=verts, faces=faces,
                               material_id=local_mat(prim.get("material")),
                               uvs=uvs))

    def walk(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        xform = parent @ _node_matrix(node)
        if "mesh" in node:
            emit(node["mesh"], xform)
        for child in node.get("children", []):
            walk(child, xform)

    scenes = gltf.get("scenes", [])
    roots = (scenes[gltf.get("scene", 0)]["nodes"]
             if scenes else range(len(gltf.get("nodes", []))))
    for root in roots:
        walk(root, np.eye(4, dtype=np.float32))
    if not meshes and "meshes" in gltf:   # no scene graph: flat meshes
        for i in range(len(gltf["meshes"])):
            emit(i, np.eye(4, dtype=np.float32))
    return meshes, materials


def load_glb(path: str, material_id: int = 0) -> List[Mesh]:
    """Geometry-only GLB load (meshes tagged with ``material_id``)."""
    meshes, _ = load_glb_scene(path)
    for m in meshes:
        m.material_id = material_id
    return meshes


def load_mesh_file(path: str, material_id: int = 0) -> List[Mesh]:
    """.obj -> [Mesh]; .glb -> a mesh per primitive."""
    if path.lower().endswith((".glb", ".gltf")):
        return load_glb(path, material_id)
    return [load_obj(path, material_id)]


def make_box(center, size, material_id: int = 0) -> Mesh:
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32) / 2
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float32) * s + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, cc, d in quads:
        faces += [[a, b, cc], [a, cc, d]]
    return Mesh(vertices=corners, faces=np.asarray(faces, np.int32),
                material_id=material_id)


def make_icosphere(center, radius, subdivisions: int = 2,
                   material_id: int = 0) -> Mesh:
    phi = (1 + np.sqrt(5)) / 2
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
                 np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int32)
    for _ in range(subdivisions):
        new_faces = []
        verts = list(v)
        cache = {}

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                cache[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return cache[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        v = np.asarray(verts, np.float32)
        f = np.asarray(new_faces, np.int32)
    return Mesh(vertices=(v * radius + np.asarray(center, np.float32))
                .astype(np.float32),
                faces=f, material_id=material_id)


def _moller_trumbore(o, d, v0, e1, e2, mat, t_min, t_max):
    """Closest hits of rays o, d [R, 3] against triangles [R or 1, F, 3]:
    (t [R], j [R] index of the best triangle, u [R, F], v [R, F])."""
    pvec = torch.linalg.cross(d[:, None, :], e2)
    det = torch.sum(e1 * pvec, dim=-1)
    ok_det = torch.abs(det) > 1e-9
    inv_det = torch.where(ok_det, 1.0 / det, torch.zeros_like(det))
    tvec = o[:, None, :] - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = torch.sum(d[:, None, :] * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = (ok_det & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
           & (t < t_max) & (mat >= 0))
    t = torch.where(hit, t, torch.full_like(t, torch.inf))
    # the first minimum, as jnp.argmin takes it
    t_best, j = torch.min(t, dim=1)
    return t_best, j, u, v


def _hit_outputs(ray_d, t_best, tri, j, u, v, e1, e2, mat, uv0, uvd1,
                 uvd2):
    """(t, tri, normal facing the ray, material, uv) of the best hits."""
    miss = ~torch.isfinite(t_best)
    n = torch.linalg.cross(e1, e2)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    n = torch.where(torch.sum(n * ray_d, dim=-1, keepdim=True) > 0, -n, n)
    ub = u.gather(1, j[:, None])
    vb = v.gather(1, j[:, None])
    uvs = uv0 + ub * uvd1 + vb * uvd2
    minus = torch.full_like(tri, -1)
    return (torch.where(miss, torch.full_like(t_best, 1e7), t_best),
            torch.where(miss, minus, tri), n,
            torch.where(miss, minus, mat), uvs)


class TriangleSoup:
    """Packed triangle arrays for the dense closest-hit test."""

    def __init__(self, meshes: List[Mesh], device="cpu"):
        v0, v1, v2, mats, uv = [], [], [], [], []
        for m in meshes:
            tv = m.vertices[m.faces]  # [F, 3, 3]
            v0.append(tv[:, 0])
            v1.append(tv[:, 1])
            v2.append(tv[:, 2])
            mats.append(np.full(len(m.faces), m.material_id, np.int32))
            uv.append(m.uvs[m.faces].astype(np.float32) if m.uvs is not None
                      else np.zeros((len(m.faces), 3, 2), np.float32))
        if not v0:
            v0 = v1 = v2 = [np.zeros((1, 3), np.float32)]
            mats = [np.full(1, -1, np.int32)]
            uv = [np.zeros((1, 3, 2), np.float32)]

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.concatenate(a), dtype=dtype,
                                   device=device)

        self.v0 = t(v0)
        self.e1 = t(v1) - self.v0
        self.e2 = t(v2) - self.v0
        self.material_id = t(mats, torch.int64)
        uvf = t(uv)                                   # [F, 3, 2]
        self.uv0 = uvf[:, 0]
        self.uvd1 = uvf[:, 1] - uvf[:, 0]
        self.uvd2 = uvf[:, 2] - uvf[:, 0]

    def closest_hit(self, ray_o, ray_d, t_min=1e-4, t_max=1e7):
        """Moller-Trumbore closest hit of rays [R, 3]: (t [R], triangle
        [R] (-1: miss), geometric normal facing the ray [R, 3], material
        [R], barycentric-interpolated uv [R, 2])."""
        n_f = self.v0.shape[0]
        step = max(1, _SOUP_CHUNK_ELEMS // n_f)
        outs = []
        for r0 in range(0, ray_o.shape[0], step):
            o, d = ray_o[r0:r0 + step], ray_d[r0:r0 + step]
            t_best, j, u, v = _moller_trumbore(
                o, d, self.v0[None], self.e1[None], self.e2[None],
                self.material_id[None], t_min, t_max)
            outs.append(_hit_outputs(
                d, t_best, j, j, u, v, self.e1[j], self.e2[j],
                self.material_id[j], self.uv0[j], self.uvd1[j],
                self.uvd2[j]))
        return tuple(torch.cat(x) for x in zip(*outs))


class ClusteredTriangles:
    """Large-mesh accelerator: Morton-ordered triangle clusters and
    per-256-ray-block AABB culling (JAX mesh.py:399-527; the stand-in for
    the reference's OptiX mesh GAS). Each block slab-tests every cluster
    AABB, keeps the ``max_clusters`` with the nearest entry and runs
    Moller-Trumbore against those only; a block crossing more clusters
    may miss hits behind the nearest ones."""

    CLUSTER = 64
    BLOCK = 256

    def __init__(self, meshes: List[Mesh], max_clusters: int = 64,
                 device="cpu"):
        soup = TriangleSoup(meshes)
        v0, e1, e2 = (x.numpy() for x in (soup.v0, soup.e1, soup.e2))
        mat = soup.material_id.numpy()
        f = len(v0)
        # Morton order of the centroids
        cent = v0 + (e1 + e2) / 3.0
        lo, hi = cent.min(0), cent.max(0)
        q = np.clip(((cent - lo) / np.maximum(hi - lo, 1e-9) * 1023), 0,
                    1023).astype(np.uint32)
        code = np.zeros(f, np.uint64)
        for b in range(10):
            for a in range(3):
                code |= ((q[:, a].astype(np.uint64) >> b) & 1) << (3 * b + a)
        order = np.argsort(code, kind="stable")
        pad = (-f) % self.CLUSTER
        # padded rows repeat the last triangle, masked by material -1
        order = np.concatenate([order, np.full(pad, order[-1] if f else 0)])
        mat_sorted = mat[order].copy()
        mat_sorted[f:] = -1

        def t(a, dtype=torch.float32):
            return torch.as_tensor(a, dtype=dtype, device=device)

        self.tri_src = t(order, torch.int64)   # cluster row -> soup triangle
        self.v0, self.e1, self.e2 = t(v0[order]), t(e1[order]), t(e2[order])
        self.material_id = t(mat_sorted, torch.int64)
        self.uv0 = soup.uv0[order].to(device)
        self.uvd1 = soup.uvd1[order].to(device)
        self.uvd2 = soup.uvd2[order].to(device)
        m = len(order) // self.CLUSTER
        tv = np.stack([v0[order], v0[order] + e1[order],
                       v0[order] + e2[order]], axis=1).reshape(
            m, self.CLUSTER * 3, 3)
        self.cluster_lo = t(tv.min(axis=1))
        self.cluster_hi = t(tv.max(axis=1))
        self.num_clusters = m
        self.max_clusters = min(max_clusters, m)

    def closest_hit(self, ray_o, ray_d, t_min=1e-4, t_max=1e7):
        """Same contract as TriangleSoup.closest_hit."""
        k, c = self.max_clusters, self.CLUSTER
        r = ray_o.shape[0]
        # JAX pads the last block with rays from 0 along (1, 1, 1), which
        # take part in its cluster selection
        pad = -r % self.BLOCK
        ray_o = torch.nn.functional.pad(ray_o, (0, 0, 0, pad))
        ray_d = torch.nn.functional.pad(ray_d, (0, 0, 0, pad), value=1.0)
        outs = []
        for r0 in range(0, r, self.BLOCK):
            o, d = ray_o[r0:r0 + self.BLOCK], ray_d[r0:r0 + self.BLOCK]
            inv = 1.0 / torch.where(torch.abs(d) < 1e-12,
                                    torch.full_like(d, 1e-12), d)
            t0 = (self.cluster_lo[None] - o[:, None]) * inv[:, None]
            t1 = (self.cluster_hi[None] - o[:, None]) * inv[:, None]
            tn = torch.amax(torch.minimum(t0, t1), dim=-1)   # [256, M]
            tf = torch.amin(torch.maximum(t0, t1), dim=-1)
            hit = (tf >= torch.clamp(tn, min=t_min)) & (tn < t_max)
            prio = torch.amin(torch.where(hit, tn, torch.full_like(
                tn, torch.inf)), dim=0)                      # [M]
            sel = torch.sort(prio, stable=True).indices[:k]  # lax.top_k ties
            rows = (sel[:, None] * c + torch.arange(
                c, device=o.device)[None]).reshape(-1)
            t_best, j, u, v = _moller_trumbore(
                o, d, self.v0[rows][None], self.e1[rows][None],
                self.e2[rows][None], self.material_id[rows][None], t_min,
                t_max)
            rowj = rows[j]
            outs.append(_hit_outputs(
                d, t_best, self.tri_src[rowj], j, u, v, self.e1[rowj],
                self.e2[rowj], self.material_id[rowj], self.uv0[rowj],
                self.uvd1[rowj], self.uvd2[rowj]))
        return tuple(torch.cat(x)[:r] for x in zip(*outs))


def make_intersector(meshes: List[Mesh], dense_threshold: int = 8192,
                     max_clusters: int = 64, device="cpu"):
    """The dense soup for small scenes, clusters for large ones."""
    n_faces = sum(m.num_faces for m in meshes) if meshes else 0
    if n_faces <= dense_threshold:
        return TriangleSoup(meshes, device)
    return ClusteredTriangles(meshes, max_clusters=max_clusters,
                              device=device)
