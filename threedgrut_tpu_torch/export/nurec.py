"""NuRec USDZ export: Omniverse-consumable volume USD + .nurec payload
(copied from threedgrut_tpu/export/nurec.py; numpy, gzip and msgpack).

Round-1 export_usdz shipped the container + ParticleField schema only;
this module completes parity with the reference NuRec exporter
(threedgrut/export/usd/nurec/exporter.py:192, serializer.py:99,
templates.py):

- the ``.nurec`` model file: a gzip(level 0)-wrapped msgpack of the
  ``nre_data`` template (config + fp16 state dict) consumed by the
  NuRec/Omniverse runtime. The key/value schema is an interop contract
  (renderer names, layer config, state-dict key strings) and is
  reproduced as data, not code.
- the USD stage: a ``UsdVol Volume`` prim flagged
  ``omni:nurec:isNuRecVolume`` with density / emissiveColor
  ``OmniNuRecFieldAsset`` children referencing the .nurec file, identity
  color-correction rows, crop bounds and a proxy relationship
  (serializer.py:99-196 prim-for-prim).
- the .usdz container: uncompressed, 64-byte-aligned zip with the
  default layer first (reused write_usdz_container).
"""

from __future__ import annotations

import gzip
import io
from typing import Dict, Optional

import numpy as np

from .usd import write_usdz_container

NUREC_VERSION = "0.2.576"


def build_nre_template(positions, rotations, scales, densities,
                       features_albedo, features_specular,
                       n_active_features: int,
                       density_activation: str = "sigmoid",
                       scale_activation: str = "exp",
                       density_kernel_degree: int = 2,
                       density_kernel_density_clamping: bool = False,
                       density_kernel_min_response: float = 0.0113,
                       radiance_sph_degree: int = 3,
                       transmittance_threshold: float = 0.001,
                       global_z_order: bool = False,
                       n_rolling_shutter_iterations: int = 5,
                       ut_alpha: float = 1.0, ut_beta: float = 2.0,
                       ut_kappa: float = 0.0,
                       ut_require_all_sigma_points: bool = False,
                       image_margin_factor: float = 0.1,
                       rect_bounding: bool = True,
                       tight_opacity_bounding: bool = True,
                       tile_based_culling: bool = True,
                       k_buffer_size: int = 0,
                       dtype=np.float16) -> Dict:
    """The ``nre_data`` dict (templates.py fill_3dgut_template schema):
    pre-activation attributes in fp16 plus the renderer/layer config."""
    def tb(a):
        return np.ascontiguousarray(np.asarray(a)).astype(dtype).tobytes()

    n = len(positions)
    extra = np.zeros((n, 0), dtype)
    sd_prefix = ".gaussians_nodes.gaussians."
    state = {"._extra_state": {"obj_track_ids": {"gaussians": []}}}
    arrays = {
        "positions": positions, "rotations": rotations, "scales": scales,
        "densities": densities, "features_albedo": features_albedo,
        "features_specular": features_specular, "extra_signal": extra,
    }
    for name, a in arrays.items():
        state[sd_prefix + name] = tb(a)
        state[sd_prefix + name + ".shape"] = list(np.asarray(a).shape)
    state[sd_prefix + "n_active_features"] = np.array(
        [n_active_features], np.int64).tobytes()
    state[sd_prefix + "n_active_features.shape"] = []

    return {"nre_data": {
        "version": NUREC_VERSION,
        "model": "nre",
        "config": {
            "layers": {"gaussians": {
                "name": "sh-gaussians", "device": "cuda",
                "density_activation": density_activation,
                "scale_activation": scale_activation,
                "rotation_activation": "normalize",
                "precision": 16,
                "particle": {
                    "density_kernel_planar": False,
                    "density_kernel_degree": density_kernel_degree,
                    "density_kernel_density_clamping":
                        density_kernel_density_clamping,
                    "density_kernel_min_response":
                        density_kernel_min_response,
                    "radiance_sph_degree": radiance_sph_degree,
                },
                "transmittance_threshold": transmittance_threshold,
            }},
            "renderer": {
                "name": "3dgut-nrend", "log_level": 3,
                "force_update": False,
                "update_step_train_batch_end": False,
                "per_ray_features": False,
                "global_z_order": global_z_order,
                "projection": {
                    "n_rolling_shutter_iterations":
                        n_rolling_shutter_iterations,
                    "ut_dim": 3, "ut_alpha": ut_alpha, "ut_beta": ut_beta,
                    "ut_kappa": ut_kappa,
                    "ut_require_all_sigma_points":
                        ut_require_all_sigma_points,
                    "image_margin_factor": image_margin_factor,
                    "min_projected_ray_radius": 0.5477225575051661,
                },
                "culling": {
                    "rect_bounding": rect_bounding,
                    "tight_opacity_bounding": tight_opacity_bounding,
                    "tile_based": tile_based_culling,
                    "near_clip_distance": 1e-8,
                    "far_clip_distance": 3.402823466e38,
                },
                "render": {"mode": "kbuffer",
                           "k_buffer_size": k_buffer_size},
            },
            "name": "gaussians_primitive",
            "appearance_embedding": {"name": "skip-appearance",
                                     "embedding_dim": 0, "device": "cuda"},
            "background": {"name": "skip-background", "device": "cuda",
                           "composite_in_linear_space": False},
        },
        "state_dict": state,
    }}


def _msgpack():
    """The msgpack module; without it the .nurec payload cannot be
    written or read, and this raises (there is no other encoding)."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("the .nurec payload is msgpack: install msgpack "
                          "to write or read NuRec files") from e
    return msgpack


def pack_nurec(template: Dict) -> bytes:
    """gzip(level 0) msgpack payload (exporter.py:495-498 format). The
    gzip header holds the time of the call, so two packs of one template
    differ in those bytes; ``unpack_nurec`` gives equal templates."""
    msgpack = _msgpack()

    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", compresslevel=0) as f:
        f.write(msgpack.packb(template))
    return buf.getvalue()


def unpack_nurec(data: bytes) -> Dict:
    msgpack = _msgpack()

    with gzip.GzipFile(fileobj=io.BytesIO(data), mode="rb") as f:
        return msgpack.unpackb(f.read(), strict_map_key=False)


def nurec_volume_usda(nurec_filename: str, positions: np.ndarray,
                      normalizing_transform: Optional[np.ndarray] = None,
                      volume_name: str = "gauss") -> str:
    """The NuRec volume layer (serializer.py:99-196 prim-for-prim)."""
    mn = np.min(positions, axis=0)
    mx = np.max(positions, axis=0)
    tf = np.linalg.inv(normalizing_transform) \
        if normalizing_transform is not None else np.eye(4)
    rows = ", ".join(
        "(" + ", ".join(f"{v:.9g}" for v in tf[r]) + ")" for r in range(4))

    def v3(v):
        return f"({v[0]:.6g}, {v[1]:.6g}, {v[2]:.6g})"

    out = io.StringIO()
    out.write('#usda 1.0\n(\n    defaultPrim = "World"\n'
              '    upAxis = "Y"\n    metersPerUnit = 1\n)\n\n')
    out.write('def Xform "World"\n{\n')
    out.write(f'    def Volume "{volume_name}"\n    {{\n')
    out.write(f'        float3[] extent = [{v3(mn)}, {v3(mx)}]\n')
    out.write(f'        matrix4d xformOp:transform = ( {rows} )\n')
    out.write('        uniform token[] xformOpOrder = '
              '["xformOp:transform"]\n')
    out.write('        custom bool omni:nurec:isNuRecVolume = 1\n')
    out.write('        custom bool omni:nurec:useProxyTransform = 0\n')
    out.write('        custom float3 omni:nurec:offset = (0, 0, 0)\n')
    out.write(f'        custom float3 omni:nurec:crop:minBounds = '
              f'{v3(mn)}\n')
    out.write(f'        custom float3 omni:nurec:crop:maxBounds = '
              f'{v3(mx)}\n')
    out.write('        rel field:density = <'
              f'/World/{volume_name}/density_field>\n')
    out.write('        rel field:emissiveColor = <'
              f'/World/{volume_name}/emissive_color_field>\n')
    out.write('        rel proxy\n')
    out.write('        def OmniNuRecFieldAsset "density_field"\n'
              '        {\n')
    out.write(f'            asset filePath = @./{nurec_filename}@\n')
    out.write('            token fieldName = "density"\n')
    out.write('            token fieldDataType = "float"\n')
    out.write('            token fieldRole = "density"\n')
    out.write('        }\n')
    out.write('        def OmniNuRecFieldAsset "emissive_color_field"\n'
              '        {\n')
    out.write(f'            asset filePath = @./{nurec_filename}@\n')
    out.write('            token fieldName = "emissiveColor"\n')
    out.write('            token fieldDataType = "float3"\n')
    out.write('            token fieldRole = "emissiveColor"\n')
    out.write('            custom float4 omni:nurec:ccmR = (1, 0, 0, 0)\n')
    out.write('            custom float4 omni:nurec:ccmG = (0, 1, 0, 0)\n')
    out.write('            custom float4 omni:nurec:ccmB = (0, 0, 1, 0)\n')
    out.write('        }\n')
    out.write('    }\n}\n')
    return out.getvalue()


def export_nurec_usdz(path: str, attrs: Dict[str, np.ndarray],
                      n_active_features: int,
                      normalizing_transform: Optional[np.ndarray] = None,
                      name: str = "gauss", **template_kw) -> str:
    """Full NuRec USDZ: default layer + volume layer + .nurec payload.

    ``attrs``: PRE-activation attributes (positions, rotations, scales,
    densities, features_albedo, features_specular) - the NuRec runtime
    applies the activations recorded in the template config.
    """
    template = build_nre_template(
        attrs["positions"], attrs["rotations"], attrs["scales"],
        attrs["densities"], attrs["features_albedo"],
        attrs["features_specular"], n_active_features, **template_kw)
    payload = pack_nurec(template)
    nurec_name = f"{name}.nurec"
    layer = nurec_volume_usda(nurec_name,
                              np.asarray(attrs["positions"], np.float32),
                              normalizing_transform, volume_name=name)
    write_usdz_container(path, [
        (f"{name}.usda", layer.encode()),
        (nurec_name, payload),
    ])
    return path


def import_nurec_usdz(path: str) -> Dict:
    """Read back a NuRec usdz: pre-activation attrs + config."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        nurec_name = next(n for n in z.namelist() if n.endswith(".nurec"))
        data = z.read(nurec_name)
    t = unpack_nurec(data)["nre_data"]
    sd = t["state_dict"]
    pre = ".gaussians_nodes.gaussians."

    def arr(name, dtype=np.float16):
        shape = sd[pre + name + ".shape"]
        return np.frombuffer(sd[pre + name], dtype).reshape(shape).astype(
            np.float32)

    return dict(
        positions=arr("positions"), rotations=arr("rotations"),
        scales=arr("scales"), densities=arr("densities"),
        features_albedo=arr("features_albedo"),
        features_specular=arr("features_specular"),
        n_active_features=int(np.frombuffer(
            sd[pre + "n_active_features"], np.int64)[0]),
        config=t["config"])
