"""USD ParticleField export/import without a pxr dependency (copied
from threedgrut_tpu/export/usd.py, numpy only; ``export_model_usda``
reads the port's ``GaussianModel``).

The reference writes `UsdVol ParticleField3DGaussianSplat` prims with
post-activation attributes (threedgrut/export/usd/writers/lightfield.py:
positions / orientations / scales / opacities /
radianceSphericalHarmonicsDegree+Coefficients, projection/sorting mode
hints, extent). ``pxr`` is not available in this environment, so this
module emits the ASCII ``.usda`` encoding directly (usda is a first-class
USD format readable by any USD runtime) and parses it back. Binary
.usdc/.usdz output is gated on pxr and raises a clear error.

Cameras are exported as UsdGeom Camera prims with transforms + focal
attributes (export/usd/writers/camera.py equivalent).
"""

from __future__ import annotations

import io
import os
import re
from typing import Dict, List, Optional

import numpy as np


def _fmt_floats(arr: np.ndarray, per: int) -> str:
    """``[v, ...]`` (``per`` 1) or ``[(x, y, ..), ...]`` at 7 significant
    digits. The values go through Python floats (a float32 widens to
    float64 exactly, and formats to the same digits as the numpy scalar
    the JAX package formats), a row template at a time: the same bytes
    in ~40% of the time, which counts at a million particles."""
    vals = np.asarray(arr, np.float32).reshape(-1).tolist()
    if per == 1:
        return "[" + ", ".join(map("{:.7g}".format, vals)) + "]"
    row = "(" + ", ".join(["{:.7g}"] * per) + ")"
    it = iter(vals)
    return "[" + ", ".join(row.format(*r) for r in zip(*[it] * per)) + "]"


def export_usda(path: str, attrs: Dict[str, np.ndarray], sh_degree: int,
                cameras: Optional[List[dict]] = None,
                background_color: Optional[np.ndarray] = None,
                sorting_mode_hint: str = "cameraDistance",
                up_axis: str = "Y", half: bool = False):
    """Write post-activation gaussian attributes as a USDA stage.

    attrs: positions [N,3], orientations [N,4] (wxyz, normalized),
    scales [N,3] (post-activation), opacities [N], sh_coefficients
    [N,K,3]. ``half`` rounds non-position float attributes to f16
    (the reference USD exporter's half-precision option; positions stay
    f32 like the reference keeps point3f).
    """
    if half:
        attrs = dict(attrs)
        for key in ("orientations", "scales", "opacities",
                    "sh_coefficients"):
            attrs[key] = np.asarray(attrs[key]).astype(np.float16).astype(
                np.float32)
    pos = np.asarray(attrs["positions"], np.float32)
    n = pos.shape[0]
    mn, mx = pos.min(0), pos.max(0)
    sh = np.asarray(attrs["sh_coefficients"], np.float32)
    k = sh.shape[1]

    out = io.StringIO()
    out.write('#usda 1.0\n(\n    defaultPrim = "World"\n'
              f'    upAxis = "{up_axis}"\n    metersPerUnit = 1\n)\n\n')
    out.write('def Xform "World"\n{\n')
    out.write('    def ParticleField3DGaussianSplat "gauss"\n    {\n')
    out.write(f'        float3[] extent = [({mn[0]:.6g}, {mn[1]:.6g}, '
              f'{mn[2]:.6g}), ({mx[0]:.6g}, {mx[1]:.6g}, {mx[2]:.6g})]\n')
    out.write(f'        int numParticles = {n}\n')
    out.write(f'        token sortingModeHint = "{sorting_mode_hint}"\n')
    out.write('        point3f[] positions = '
              + _fmt_floats(pos, 3) + "\n")
    out.write('        quatf[] orientations = '
              + _fmt_floats(attrs["orientations"], 4) + "\n")
    out.write('        float3[] scales = '
              + _fmt_floats(attrs["scales"], 3) + "\n")
    out.write('        float[] opacities = '
              + _fmt_floats(np.asarray(attrs["opacities"]).reshape(-1, 1), 1)
              + "\n")
    out.write(f'        int radianceSphericalHarmonicsDegree = {sh_degree}\n')
    out.write('        float[] radianceSphericalHarmonicsCoefficients = '
              + _fmt_floats(sh.reshape(-1, 1), 1) + "\n")
    out.write('    }\n')

    if background_color is not None:
        bg = np.asarray(background_color, np.float32)
        out.write('    def Scope "Render"\n    {\n')
        out.write(f'        custom float3 backgroundColor = '
                  f'({bg[0]:.6g}, {bg[1]:.6g}, {bg[2]:.6g})\n')
        out.write('    }\n')

    for i, cam in enumerate(cameras or []):
        t = np.asarray(cam["transform"], np.float64)
        rows = ", ".join(
            "(" + ", ".join(f"{v:.9g}" for v in t[r]) + ")" for r in range(4))
        out.write(f'    def Camera "camera_{i}"\n    {{\n')
        out.write(f'        matrix4d xformOp:transform = ( {rows} )\n')
        out.write('        uniform token[] xformOpOrder = '
                  '["xformOp:transform"]\n')
        out.write(f'        float focalLength = {cam.get("focal", 35.0):.6g}\n')
        out.write(f'        float horizontalAperture = '
                  f'{cam.get("h_aperture", 36.0):.6g}\n')
        out.write(f'        float verticalAperture = '
                  f'{cam.get("v_aperture", 24.0):.6g}\n')
        out.write('    }\n')

    out.write('}\n')
    if path.endswith(".usdc"):
        return export_usdc(path, attrs, sh_degree, cameras=cameras,
                           background_color=background_color,
                           sorting_mode_hint=sorting_mode_hint)
    if path.endswith(".usdz"):
        raise ValueError("use export_usdz for usdz containers")
    with open(path, "w") as f:
        f.write(out.getvalue())


def export_usdc(path: str, attrs: Dict[str, np.ndarray], sh_degree: int,
                cameras: Optional[List[dict]] = None,
                background_color: Optional[np.ndarray] = None,
                sorting_mode_hint: str = "cameraDistance"):
    """Binary crate (.usdc) twin of export_usda: same ParticleField
    prim layout through the from-scratch crate serializer
    (export/crate.py; reference export goes through pxr,
    export/usd/exporter.py:530)."""
    from . import crate

    pos = np.asarray(attrs["positions"], np.float32)
    sh = np.asarray(attrs["sh_coefficients"], np.float32)
    w = crate.CrateWriter()
    gauss = crate.Prim(
        path="/World/gauss", type_name="ParticleField3DGaussianSplat",
        attributes={
            "extent": crate.vec3f_array(
                np.stack([pos.min(0), pos.max(0)])),
            "numParticles": crate.Attribute(crate.TYPE_INT, pos.shape[0]),
            "sortingModeHint": crate.token_attr(sorting_mode_hint),
            "positions": crate.vec3f_array(pos),
            "orientations": crate.quatf_array(attrs["orientations"]),
            "scales": crate.vec3f_array(attrs["scales"]),
            "opacities": crate.float_array(attrs["opacities"]),
            "radianceSphericalHarmonicsDegree": crate.Attribute(
                crate.TYPE_INT, sh_degree),
            "radianceSphericalHarmonicsCoefficients": crate.float_array(
                sh.reshape(-1)),
        })
    world = crate.Prim(path="/World", type_name="Xform")
    w.add_prim(world)
    w.add_prim(gauss)
    extra_roots = []
    if background_color is not None:
        bg = np.asarray(background_color, np.float32)
        w.add_prim(crate.Prim(
            path="/World/Render", type_name="Scope",
            attributes={"backgroundColor": crate.Attribute(
                crate.TYPE_VEC3F, bg.reshape(1, 3), is_array=True)}))
    for i, cam in enumerate(cameras or []):
        w.add_prim(crate.Prim(
            path=f"/World/camera_{i}", type_name="Camera",
            attributes={
                "xformOp:transform": crate.Attribute(
                    crate.TYPE_MATRIX4D,
                    np.asarray(cam["transform"], np.float64)),
                "focalLength": crate.Attribute(
                    crate.TYPE_FLOAT, float(cam.get("focal", 35.0))),
            }))
    w.add_pseudo_root(
        ["World"] + extra_roots,
        metadata={"defaultPrim": crate.token_attr("World"),
                  "upAxis": crate.token_attr("Y")})
    w.write(path)
    return path


def import_usdc(path: str) -> dict:
    """Read a ParticleField crate file written by export_usdc."""
    from . import crate

    r = crate.read(path)
    prims = r.prims()
    gauss = next(v for k, v in prims.items()
                 if v.get("typeName") == "ParticleField3DGaussianSplat")
    a = gauss["attrs"]
    return dict(
        positions=np.asarray(a["positions"], np.float32),
        orientations=np.asarray(a["orientations"], np.float32),
        scales=np.asarray(a["scales"], np.float32),
        opacities=np.asarray(a["opacities"], np.float32).reshape(-1),
        sh_coefficients=np.asarray(
            a["radianceSphericalHarmonicsCoefficients"],
            np.float32).reshape(len(a["positions"]), -1, 3),
        sh_degree=int(a["radianceSphericalHarmonicsDegree"]))


_BRACKETS = re.compile(r"[\[\]]")


def _parse_tuple_array(text: str, per: int) -> np.ndarray:
    vals = list(map(float, text.replace("(", " ").replace(")", " ")
                    .replace(",", " ").split()))
    return np.asarray(vals, np.float32).reshape(-1, per)


def import_usda(path: str) -> dict:
    """Parse a ParticleField3DGaussianSplat usda (as written above)."""
    with open(path) as f:
        text = f.read()

    def grab(name):
        i = text.index(name)
        eq = text.index("=", i + len(name))
        start = text.index("[", eq)
        depth = 0
        # the brackets only, found by the regex engine: a character loop
        # over a million particles' text takes minutes
        for m in _BRACKETS.finditer(text, start):
            depth += 1 if m.group() == "[" else -1
            if depth == 0:
                return text[start + 1:m.start()]
        raise ValueError(f"unterminated array for {name}")

    positions = _parse_tuple_array(grab("point3f[] positions"), 3)
    orientations = _parse_tuple_array(grab("quatf[] orientations"), 4)
    scales = _parse_tuple_array(grab("float3[] scales"), 3)
    opacities = _parse_tuple_array(grab("float[] opacities"), 1)[:, 0]
    sh_flat = _parse_tuple_array(
        grab("float[] radianceSphericalHarmonicsCoefficients"), 1)[:, 0]
    deg_key = "int radianceSphericalHarmonicsDegree ="
    deg = int(text[text.index(deg_key) + len(deg_key):].split()[0])
    n = positions.shape[0]
    k = (deg + 1) ** 2
    sh = sh_flat.reshape(n, k, 3)
    return dict(positions=positions, orientations=orientations,
                scales=scales, opacities=opacities, sh_coefficients=sh,
                sh_degree=deg)


def write_usdz_container(path: str, entries):
    """Write a .usdz archive from ``entries`` = [(name, bytes), ...].

    USDZ is an UNCOMPRESSED zip whose first entry is the default layer
    with every entry's file data 64-byte aligned (the reference ships
    NuRec .usdz via pxr's UsdZipFileWriter; pxr is unavailable here, so
    this writes the container directly - any USD runtime can open it
    since .usda is a first-class layer format)."""
    import io as _io
    import struct
    import zipfile

    buf = _io.BytesIO()
    records = []          # (name, crc, size, local_header_offset)
    for name, payload in entries:
        # local header: 30 bytes + name + extra; pad extra so data
        # starts at a 64-byte boundary (usdz alignment rule)
        hdr_off = buf.tell()
        base = hdr_off + 30 + len(name)
        pad = (-base) % 64
        extra = b"\x00" * pad
        crc = zipfile.crc32(payload) & 0xFFFFFFFF
        buf.write(struct.pack("<IHHHHHIIIHH", 0x04034B50, 20, 0, 0, 0, 0,
                              crc, len(payload), len(payload), len(name),
                              len(extra)))
        buf.write(name.encode())
        buf.write(extra)
        assert buf.tell() % 64 == 0
        buf.write(payload)
        records.append((name, crc, len(payload), hdr_off))

    cd_off = buf.tell()
    for name, crc, size, hdr_off in records:
        buf.write(struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 20, 20, 0,
                              0, 0, 0, crc, size, size, len(name), 0, 0,
                              0, 0, 0, hdr_off))
        buf.write(name.encode())
    cd_len = buf.tell() - cd_off
    buf.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, len(records),
                          len(records), cd_len, cd_off, 0))
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def add_file_to_usdz(usdz_path: str, file_path: str,
                     entry_name: str = None):
    """Insert a file (e.g. a .glb/.obj proxy mesh) into an existing usdz
    archive, preserving the default layer as the first entry (the
    reference's export/scripts/add_mesh_to_usdz.py)."""
    import zipfile

    with zipfile.ZipFile(usdz_path) as z:
        entries = [(n, z.read(n)) for n in z.namelist()]
    with open(file_path, "rb") as f:
        payload = f.read()
    name = entry_name or os.path.basename(file_path)
    entries = [e for e in entries if e[0] != name] + [(name, payload)]
    write_usdz_container(usdz_path, entries)


def export_usdz(path: str, attrs: Dict[str, np.ndarray], sh_degree: int,
                **kw):
    """Package the usda stage as a single-layer .usdz archive."""
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".usda",
                                     delete=False) as tmp:
        tmp_path = tmp.name
    try:
        export_usda(tmp_path, attrs, sh_degree, **kw)
        with open(tmp_path) as f:
            payload = f.read().encode()
    finally:
        os.unlink(tmp_path)
    write_usdz_container(path, [("model.usda", payload)])


def import_usdz(path: str) -> dict:
    """Read a usdz archive written by export_usdz (or any usdz whose
    default layer is usda)."""
    import tempfile
    import zipfile

    with zipfile.ZipFile(path) as z:
        layer = z.namelist()[0]
        data = z.read(layer).decode()
    with tempfile.NamedTemporaryFile("w", suffix=".usda",
                                     delete=False) as tmp:
        tmp.write(data)
        tmp_path = tmp.name
    try:
        return import_usda(tmp_path)
    finally:
        os.unlink(tmp_path)


def export_ppisp_usda(path: str, ppisp_params: Dict,
                      append: bool = False):
    """Author PPISP parameters as a USD render-settings scope.

    Reference parity: the ppisp package's USD writer attaches the learned
    ISP (exposure / vignetting / color transform / CRF) to the stage so a
    downstream renderer can replay the capture-time processing. pxr is
    unavailable, so this emits the same data as a `Scope "PPISP"` with
    per-camera custom attributes in usda text.
    """
    p = {k: np.asarray(v, np.float32) for k, v in ppisp_params.items()}
    n_cams = p["responsivity"].shape[0]
    out = io.StringIO()
    if not append:
        out.write('#usda 1.0\n(\n    defaultPrim = "PPISP"\n)\n\n')
    out.write('def Scope "PPISP"\n{\n')
    out.write(f'    custom int numCameras = {n_cams}\n')
    out.write('    custom float[] responsivityLog2 = '
              + _fmt_floats(p["responsivity"].reshape(-1, 1), 1) + "\n")
    out.write('    custom float[] exposureLog2 = '
              + _fmt_floats(p["exposure"].reshape(-1, 1), 1) + "\n")
    out.write('    custom float2[] vignettingCenters = '
              + _fmt_floats(p["vig_center"].reshape(-1, 2), 2) + "\n")
    out.write('    custom float3[] vignettingAlphas = '
              + _fmt_floats(p["vig_alpha"].reshape(-1, 3), 3) + "\n")
    out.write('    custom float[] colorLatents = '
              + _fmt_floats(p["color_latents"].reshape(-1, 1), 1) + "\n")
    out.write('    custom float4[] crfParams = '
              + _fmt_floats(p["crf"].reshape(-1, 4), 4) + "\n")
    out.write('}\n')
    mode = "a" if append else "w"
    with open(path, mode) as f:
        f.write(out.getvalue())


def import_ppisp_usda(path: str) -> Dict:
    """Parse PPISP scope attributes written by export_ppisp_usda."""
    with open(path) as f:
        text = f.read()

    def grab(name):
        i = text.index(name)
        start = text.index("[", text.index("=", i + len(name)))
        end = text.index("]", start)
        return text[start + 1:end]

    resp = _parse_tuple_array(grab("float[] responsivityLog2"), 1)[:, 0]
    n_cams = resp.size
    lat = _parse_tuple_array(grab("float[] colorLatents"), 1)[:, 0]
    return {
        "responsivity": resp,
        "exposure": _parse_tuple_array(grab("float[] exposureLog2"),
                                       1)[:, 0],
        "vig_center": _parse_tuple_array(grab("float2[] vignettingCenters"),
                                         2).reshape(n_cams, 3, 2),
        "vig_alpha": _parse_tuple_array(grab("float3[] vignettingAlphas"),
                                        3).reshape(n_cams, 3, 3),
        "color_latents": lat.reshape(-1, 8),
        "crf": _parse_tuple_array(grab("float4[] crfParams"),
                                  4).reshape(n_cams, 3, 4),
    }


def bake_ppisp_into_sh(sh: np.ndarray, ppisp_params: Dict,
                       camera_idx: int = 0,
                       frame_idx: int = 0) -> np.ndarray:
    """Fold the LINEAR part of a camera's ISP into SH coefficients.

    Radiance is linear in the SH coefficients, so the responsivity and
    exposure scale commute with SH evaluation and can be baked for
    export (the reference's scale_sh_output, export/usd/post_processing/
    sh_bake.py:33, with the same DC-offset compensation: the +0.5 in the
    SH radiance convention must also be scaled). The vignetting,
    homography normalization and CRF are spatially-varying / nonlinear;
    fitting those needs the optimization bake in export/sh_bake.py.
    """
    sh = np.asarray(sh, np.float32)            # [N, K, 3]
    s = (2.0 ** float(np.asarray(ppisp_params["responsivity"])[camera_idx])
         * 2.0 ** float(np.asarray(ppisp_params["exposure"])[frame_idx]))
    out = sh * s
    # rgb = SH_lin + 0.5: scale the implicit offset through the DC term
    out[:, 0, :] += (s - 1.0) * 0.5 / 0.28209479177387814  # SH_C0
    return out


def export_model_usda(model, path: str, cameras=None, **kw):
    """Export a ``GaussianModel``'s live particles (post-activation):
    the rows below ``n_active`` of the normalised rotation, the activated
    scale and density and the SH coefficients, at the model's
    ``max_sh_degree``, as the JAX package exports a ``GaussianState``.
    SH models only: an NHT model has no SH coefficients to write."""
    import torch

    if model.config.feature_type != "sh":
        raise ValueError("export_model_usda writes SH models only: an NHT "
                         "model has no SH coefficients")
    n = model.n_active
    with torch.no_grad():
        rot = model.rotation[:n]
        rot = rot / torch.clamp(torch.linalg.norm(rot, dim=-1, keepdim=True),
                                min=1e-12)

        def host(t):
            return t.detach().cpu().numpy()

        attrs = dict(
            positions=host(model.positions[:n]),
            orientations=host(rot),
            scales=host(model.get_scale()[:n]),
            opacities=host(model.get_density()[:n, 0]),
            sh_coefficients=host(model.sh_coeffs()[:n]),
        )
    export_usda(path, attrs, sh_degree=model.config.max_sh_degree,
                cameras=cameras, **kw)
