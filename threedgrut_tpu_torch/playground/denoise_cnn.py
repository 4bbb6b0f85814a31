"""Learned CNN denoiser for path-traced playground frames
(port of threedgrut_tpu/playground/denoise_cnn.py).

The reference playground denoises its hybrid path-traced frames with
the OptiX AI denoiser, a pretrained network applied as a post-pass
(threedgrut_playground/src/hybridTracer.cpp:503); this is the JAX
package's small learned residual CNN in its place:

  * input: the noisy RGB frame, optionally concatenated with the
    engine's AOV guides (alpha-blended normals, depth),
  * body: 3x3 convolutions (``F.conv2d`` in fp32, "SAME" padding, on
    NHWC frames) with two residual blocks,
  * output: a residual added back to the input, clipped to [0, 1].

The weights are the JAX package's, trained by
``scripts/train_denoiser.py`` and committed beside this module as a byte
copy (``denoiser_weights.npz``, HWIO kernels under ``<layer>/w``).
``denoise_frame`` falls through to the à-trous filter when no weights
file is found, as in JAX. Loaded weights are cached by path and device
(the JAX ``load_params`` keeps one cache whatever the path).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "denoiser_weights.npz")

_WIDTH = 24
_GUIDE_CH = 7   # rgb(3) + normals(3) + depth(1)
_LAYERS = ("conv_in", "res0_a", "res0_b", "res1_a", "res1_b", "conv_out")


def init_params(generator: torch.Generator, guides: bool = True,
                device="cpu"):
    """He-normal parameters {layer: {"w": [3, 3, Cin, Cout] (HWIO), "b":
    [Cout]}} drawn from ``generator`` (a CPU generator), with a zero
    output convolution: the untrained net is the identity. About 29k
    parameters."""
    c_in = _GUIDE_CH if guides else 3
    shapes = {
        "conv_in": (3, 3, c_in, _WIDTH),
        "res0_a": (3, 3, _WIDTH, _WIDTH),
        "res0_b": (3, 3, _WIDTH, _WIDTH),
        "res1_a": (3, 3, _WIDTH, _WIDTH),
        "res1_b": (3, 3, _WIDTH, _WIDTH),
        "conv_out": (3, 3, _WIDTH, 3),
    }
    params = {}
    for name, shp in shapes.items():
        fan_in = shp[0] * shp[1] * shp[2]
        w = torch.randn(shp, generator=generator) * float(np.sqrt(
            2.0 / fan_in))
        params[name] = {"w": w.to(device),
                        "b": torch.zeros(shp[3], device=device)}
    params["conv_out"]["w"] = torch.zeros_like(params["conv_out"]["w"])
    return params


def _conv(x, p):
    """3x3 "SAME" convolution of NHWC ``x`` with an HWIO kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                 p["b"], padding=1)
    return y.permute(0, 2, 3, 1)


def apply_cnn(params, rgb, normals=None, depth=None):
    """Denoise an [H, W, 3] frame (or [N, H, W, 3] batch).

    normals [.., H, W, 3] and depth [.., H, W] / [.., H, W, 1] are the
    engine AOV guides, read where the weights take guides; zeros are
    substituted when absent.
    """
    squeeze = rgb.ndim == 3
    if squeeze:
        rgb = rgb[None]
        normals = None if normals is None else normals[None]
        depth = None if depth is None else depth[None]
    n, h, w, _ = rgb.shape
    guides = params["conv_in"]["w"].shape[2] == _GUIDE_CH
    x = rgb
    if guides:
        nrm = (torch.zeros((n, h, w, 3), dtype=rgb.dtype, device=rgb.device)
               if normals is None else normals)
        if depth is None:
            dep = torch.zeros((n, h, w, 1), dtype=rgb.dtype,
                              device=rgb.device)
        else:
            dep = depth if depth.ndim == 4 else depth[..., None]
            # a bounded guide: silhouette edges matter, absolute scale not
            dep = dep / (1.0 + torch.abs(dep))
        x = torch.cat([rgb, nrm, dep], dim=-1)

    y = torch.relu(_conv(x, params["conv_in"]))
    for i in range(2):
        r = torch.relu(_conv(y, params[f"res{i}_a"]))
        y = torch.relu(y + _conv(r, params[f"res{i}_b"]))
    res = _conv(y, params["conv_out"])
    out = torch.clamp(rgb + res, 0.0, 1.0)
    return out[0] if squeeze else out


_cache: dict = {}


def load_params(path: str = WEIGHTS_PATH, device="cpu"):
    """The weights file at ``path`` as fp32 tensors on ``device``, or
    None when there is no such file; cached by path (and its
    modification time) and device."""
    if not os.path.exists(path):
        return None
    key = (os.path.realpath(path), os.stat(path).st_mtime_ns,
           str(torch.device(device)))
    if key not in _cache:
        params = {}
        with np.load(path) as raw:
            for k in raw.files:
                layer, leaf = k.rsplit("/", 1)
                params.setdefault(layer, {})[leaf] = torch.as_tensor(
                    raw[k], dtype=torch.float32, device=device)
        _cache[key] = params
    return _cache[key]


def save_params(params, path: str = WEIGHTS_PATH):
    flat = {}
    for layer, leaves in params.items():
        for leaf, v in leaves.items():
            flat[f"{layer}/{leaf}"] = np.asarray(
                v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    np.savez_compressed(path, **flat)


def denoise_frame(rgb, normals=None, depth=None,
                  path: Optional[str] = None):
    """The CNN's denoise of ``rgb`` with the weights at ``path`` (default
    ``WEIGHTS_PATH``); the à-trous filter where that file is missing, as
    JAX falls through."""
    params = load_params(path or WEIGHTS_PATH, rgb.device)
    if params is None:
        from .denoise import atrous_denoise
        return atrous_denoise(rgb, normals=normals, depth=depth)
    return apply_cnn(params, rgb, normals=normals, depth=depth)
