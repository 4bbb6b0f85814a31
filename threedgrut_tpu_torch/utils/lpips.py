"""LPIPS perceptual metric (VGG16 trunk + linear heads) in PyTorch (port
of threedgrut_tpu/utils/lpips.py).

Reference parity: thirdparty/lpipsPyTorch (used by threedgrut/render.py
for the lpips column of metrics.json) - a VGG16 feature extractor whose
relu1_2/relu2_2/relu3_3/relu4_3/relu5_3 activations are channel-unit-
normalized, squared-differenced, passed through non-negative 1x1 linear
heads and spatially averaged.

No VGG weights ship with the repository and nothing is downloaded, so the
metric is weight-gated: `load_weights()` accepts the standard torch state
dicts (torchvision `vgg16` features + the `lpips` package's `vgg.pth`
linear heads, or the combined dict the lpips package serializes) or an
.npz in the JAX package's layout; `available()` reports whether weights
were found ($LPIPS_WEIGHTS / ~/.cache/threedgrut_tpu/). Evaluation code
reports no lpips when unavailable. The convolutions run in fp32 (the
package turns TF32 off at import).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv plan: (out_channels, n_convs) per block; maxpool between
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# activations tapped after the last relu of each block (relu{b}_{n})
_HEAD_CHANNELS = (64, 128, 256, 512, 512)

# ImageNet normalization used by lpipsPyTorch (modules/utils.py):
# input in [-1, 1], shifted/scaled
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def vgg16_features(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """x [N,3,H,W] normalized; returns the 5 tapped activations."""
    taps = []
    i = 0
    for bi, (ch, n_convs) in enumerate(_VGG_BLOCKS):
        for ci in range(n_convs):
            x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                                padding=1))
            i += 1
        taps.append(x)
        if bi < len(_VGG_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)
    return taps


def lpips(params: Dict[str, torch.Tensor], img0: torch.Tensor,
          img1: torch.Tensor) -> torch.Tensor:
    """LPIPS distance between two [N,3,H,W] images in [0, 1]."""
    dev = img0.device
    shift = torch.as_tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=dev)[None, :, None, None]

    def norm_input(im):
        return (im * 2.0 - 1.0 - shift) / scale

    f0 = vgg16_features(params, norm_input(img0))
    f1 = vgg16_features(params, norm_input(img1))
    total = 0.0
    for k, (a, b) in enumerate(zip(f0, f1)):
        a = a * torch.rsqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
        b = b * torch.rsqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
        d = (a - b) ** 2                                 # [N,C,H,W]
        w = params[f"lin{k}_w"]                          # [C]
        total = total + torch.mean(
            torch.sum(d * w[None, :, None, None], dim=1), dim=(1, 2))
    return torch.mean(total)


# --------------------------------------------------------------------------
# weight loading / conversion
# --------------------------------------------------------------------------

def _default_weight_paths():
    env = os.environ.get("LPIPS_WEIGHTS")
    cands = [env] if env else []
    cands += [
        os.path.expanduser("~/.cache/threedgrut_tpu/lpips_vgg16.npz"),
        os.path.expanduser("~/.cache/threedgrut_tpu/lpips_vgg16.pth"),
    ]
    return [c for c in cands if c]


def available() -> bool:
    return any(os.path.exists(p) for p in _default_weight_paths())


def convert_torch_state(vgg_state: dict, lin_state: dict) -> Dict[str, np.ndarray]:
    """torchvision vgg16 `features.*` + lpips `lin*.model.1.weight` ->
    flat param dict (conv{i}_w/b, lin{k}_w)."""
    params = {}
    conv_idx = 0
    layer = 0
    for ch, n_convs in _VGG_BLOCKS:
        for _ in range(n_convs):
            w = vgg_state.get(f"features.{layer}.weight",
                              vgg_state.get(f"slice.{layer}.weight"))
            b = vgg_state.get(f"features.{layer}.bias",
                              vgg_state.get(f"slice.{layer}.bias"))
            if w is None:
                raise KeyError(f"missing vgg16 conv weight at layer {layer}")
            params[f"conv{conv_idx}_w"] = np.asarray(w, np.float32)
            params[f"conv{conv_idx}_b"] = np.asarray(b, np.float32)
            conv_idx += 1
            layer += 2  # conv + relu
        layer += 1      # maxpool
    for k in range(5):
        w = lin_state.get(f"lin{k}.model.1.weight",
                          lin_state.get(f"lins.{k}.model.1.weight"))
        if w is None:
            raise KeyError(f"missing lpips linear head lin{k}")
        params[f"lin{k}_w"] = np.maximum(
            np.asarray(w, np.float32).reshape(-1), 0.0)
    return params


def _on(params: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def load_weights(path: Optional[str] = None, device="cpu"
                 ) -> Optional[Dict[str, torch.Tensor]]:
    """Load LPIPS params from an .npz (the JAX package's layout) or .pth
    (torch dicts {'vgg': vgg_state, 'lin': lin_state} or a flat combined
    dict) onto ``device``. Returns None when no weights are found."""
    paths = [path] if path else _default_weight_paths()
    for p in paths:
        if not p or not os.path.exists(p):
            continue
        if p.endswith(".npz"):
            data = np.load(p)
            return _on({k: data[k] for k in data.files}, device)
        state = torch.load(p, map_location="cpu", weights_only=False)
        if isinstance(state, dict) and "vgg" in state and "lin" in state:
            params = convert_torch_state(
                {k: v.numpy() for k, v in state["vgg"].items()},
                {k: v.numpy() for k, v in state["lin"].items()})
        else:
            flat = {k: v.numpy() if hasattr(v, "numpy") else v
                    for k, v in state.items()}
            params = convert_torch_state(flat, flat)
        return _on(params, device)
    return None


def random_params(seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """He-initialized params (architecture tests only - NOT a trained
    perceptual metric); the JAX package's numpy draws, in its order."""
    rng = np.random.default_rng(seed)
    params = {}
    in_ch = 3
    i = 0
    for ch, n_convs in _VGG_BLOCKS:
        for _ in range(n_convs):
            fan_in = in_ch * 9
            params[f"conv{i}_w"] = rng.normal(
                0, np.sqrt(2.0 / fan_in), (ch, in_ch, 3, 3)).astype(np.float32)
            params[f"conv{i}_b"] = np.zeros((ch,), np.float32)
            in_ch = ch
            i += 1
    for k, ch in enumerate(_HEAD_CHANNELS):
        params[f"lin{k}_w"] = rng.uniform(0, 0.1, ch).astype(np.float32)
    return _on(params, device)
