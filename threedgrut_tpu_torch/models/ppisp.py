"""PPISP: the learned per-(camera, frame) ISP and its controller CNN
(port of threedgrut_tpu/models/ppisp.py, plain PyTorch).

- The ISP chain of the runtime SPG shader
  (threedgrut/export/usd/post_processing/ppisp_spg/ppisp_usd_spg.cu:199
  applyPPISPColor): responsivity -> 2^exposure -> per-channel radial
  vignetting -> chromaticity homography from four 2D colour latents ->
  per-channel parametric CRF (toe / shoulder / gamma / centre).
- The controller (ppisp_controller_weights.py:84
  ControllerArchitectureSpec): three 1x1 convolutions, per-pixel linear
  layers 3 -> 16 -> 32 -> 64, with a floor-mode max pool of 3 after the
  first, an adaptive average pool to 5x5 (torch's bins), a 3-layer
  128-wide ReLU trunk over the flattened features and a prior exposure,
  and two heads (an exposure offset, 8 colour latents).

Every product is a sum of fp32 elementwise products or an fp32
``nn.Linear`` (TF32 is off, ``threedgrut_tpu_torch/__init__.py``). The
clamps are ``torch.maximum`` / ``torch.minimum`` against constants, as
``jnp.clip`` and ``jnp.maximum`` are, so a value on a bound sends half
its gradient through, as in JAX: at initialisation the vignetting
falloff sits exactly on its upper bound.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

# fixed 2x2 whitening of the colour latents (ppisp_usd_spg.cu:72-79):
# constants of the format
_LATENT_WHITEN = np.asarray([
    [[0.0480542, -0.0043631], [-0.0043631, 0.0481283]],   # blue
    [[0.0580570, -0.0179872], [-0.0179872, 0.0431061]],   # red
    [[0.0433336, -0.0180537], [-0.0180537, 0.0580500]],   # green
    [[0.0128369, -0.0034654], [-0.0034654, 0.0128158]],   # neutral
], np.float32)

PARAM_NAMES = ("exposure", "color_latents", "responsivity", "vig_center",
               "vig_alpha", "crf")


def init_ppisp_params(n_cameras: int, n_frames: int,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """Learnable ISP parameters, identity-initialised.

    Per frame: exposure [F] (log2 offsets), color_latents [F, 8]
    (blue / red / green / neutral xy pairs; 0 is the identity
    homography). Per camera: responsivity [C], vig_center [C, 3, 2],
    vig_alpha [C, 3, 3] (r^2 / r^4 / r^6 coefficients), crf [C, 3, 4]
    (raw toe / shoulder / gamma / centre)."""
    shapes = dict(exposure=(n_frames,), color_latents=(n_frames, 8),
                  responsivity=(n_cameras,), vig_center=(n_cameras, 3, 2),
                  vig_alpha=(n_cameras, 3, 3), crf=(n_cameras, 3, 4))
    return {k: torch.zeros(s, dtype=torch.float32, device=device)
            for k, s in shapes.items()}


def _clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip`` / ``jnp.maximum`` / ``jnp.minimum`` with their
    gradient: half of it through a value that sits on a bound."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] as fp32 elementwise sums."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def compute_homography(latents: torch.Tensor) -> torch.Tensor:
    """Chromaticity homography from the 8 colour latents
    (ppisp_usd_spg.cu:69 computeHomography). latents [..., 8] as (blue,
    red, green, neutral) xy pairs; returns [..., 3, 3]."""
    lat = latents.reshape(latents.shape[:-1] + (4, 2))
    wh = torch.as_tensor(_LATENT_WHITEN, device=latents.device)
    d = (wh * lat[..., :, None, :]).sum(dim=-1)          # whitened deltas
    bd, rd, gd, nd = (d[..., k, :] for k in range(4))
    one = torch.ones_like(bd[..., 0])
    zero = torch.zeros_like(one)
    t_b = torch.stack([bd[..., 0], bd[..., 1], one], dim=-1)
    t_r = torch.stack([1.0 + rd[..., 0], rd[..., 1], one], dim=-1)
    t_g = torch.stack([gd[..., 0], 1.0 + gd[..., 1], one], dim=-1)
    t_n = torch.stack([1.0 / 3.0 + nd[..., 0], 1.0 / 3.0 + nd[..., 1], one],
                      dim=-1)
    t = torch.stack([t_b, t_r, t_g], dim=-1)             # columns: anchors
    skew = torch.stack([
        torch.stack([zero, -t_n[..., 2], t_n[..., 1]], dim=-1),
        torch.stack([t_n[..., 2], zero, -t_n[..., 0]], dim=-1),
        torch.stack([-t_n[..., 1], t_n[..., 0], zero], dim=-1),
    ], dim=-2)
    m = _matmul3(skew, t)
    # the null vector of m (t_n in the anchor basis): the largest of the
    # rows' cross products, for stability
    c01 = torch.cross(m[..., 0, :], m[..., 1, :], dim=-1)
    c02 = torch.cross(m[..., 0, :], m[..., 2, :], dim=-1)
    c12 = torch.cross(m[..., 1, :], m[..., 2, :], dim=-1)
    n01 = (c01 * c01).sum(dim=-1, keepdim=True)
    n02 = (c02 * c02).sum(dim=-1, keepdim=True)
    lam = torch.where(n01 >= 1e-20, c01, torch.where(n02 >= 1e-20, c02, c12))
    h = t * lam[..., None, :]                            # t @ diag(lam)
    sinv = torch.tensor([[-1.0, -1.0, 1.0], [1.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0]], device=latents.device)
    h = _matmul3(h, sinv.expand(h.shape))
    s = h[..., 2:3, 2:3]
    big = s.abs() > 1e-20
    return torch.where(big, h / torch.where(big, s, torch.ones_like(s)), h)


def apply_crf(x: torch.Tensor, crf_raw: torch.Tensor) -> torch.Tensor:
    """Parametric camera response (ppisp_usd_spg.cu:154 applyCRF).
    x [..., 3] (clamped to [0, 1]); crf_raw [3, 4] raw per-channel
    parameters. Both branches are computed and one is selected; their
    powers are floored at 1e-12, so the branch not taken sends a finite
    gradient times zero."""
    x = _clip(x, 0.0, 1.0)
    toe = 0.3 + F.softplus(crf_raw[:, 0])
    shoulder = 0.3 + F.softplus(crf_raw[:, 1])
    gamma = 0.1 + F.softplus(crf_raw[:, 2])
    eps = 1e-6
    center = _clip(torch.sigmoid(crf_raw[:, 3]), eps, 1.0 - eps)
    lerp = _clip((shoulder - toe) * center + toe, eps)
    a = shoulder * center / lerp
    b = 1.0 - a
    below = a * torch.pow(_clip(x / center, 1e-12), toe)
    above = 1.0 - b * torch.pow(_clip((1.0 - x) / (1.0 - center), 1e-12),
                                shoulder)
    y = torch.where(x <= center, below, above)
    return torch.pow(_clip(y, 1e-12), gamma)


def pixel_grid(h: int, w: int, device="cpu") -> torch.Tensor:
    """The shader's centred, max-resolution-normalised pixel uv [H, W, 2]
    (ppisp_usd_spg.cu:184 computeTileUv with one tile)."""
    max_res = float(max(h, w))
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5
          - h * 0.5) / max_res
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5
          - w * 0.5) / max_res
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                       dim=-1)


def apply_ppisp_full(params: Dict[str, torch.Tensor], rgb: torch.Tensor,
                     camera_idx, frame_idx, exposure=None,
                     color_latents=None) -> torch.Tensor:
    """The full SPG ISP chain on a rendered [H, W, 3] radiance image.
    ``exposure`` / ``color_latents`` override the per-frame tables (the
    controller's predictions)."""
    h, w = rgb.shape[:2]
    pixel_uv = pixel_grid(h, w, rgb.device)
    if exposure is None:
        exposure = params["exposure"][frame_idx]
    if color_latents is None:
        color_latents = params["color_latents"][frame_idx]

    resp = torch.pow(2.0, params["responsivity"][camera_idx])
    x = rgb * resp * torch.pow(2.0, exposure)

    # per-channel radial vignetting
    center = params["vig_center"][camera_idx]            # [3, 2]
    alpha = params["vig_alpha"][camera_idx]              # [3, 3]
    delta = pixel_uv[:, :, None, :] - center[None, None]  # [H, W, 3, 2]
    r2 = (delta * delta).sum(dim=-1)                     # [H, W, 3]
    falloff = 1.0 + alpha[None, None, :, 0] * r2 \
        + alpha[None, None, :, 1] * r2 * r2 \
        + alpha[None, None, :, 2] * r2 * r2 * r2
    x = x * _clip(falloff, 0.0, 1.0)

    # chromaticity homography on (r, g, intensity)
    hmat = compute_homography(color_latents)             # [3, 3]
    intensity = x.sum(dim=-1, keepdim=True)
    rgi = torch.cat([x[..., 0:1], x[..., 1:2], intensity], dim=-1)
    rgi = (hmat * rgi[..., None, :]).sum(dim=-1)
    scale = intensity / (rgi[..., 2:3] + 1e-5)
    rgi = rgi * scale
    x = torch.cat([rgi[..., 0:1], rgi[..., 1:2],
                   rgi[..., 2:3] - rgi[..., 0:1] - rgi[..., 1:2]], dim=-1)
    return apply_crf(x, params["crf"][camera_idx])


# ---------------------------------------------------------------------------
# the controller (ControllerArchitectureSpec defaults)
# ---------------------------------------------------------------------------

CONTROLLER_SPEC = dict(
    input_downsampling=3, cnn_in_channels=3, cnn_layer_1_channels=16,
    cnn_layer_2_channels=32, cnn_feature_dim=64, pool_grid=(5, 5),
    mlp_hidden_dim=128, num_mlp_trunk_layers=3, color_params_per_frame=8,
)
# the layers in the reference's export order, under the flax names
CONTROLLER_LAYERS = (
    ("conv1", CONTROLLER_SPEC["cnn_in_channels"],
     CONTROLLER_SPEC["cnn_layer_1_channels"]),
    ("conv2", CONTROLLER_SPEC["cnn_layer_1_channels"],
     CONTROLLER_SPEC["cnn_layer_2_channels"]),
    ("conv3", CONTROLLER_SPEC["cnn_layer_2_channels"],
     CONTROLLER_SPEC["cnn_feature_dim"]),
    ("trunk0", CONTROLLER_SPEC["cnn_feature_dim"]
     * math.prod(CONTROLLER_SPEC["pool_grid"]) + 1,
     CONTROLLER_SPEC["mlp_hidden_dim"]),
    *((f"trunk{i}", CONTROLLER_SPEC["mlp_hidden_dim"],
       CONTROLLER_SPEC["mlp_hidden_dim"])
      for i in range(1, CONTROLLER_SPEC["num_mlp_trunk_layers"])),
    ("exposure_head", CONTROLLER_SPEC["mlp_hidden_dim"], 1),
    ("color_head", CONTROLLER_SPEC["mlp_hidden_dim"],
     CONTROLLER_SPEC["color_params_per_frame"]),
)
# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class PPISPControllerCNN(nn.Module):
    """Image-conditioned controller predicting per-frame (exposure
    offset, 8 colour latents): the reference controller's CNN and MLP.
    Weights are drawn as flax draws them (lecun_normal kernels, zero
    biases), from a torch generator seeded with ``seed``; the values
    differ from flax's, whose generator torch does not have
    (``convert.py:controller_from_flax`` carries flax's across)."""

    def __init__(self, seed: int = 0, device="cpu"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.layers = nn.ModuleDict()
        for name, fan_in, fan_out in CONTROLLER_LAYERS:
            layer = nn.Linear(fan_in, fan_out)
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            with torch.no_grad():
                layer.weight.copy_(nn.init.trunc_normal_(
                    torch.empty(fan_out, fan_in), std=std, a=-2.0 * std,
                    b=2.0 * std, generator=gen))
                layer.bias.zero_()
            self.layers[name] = layer
        self.to(device)

    def forward(self, img: torch.Tensor, prior_exposure: torch.Tensor):
        """img [B, H, W, 3] HDR radiance, prior_exposure [B] ->
        (exposure [B], colour latents [B, 8])."""
        s = CONTROLLER_SPEC["input_downsampling"]
        L = self.layers
        x = torch.relu(L["conv1"](img))
        b, h, w = x.shape[:3]
        # MaxPool2d(kernel = stride = s), floor mode
        x = x[:, :h - h % s, :w - w % s]
        x = x.reshape(b, h // s, s, w // s, s, -1).amax(dim=(2, 4))
        x = torch.relu(L["conv2"](x))
        x = torch.relu(L["conv3"](x))
        x = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2),
                                  CONTROLLER_SPEC["pool_grid"])
        t = torch.cat([x.permute(0, 2, 3, 1).reshape(b, -1),
                       prior_exposure.reshape(b, 1)], dim=-1)
        for i in range(CONTROLLER_SPEC["num_mlp_trunk_layers"]):
            t = torch.relu(L[f"trunk{i}"](t))
        return L["exposure_head"](t)[:, 0], L["color_head"](t)

    def predict(self, img: torch.Tensor, prior_exposure=0.0):
        """One [H, W, 3] image -> (exposure [], colour latents [8])."""
        prior = torch.full((1,), float(prior_exposure), dtype=img.dtype,
                           device=img.device)
        e, c = self(img[None], prior)
        return e[0], c[0]


def flatten_controller_weights(ctrl: PPISPControllerCNN) -> np.ndarray:
    """The controller's weights in the reference export layout
    (ppisp_controller_weights.py:318): each layer's weight [out, in]
    row-major, then its bias, in ``CONTROLLER_LAYERS`` order."""
    chunks = []
    for name, _, _ in CONTROLLER_LAYERS:
        layer = ctrl.layers[name]
        chunks.append(layer.weight.detach().cpu().numpy().reshape(-1))
        chunks.append(layer.bias.detach().cpu().numpy().reshape(-1))
    return np.concatenate(chunks).astype(np.float32)


def unflatten_controller_weights(ctrl: PPISPControllerCNN,
                                 flat: np.ndarray) -> PPISPControllerCNN:
    """The inverse of ``flatten_controller_weights``: loads ``flat`` into
    ``ctrl`` in place and returns it."""
    flat = np.asarray(flat, np.float32)
    at = 0
    with torch.no_grad():
        for name, fan_in, fan_out in CONTROLLER_LAYERS:
            layer = ctrl.layers[name]
            for p, n in ((layer.weight, fan_out * fan_in),
                         (layer.bias, fan_out)):
                p.copy_(torch.from_numpy(flat[at:at + n].reshape(p.shape)))
                at += n
    if at != flat.size:
        raise ValueError(f"{flat.size} weights for a controller of {at}")
    return ctrl
