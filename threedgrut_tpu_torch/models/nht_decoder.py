"""NHT feature decoder: the small MLP that maps rendered ray features to
RGB (port of threedgrut_tpu/models/nht_decoder.py:28-104; reference
threedgrut/model/feature_decoder.py:21-222, a tiny-cuda-nn
NetworkWithInputEncoding).

Input: the alpha-blended ray features [..., F] and an SH encoding of the
ray directions, whose unit vectors are first mapped through the tcnn
cube convention ((v * SH_SCALE + 1) / 2, then back to [-1, 1]); degree-D
tcnn SH has D^2 components. Then ``NUM_LAYERS`` bias-free ReLU layers of
``HIDDEN_DIM`` and a bias-free 3-wide layer with a sigmoid. The sizes are
the published model's (configs/base.yaml:50-72), which every config and
the JAX trainer use.

Precision: the configurations ask for a half-precision decoder
(tiny-cuda-nn's fp16 network with a loss scale; the JAX package runs
bf16 on the TPU). On the card the products take fp16 operands and the
hidden activations are fp16, as in tcnn; the products accumulate in
fp32, the 3 outputs and the sigmoid are fp32, and the backward scales its
cotangents by a power of two chosen from their largest on the device
(``_Mlp``) and writes each weight's cotangent (a sum over the rows) and
the inputs' in fp32. Without a scale the loss's
per-pixel cotangents (~1e-7 at a million pixels) fall below fp16's
normal range and the weights' cotangents flush to 0; a fixed one
overflows where a caller's cotangents are large. On the CPU the products
are fp32. bf16's 7 mantissa bits would compute more coarsely than the
configuration states. Measured on an H100 at 1,016,814 pixels against
float64 (PERF.md, section 6): fp16 with a scale is 1.30e-4 off in its
outputs and 2.6e-2 in its cotangents, TF32 products 1.25e-4 and 2.6e-2,
bf16 1.07e-3 and 7.5e-2; the forward and backward take 4.1 ms in fp16,
6.5 ms in TF32 (its activations are fp32, twice the bytes).

EMA: a shadow copy of the weights, updated at every step as
shadow <- EMA_DECAY * shadow + (1 - EMA_DECAY) * weights; validation
decodes through it (feature_decoder.py:106-141).
"""

from __future__ import annotations

import contextlib
import math
from typing import List

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.sh import sh_basis

# configs/base.yaml:50-72 (nht_decoder)
HIDDEN_DIM = 128
NUM_LAYERS = 3
DIR_ENCODING_DEGREE = 3     # tcnn SH degree 3: 9 components
SH_SCALE = 3.0
EMA_DECAY = 0.95            # from step 0, every step

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class FeatureDecoder(nn.Module):
    """MLP [features + direction encoding] -> RGB, with an EMA shadow.

    ``layers[i].weight`` is the transpose of the JAX decoder's
    ``params/Dense_i/kernel`` ([out, in] against [in, out]);
    ``convert.py`` carries them across."""

    def __init__(self, ray_feature_dim: int, seed: int = 0, device="cpu"):
        super().__init__()
        self.ray_feature_dim = ray_feature_dim
        widths = ([ray_feature_dim + DIR_ENCODING_DEGREE ** 2]
                  + [HIDDEN_DIM] * NUM_LAYERS + [3])
        gen = torch.Generator().manual_seed(seed)
        self.layers = nn.ModuleList()
        for fan_in, fan_out in zip(widths[:-1], widths[1:]):
            layer = nn.Linear(fan_in, fan_out, bias=False)
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            with torch.no_grad():
                layer.weight.copy_(nn.init.trunc_normal_(
                    torch.empty(fan_out, fan_in), std=std, a=-2.0 * std,
                    b=2.0 * std, generator=gen))
            self.layers.append(layer)
        self.to(device)
        self.ema_shadow: List[torch.Tensor] = [
            w.detach().clone() for w in self.weights()]

    def weights(self) -> List[nn.Parameter]:
        """The layers' weights, input layer first."""
        return [layer.weight for layer in self.layers]

    @staticmethod
    def encode_input(features: torch.Tensor, dirs: torch.Tensor
                     ) -> torch.Tensor:
        """features [..., F], world unit dirs [..., 3] -> [..., F + D^2]."""
        cube = (dirs * SH_SCALE + 1.0) * 0.5
        remapped = cube * 2.0 - 1.0
        enc = sh_basis(remapped, DIR_ENCODING_DEGREE - 1)
        return torch.cat([features, enc], dim=-1)

    def forward(self, features: torch.Tensor, dirs: torch.Tensor,
                use_ema: bool = False) -> torch.Tensor:
        """RGB [..., 3] of ray features [..., F] along dirs [..., 3];
        ``use_ema`` decodes with the shadow weights."""
        ws = self.ema_shadow if use_ema else self.weights()
        return mlp(self.encode_input(features, dirs), ws)

    @torch.no_grad()
    def ema_update(self):
        """shadow <- EMA_DECAY * shadow + (1 - EMA_DECAY) * weights."""
        for s, w in zip(self.ema_shadow, self.weights()):
            s.copy_(EMA_DECAY * s + (1.0 - EMA_DECAY) * w)


# the fp16 backward scales the sigmoid's cotangent so that its largest
# entry is 2^8: the loss's (~1e-7 a pixel at a million pixels) then lie in
# fp16's normal range (6.1e-5 up), and the three layers they pass back
# through stay below its largest value (65504)
COTANGENT_MAX = 256.0


@contextlib.contextmanager
def _fp32_sums():
    """cuBLAS's fp16 products sum in fp32 inside the block, their split-K
    reductions too (PyTorch lets those sum in fp16 by default)."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_fp16_reduced_precision_reduction
    matmul.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_fp16_reduced_precision_reduction = before


def _mm(a: torch.Tensor, b: torch.Tensor, half: bool) -> torch.Tensor:
    """a @ b written in fp32 (fp16 operands accumulate in fp32)."""
    return torch.mm(a, b, out_dtype=torch.float32) if half else a.mm(b)


class _Mlp(torch.autograd.Function):
    """The bias-free ReLU layers and the sigmoid output: fp16 operands and
    hidden activations on the card, fp32 on the CPU. On the card the
    backward scales the cotangents by a power of two (the loss scale; the
    largest brought to ``COTANGENT_MAX``) and writes the weights'
    cotangents, sums over every row, and the inputs' in fp32."""

    @staticmethod
    def forward(ctx, x, *ws):
        half = x.is_cuda
        ws = [w.half() for w in ws] if half else list(ws)
        hs = [x.half() if half else x]
        with _fp32_sums():
            for w in ws[:-1]:
                hs.append(torch.relu(F.linear(hs[-1], w)))
            # the 3 outputs leave the products in fp32
            y = torch.sigmoid(_mm(hs[-1], ws[-1].t(), half))
        ctx.save_for_backward(y, *hs, *ws)
        return y

    @staticmethod
    def backward(ctx, gy):
        y, *rest = ctx.saved_tensors
        n = len(rest) // 2
        hs, ws = rest[:n], rest[n:]
        half = hs[0].dtype == torch.float16
        g = torch.ops.aten.sigmoid_backward(gy, y)
        scale = 1.0
        if half:   # on the device: no host read
            scale = torch.exp2(torch.floor(torch.log2(
                COTANGENT_MAX / g.abs().amax().clamp_min(1e-30))))
            g = (g * scale).half()
        gws = [None] * n
        with _fp32_sums():
            for i in range(n - 1, 0, -1):
                gws[i] = _mm(g.t(), hs[i], half) / scale
                # through the layer and the ReLU that made hs[i]
                g = torch.ops.aten.threshold_backward(g.mm(ws[i]), hs[i],
                                                      0.0)
            gws[0] = _mm(g.t(), hs[0], half) / scale
            gx = (_mm(g, ws[0], half) / scale if ctx.needs_input_grad[0]
                  else None)
        return (gx, *gws)


def mlp(x: torch.Tensor, ws: List[torch.Tensor]) -> torch.Tensor:
    """sigmoid(W_L relu(... relu(W_1 x))) of the encoded rows x [N, K];
    counts the rows it decodes in ``mlp.rows``."""
    mlp.rows += x.shape[0]
    return _Mlp.apply(x, *ws)


mlp.rows = 0
