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

Precision: the JAX decoder runs its Dense layers with bfloat16 operands
and activations on fp32 parameters (flax ``dtype=bfloat16``), and the
reference's tcnn MLP is half precision too; this module mirrors those
casts (bf16 operands, products and ReLU; the sigmoid in fp32), a
deliberate exception to the port's fp32 rule. The products are plain
matrix products, ``torch.nn.functional.linear`` (JAX leaves them to XLA
outside any Pallas kernel).

EMA: a shadow copy of the weights, updated at every step as
shadow <- EMA_DECAY * shadow + (1 - EMA_DECAY) * weights; validation
decodes through it (feature_decoder.py:106-141).
"""

from __future__ import annotations

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
        x = self.encode_input(features, dirs).to(torch.bfloat16)
        for w in ws[:-1]:
            x = torch.relu(F.linear(x, w.to(torch.bfloat16)))
        x = F.linear(x, ws[-1].to(torch.bfloat16)).to(torch.float32)
        return torch.sigmoid(x)

    @torch.no_grad()
    def ema_update(self):
        """shadow <- EMA_DECAY * shadow + (1 - EMA_DECAY) * weights."""
        for s, w in zip(self.ema_shadow, self.weights()):
            s.copy_(EMA_DECAY * s + (1.0 - EMA_DECAY) * w)
