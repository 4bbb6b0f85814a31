"""Gaussian mixture model with a fixed capacity
(port of threedgrut_tpu/models/gaussians.py).

Parameters live in capacity-sized tensors with an ``n_active`` count, as
in the JAX package, so rows compare one to one with it. Raw
(pre-activation) parameters: positions [C,3], rotation [C,4] (wxyz,
unnormalized), scale [C,3] (log-scale by default), density [C,1] (logit
by default), features_albedo [C,3] and features_specular [C,S]
(coefficient-major SH).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.sh import num_sh_coeffs

PARAM_NAMES = ("positions", "rotation", "scale", "density",
               "features_albedo", "features_specular")

ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "exp": torch.exp,
    "none": lambda x: x,
}


@dataclasses.dataclass(frozen=True)
class GaussianModelConfig:
    """Model configuration (the model block of configs/base_gs.yaml)."""
    density_activation: str = "sigmoid"
    scale_activation: str = "exp"
    feature_type: str = "sh"
    max_sh_degree: int = 3


def default_capacity_for(n_points: int) -> int:
    """Capacity rounded up to a multiple of 256 (as the JAX package)."""
    return max(int(np.ceil(n_points / 256.0)) * 256, 256)


class GaussianModel(nn.Module):
    """Capacity-layout Gaussians; rows >= ``n_active`` are dead slots."""

    def __init__(self, params: Dict[str, torch.Tensor], n_active: int,
                 n_active_features: int,
                 config: GaussianModelConfig = GaussianModelConfig()):
        super().__init__()
        if config.feature_type != "sh":
            raise NotImplementedError(
                "only SH features are ported (NHT comes later)")
        cap = params["positions"].shape[0]
        k = num_sh_coeffs(config.max_sh_degree)
        if params["features_specular"].shape != (cap, 3 * (k - 1)):
            raise ValueError(
                f"features_specular {tuple(params['features_specular'].shape)}"
                f" does not match max_sh_degree {config.max_sh_degree}")
        for name in PARAM_NAMES:
            setattr(self, name, nn.Parameter(
                params[name].to(torch.float32).contiguous()))
        self.n_active = int(n_active)
        self.n_active_features = int(n_active_features)
        self.config = config

    # ---- constructors ----
    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], n_active=None,
                   n_active_features=None, config=None, device="cpu"):
        """From raw parameter arrays named as the JAX package names them."""
        params = {k: torch.tensor(np.asarray(arrays[k], np.float32),
                                  device=device) for k in PARAM_NAMES}
        cap = params["positions"].shape[0]
        spec = params["features_specular"].shape[1]
        degree = int(round(np.sqrt(spec // 3 + 1))) - 1
        config = config or GaussianModelConfig(max_sh_degree=degree)
        return cls(params, cap if n_active is None else n_active,
                   degree if n_active_features is None else n_active_features,
                   config)

    @classmethod
    def from_checkpoint(cls, path: str, config=None, device="cpu"):
        """From a trainer ``.npz`` checkpoint (``params/<name>``,
        ``n_active``, ``n_active_features``)."""
        with np.load(path) as data:
            arrays = {k: data[f"params/{k}"] for k in PARAM_NAMES}
            n_active = int(data["n_active"])
            degree = int(data["n_active_features"])
        config = config or GaussianModelConfig(max_sh_degree=max(degree, 0))
        return cls.from_numpy(arrays, n_active, degree, config, device)

    @classmethod
    def from_ply(cls, path: str, capacity: Optional[int] = None,
                 config=None, device="cpu"):
        """From a 3DGS ``.ply`` (raw parameters), padded to capacity the
        way the JAX package's ``export/ply.import_model`` pads."""
        from threedgrut_tpu.export.ply import import_ply  # numpy only

        raw = import_ply(path)
        n = raw["positions"].shape[0]
        spec_dim = raw["features_specular"].shape[1]
        degree = int(np.sqrt(spec_dim // 3 + 1)) - 1
        config = config or GaussianModelConfig(max_sh_degree=degree)
        cap = capacity or default_capacity_for(n)
        want = 3 * (num_sh_coeffs(config.max_sh_degree) - 1)
        spec = np.zeros((n, want), np.float32)
        keep = min(want, spec_dim)
        spec[:, :keep] = raw["features_specular"][:, :keep]
        raw["features_specular"] = spec
        fill = {"scale": -10.0, "density": -10.0}
        arrays = {}
        for k in PARAM_NAMES:
            a = raw[k]
            out = np.full((cap,) + a.shape[1:], fill.get(k, 0.0), np.float32)
            out[:n] = a
            arrays[k] = out
        return cls.from_numpy(arrays, n, degree, config, device)

    # ---- post-activation views ----
    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def active_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.n_active

    def get_scale(self) -> torch.Tensor:
        return ACTIVATIONS[self.config.scale_activation](self.scale)

    def get_density(self) -> torch.Tensor:
        return ACTIVATIONS[self.config.density_activation](self.density)

    def sh_coeffs(self) -> torch.Tensor:
        """[C, K, 3] SH coefficients, coefficient-major (DC first)."""
        k = num_sh_coeffs(self.config.max_sh_degree)
        rest = self.features_specular.reshape(self.capacity, k - 1, 3)
        return torch.cat([self.features_albedo[:, None, :], rest], dim=1)
