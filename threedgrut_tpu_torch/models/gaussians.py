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

from ..ops.sh import SH_C0, num_sh_coeffs

PARAM_NAMES = ("positions", "rotation", "scale", "density",
               "features_albedo", "features_specular")

ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "exp": torch.exp,
    "none": lambda x: x,
}
INVERSE_ACTIVATIONS = {
    "sigmoid": lambda x: torch.log(x / (1.0 - x)),
    "exp": torch.log,
    "none": lambda x: x,
}


@dataclasses.dataclass(frozen=True)
class GaussianModelConfig:
    """Model configuration (the model block of configs/base_gs.yaml)."""
    density_activation: str = "sigmoid"
    scale_activation: str = "exp"
    feature_type: str = "sh"
    max_sh_degree: int = 3
    default_density: float = 0.1
    default_scale_factor: float = 1.0


def default_capacity_for(n_points: int, headroom: float = 1.0) -> int:
    """Capacity for ``n_points`` times ``headroom`` (the GS trainer leaves
    room to densify), rounded up to a multiple of 256 as in the JAX
    package."""
    c = int(np.ceil(n_points * headroom / 256.0)) * 256
    return max(c, 256)


def _inverse_activation_np(name: str, x: np.ndarray) -> np.ndarray:
    """INVERSE_ACTIVATIONS on a float32 numpy array, computed in fp32."""
    return INVERSE_ACTIVATIONS[name](
        torch.from_numpy(np.asarray(x, np.float32))).numpy()


def initialize_from_points(cfg: GaussianModelConfig, points: np.ndarray,
                           colors: Optional[np.ndarray] = None,
                           observer_scale: Optional[np.ndarray] = None,
                           capacity: Optional[int] = None, seed: int = 42,
                           device="cpu") -> "GaussianModel":
    """Default initialization from a point cloud (JAX
    models/gaussians.py:initialize_from_points, reference model.py:708):
    random rotations, scales from kNN or observer distances, the default
    density, SH DC from the colors. The numpy draws are the JAX
    package's, in the same order, so both give equal arrays."""
    if cfg.feature_type != "sh":
        raise NotImplementedError("only SH features are ported")
    n = points.shape[0]
    cap = capacity or default_capacity_for(n)
    rng = np.random.default_rng(seed)

    positions = np.zeros((cap, 3), np.float32)
    positions[:n] = points.astype(np.float32)
    rotation = np.zeros((cap, 4), np.float32)
    rotation[:, 0] = 1.0
    rotation[:n] = rng.random((n, 4), dtype=np.float32)
    if observer_scale is None:
        observer_scale = _knn_mean_dist(points)
    observer_scale = np.maximum(observer_scale * cfg.default_scale_factor,
                                1e-7)
    scale = np.full((cap, 3), -10.0, np.float32)
    scale[:n] = _inverse_activation_np(cfg.scale_activation,
                                       observer_scale)[:, None]
    density = np.full((cap, 1), _inverse_activation_np(
        cfg.density_activation, np.float32(cfg.default_density)),
        np.float32)
    if colors is None:
        colors = rng.integers(0, 256, (n, 3)).astype(np.float32) / 255.0
    else:
        colors = colors.astype(np.float32)
        if colors.max() > 1.5:
            colors = colors / 255.0
    albedo = np.zeros((cap, 3), np.float32)
    albedo[:n] = (colors - 0.5) / np.float32(SH_C0)
    spec = np.zeros((cap, 3 * (num_sh_coeffs(cfg.max_sh_degree) - 1)),
                    np.float32)
    arrays = dict(positions=positions, rotation=rotation, scale=scale,
                  density=density, features_albedo=albedo,
                  features_specular=spec)
    return GaussianModel.from_numpy(arrays, n, 0, cfg, device)


def random_initialization(cfg: GaussianModelConfig, n: int,
                          extent: float = 1.0, seed: int = 42,
                          capacity: Optional[int] = None,
                          device="cpu") -> "GaussianModel":
    """Uniform random points in a cube of half-size ``extent``
    (configs/initialization/random.yaml), as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)).astype(np.float32) * 2.0 - 1.0) * extent
    colors = rng.random((n, 3)).astype(np.float32)
    scale0 = np.full((n,), 0.02 * extent, np.float32)
    return initialize_from_points(cfg, pts, colors, observer_scale=scale0,
                                  capacity=capacity, seed=seed,
                                  device=device)


def _knn_mean_dist(points: np.ndarray, k: int = 4) -> np.ndarray:
    """sqrt(mean squared distance to the 3 nearest neighbours)."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k)
    return np.sqrt((d[:, 1:] ** 2).mean(axis=1)).astype(np.float32)


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

    def params(self) -> Dict[str, nn.Parameter]:
        """The raw parameters by name (the optimizer's groups)."""
        return {k: getattr(self, k) for k in PARAM_NAMES}

    @torch.no_grad()
    def set_params(self, **tensors: torch.Tensor):
        """Replace the values of named parameters in place (same shapes),
        keeping the Parameter objects."""
        for k, v in tensors.items():
            getattr(self, k).copy_(v)

    def sh_coeffs(self) -> torch.Tensor:
        """[C, K, 3] SH coefficients, coefficient-major (DC first)."""
        k = num_sh_coeffs(self.config.max_sh_degree)
        rest = self.features_specular.reshape(self.capacity, k - 1, 3)
        return torch.cat([self.features_albedo[:, None, :], rest], dim=1)
