"""Feature typing and dimension bookkeeping (copied from
threedgrut_tpu/models/features.py, the whole file; reference
threedgrut/model/features.py).

In the reference these values become compile-time ``-D`` defines of the
CUDA/Slang build (features.py:167 feature_defines, setup_3dgut.py:46-101);
in the port they pick the particle table's width and the raster kernels'
feature mode.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class FeatureType(enum.Enum):
    SH = "sh"
    NHT = "nht"

    @staticmethod
    def from_string(s: str) -> "FeatureType":
        return FeatureType(s.lower())


class ActivationType(enum.IntEnum):
    NONE = 0
    SIREN = 1
    SINCOS = 2
    RELU = 3

    @staticmethod
    def from_string(s: str) -> "ActivationType":
        return ActivationType[s.upper()]


class InterpolationType(enum.IntEnum):
    BARYCENTRIC = 0
    BEZIER = 1  # not supported (matches reference)


class InterpolationSupport(enum.IntEnum):
    CENTER = 0
    TETRAHEDRA = 1
    CO_TRIANGLES = 2  # not supported (matches reference)


@dataclass
class Features:
    """Computes particle/ray feature dims from config values."""
    feature_type: FeatureType = FeatureType.SH
    sh_degree: int = 3
    nht_dim: int = 48
    activation: ActivationType = ActivationType.SINCOS
    num_frequencies: int = 1
    interpolation: InterpolationType = InterpolationType.BARYCENTRIC
    support: InterpolationSupport = InterpolationSupport.TETRAHEDRA

    @classmethod
    def from_config(cls, conf) -> "Features":
        model = conf.get("model", {})
        nht = model.get("nht_features", {})
        return cls(
            feature_type=FeatureType.from_string(
                model.get("feature_type", "sh")),
            sh_degree=min(model.get("progressive_training", {}).get(
                "max_n_features", 3),
                conf.get("render", {}).get("particle_radiance_sph_degree",
                                           3)),
            nht_dim=nht.get("dim", 48),
            activation=ActivationType.from_string(
                nht.get("activation", {}).get("type", "sincos")),
            num_frequencies=nht.get("activation", {}).get(
                "num_frequencies", 1))

    @property
    def num_interpolation_points(self) -> int:
        return 4 if self.support == InterpolationSupport.TETRAHEDRA else 1

    @property
    def interp_point_feature_dim(self) -> int:
        if self.feature_type == FeatureType.SH:
            return 0
        if self.nht_dim % self.num_interpolation_points:
            raise ValueError(
                f"nht dim {self.nht_dim} not divisible by "
                f"{self.num_interpolation_points} interpolation points")
        return self.nht_dim // self.num_interpolation_points

    @property
    def particle_feature_dim(self) -> int:
        """Per-particle stored feature width (features.py:133)."""
        if self.feature_type == FeatureType.SH:
            return 3 * (self.sh_degree + 1) ** 2
        return self.nht_dim

    @property
    def ray_feature_dim(self) -> int:
        """Integrated per-ray feature width (features.py:154)."""
        if self.feature_type == FeatureType.SH:
            return 3
        base = self.interp_point_feature_dim
        if self.activation == ActivationType.SINCOS:
            return base * self.num_frequencies * 2
        if self.activation in (ActivationType.SIREN, ActivationType.NONE,
                               ActivationType.RELU):
            return base * max(self.num_frequencies, 1)
        raise ValueError(self.activation)
