"""Background models (port of threedgrut_tpu/models/background.py):
``pred = features + bg * (1 - opacity)``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class BackgroundConfig:
    name: str = "background-color"
    color: str = "black"


def background_color(cfg: BackgroundConfig,
                     generator: Optional[torch.Generator] = None,
                     train: bool = False,
                     device="cpu") -> Optional[torch.Tensor]:
    """Per-call background RGB [3], or None for skip-background. A
    ``random`` color is drawn from ``generator`` in a training call and is
    mid-grey otherwise."""
    if cfg.name == "skip-background":
        return None
    if cfg.color == "random" and train and generator is not None:
        return torch.rand((3,), generator=generator,
                          device=generator.device).to(device)
    values = {"black": 0.0, "white": 1.0, "random": 0.5}
    if cfg.color not in values:
        raise ValueError(f"unknown background color {cfg.color}")
    return torch.full((3,), values[cfg.color], dtype=torch.float32,
                      device=device)


def apply_background(pred_features: torch.Tensor, pred_opacity: torch.Tensor,
                     bg_rgb: Optional[torch.Tensor]) -> torch.Tensor:
    if bg_rgb is None:
        return pred_features
    return pred_features + bg_rgb * (1.0 - pred_opacity)
