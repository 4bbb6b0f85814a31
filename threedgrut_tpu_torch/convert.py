"""Weights from the JAX package into the port.

``model_from_state`` turns a ``threedgrut_tpu`` GaussianState (or any
object with the same ``params`` / ``n_active`` / ``n_active_features`` /
``config`` fields) into a ``GaussianModel``, so both packages compute on
the same weights. It reads each array through ``numpy.asarray`` and
imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np

from .models.gaussians import PARAM_NAMES, GaussianModel, GaussianModelConfig


def model_from_state(state, device="cpu") -> GaussianModel:
    cfg = state.config
    config = GaussianModelConfig(
        density_activation=cfg.density_activation,
        scale_activation=cfg.scale_activation,
        feature_type=cfg.feature_type,
        max_sh_degree=cfg.max_sh_degree)
    arrays = {k: np.asarray(getattr(state.params, k)) for k in PARAM_NAMES}
    return GaussianModel.from_numpy(
        arrays, int(np.asarray(state.n_active)),
        int(np.asarray(state.n_active_features)), config, device)


def save_checkpoint(model: GaussianModel, path: str):
    """Write the model as a trainer ``.npz`` checkpoint (``params/<name>``,
    ``n_active``, ``n_active_features``), readable by both packages."""
    arrays = {f"params/{k}": getattr(model, k).detach().cpu().numpy()
              for k in PARAM_NAMES}
    np.savez(path, n_active=np.int32(model.n_active),
             n_active_features=np.int32(model.n_active_features), **arrays)
