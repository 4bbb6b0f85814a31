"""Weights between the JAX package and the port.

``model_from_state`` turns a ``threedgrut_tpu`` GaussianState (or any
object with the same ``params`` / ``n_active`` / ``n_active_features`` /
``config`` fields) into a ``GaussianModel``, so both packages compute on
the same weights. ``decoder_from_jax`` does the same for the NHT
decoder (its weights and EMA shadow), and ``decoder_to_flax`` gives the
port's decoder back as the JAX decoder's flax pytrees.
``controller_from_flax`` and ``controller_to_flax`` carry the PPISP
controller's weights across, through the reference's export layout. Each
array goes through ``numpy.asarray``; nothing of JAX is imported.

A flax Dense kernel is [in, out]; the port's ``Linear.weight`` is its
transpose [out, in].
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .models.gaussians import GaussianModel, GaussianModelConfig, param_names
from .models import nht_decoder
from .models.nht_decoder import FeatureDecoder
from .models.ppisp import (CONTROLLER_LAYERS, PPISPControllerCNN,
                           flatten_controller_weights,
                           unflatten_controller_weights)


def model_from_state(state, device="cpu") -> GaussianModel:
    cfg = state.config
    config = GaussianModelConfig(
        density_activation=cfg.density_activation,
        scale_activation=cfg.scale_activation,
        feature_type=cfg.feature_type,
        max_sh_degree=cfg.max_sh_degree,
        nht_feature_dim=getattr(cfg, "nht_feature_dim", 48))
    arrays = {k: np.asarray(getattr(state.params, k))
              for k in param_names(cfg.feature_type)}
    return GaussianModel.from_numpy(
        arrays, int(np.asarray(state.n_active)),
        int(np.asarray(state.n_active_features)), config, device)


def save_checkpoint(model: GaussianModel, path: str):
    """Write the model as a trainer ``.npz`` checkpoint (``params/<name>``,
    ``n_active``, ``n_active_features``), readable by both packages."""
    arrays = {f"params/{k}": v.detach().cpu().numpy()
              for k, v in model.params().items()}
    np.savez(path, n_active=np.int32(model.n_active),
             n_active_features=np.int32(model.n_active_features), **arrays)


def flax_layer_names(n_layers: int) -> List[str]:
    """The flax module names of the decoder's layers, input layer first."""
    return [f"Dense_{i}" for i in range(n_layers)]


def flax_tree(weights) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """Port weights [out, in] -> the flax pytree {"params": {"Dense_i":
    {"kernel": [in, out]}}}."""
    return {"params": {
        name: {"kernel": w.detach().cpu().numpy().T.copy()}
        for name, w in zip(flax_layer_names(len(weights)), weights)}}


def weights_of_flax_tree(tree, device="cpu") -> List[torch.Tensor]:
    """The inverse of ``flax_tree``: [out, in] f32 tensors."""
    layers = tree["params"]
    return [torch.tensor(np.asarray(layers[name]["kernel"], np.float32).T,
                         device=device)
            for name in flax_layer_names(len(layers))]


def decoder_from_jax(dec, device="cpu") -> FeatureDecoder:
    """The port's decoder with the weights and EMA shadow of a JAX
    ``FeatureDecoder`` (threedgrut_tpu/models/nht_decoder.py), which must
    have the published sizes the port's decoder is fixed to."""
    weights = weights_of_flax_tree(dec.params, device)
    sizes = (weights[0].shape[0], len(weights) - 1, dec.dir_encoding_degree,
             dec.sh_scale, dec.module.output_activation, dec.ema_decay,
             dec.ema_start_step)
    fixed = (nht_decoder.HIDDEN_DIM, nht_decoder.NUM_LAYERS,
             nht_decoder.DIR_ENCODING_DEGREE, nht_decoder.SH_SCALE,
             "Sigmoid", nht_decoder.EMA_DECAY, 0)
    if sizes != fixed:
        raise ValueError(f"JAX decoder (hidden, layers, SH degree, SH scale, "
                         f"output, EMA decay, EMA start) {sizes}: the port "
                         f"decodes with {fixed}")
    out = FeatureDecoder(dec.ray_feature_dim, device=device)
    with torch.no_grad():
        for w, src in zip(out.weights(), weights):
            w.copy_(src)
        for s, src in zip(out.ema_shadow,
                          weights_of_flax_tree(dec.ema_shadow, device)):
            s.copy_(src)
    return out


def decoder_to_flax(decoder: FeatureDecoder):
    """(params, ema_shadow) flax pytrees of numpy arrays for a JAX
    ``FeatureDecoder``."""
    return flax_tree(decoder.weights()), flax_tree(decoder.ema_shadow)


def decoder_state_dict(decoder: FeatureDecoder) -> Dict[str, np.ndarray]:
    """The decoder's arrays under the keys of the JAX
    ``FeatureDecoder.state_dict`` (nht_decoder.py:96-104): the flax key
    paths, and the EMA shadow's under an ``ema:`` prefix."""
    params, ema = decoder_to_flax(decoder)
    out = {}
    for prefix, tree in (("", params), ("ema:", ema)):
        for name, leaf in tree["params"].items():
            out[f"{prefix}['params']/['{name}']/['kernel']"] = leaf["kernel"]
    return out


def controller_from_flax(tree, device="cpu") -> PPISPControllerCNN:
    """The port's PPISP controller with the weights of a JAX controller's
    flax pytree ({"params": {name: {"kernel" [in, out], "bias"}}}), read
    in the reference's export layout."""
    layers = tree["params"]
    flat = np.concatenate([
        np.concatenate([np.asarray(layers[name]["kernel"], np.float32)
                        .T.reshape(-1),
                        np.asarray(layers[name]["bias"], np.float32)
                        .reshape(-1)])
        for name, _, _ in CONTROLLER_LAYERS])
    return unflatten_controller_weights(
        PPISPControllerCNN(device=device), flat)


def controller_to_flax(ctrl) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """The inverse of ``controller_from_flax``: the flax pytree of numpy
    arrays of a port controller, through the export layout."""
    flat = flatten_controller_weights(ctrl)
    out, at = {}, 0
    for name, fan_in, fan_out in CONTROLLER_LAYERS:
        w = flat[at:at + fan_out * fan_in].reshape(fan_out, fan_in)
        at += fan_out * fan_in
        out[name] = {"kernel": w.T.copy(), "bias": flat[at:at + fan_out]
                     .copy()}
        at += fan_out
    return {"params": out}
