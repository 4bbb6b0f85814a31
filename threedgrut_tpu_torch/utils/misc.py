"""The jet map, the sRGB transfer and the summary writer of
threedgrut_tpu/utils/misc.py (:11-32 on tensors; the writer, :43-91, a
copy that takes tensors too).

The writer logs through tensorboardX where it imports (and wandb where
asked for and importable) and does nothing otherwise: nothing is
installed for it. tensorboardX is absent on the H100's machine
(``chip_smoke.py`` phase 51 prints it), so there it does nothing.
"""

from __future__ import annotations

import numpy as np
import torch


def jet_map(values: torch.Tensor, max_val: float) -> torch.Tensor:
    """1-channel map [..., 1] -> jet-colormapped RGB [..., 3]
    (threedgrut/utils/misc.py:138)."""
    vs = torch.clamp(values / max_val, 0.0, 1.0)
    r = (torch.clamp(4.0 * (vs - 0.375), 0, 1)
         * torch.clamp(-4.0 * (vs - 1.125), 0, 1))
    g = (torch.clamp(4.0 * (vs - 0.125), 0, 1)
         * torch.clamp(-4.0 * (vs - 0.875), 0, 1))
    b = (torch.clamp(4.0 * vs + 0.5, 0, 1)
         * torch.clamp(-4.0 * (vs - 0.625), 0, 1))
    return torch.cat([r, g, b], dim=-1)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 transfer (utils/post_processing_linear_to_srgb.py)."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=1e-8), 1 / 2.4)
                       - 0.055)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x + 0.055) / 1.055, 2.4))


def create_summary_writer(out_dir: str, use_wandb: bool = False,
                          wandb_project: str = "threedgrut_tpu"):
    """TensorBoard(+wandb) writer factory (utils/misc.py:151)."""
    writers = []
    try:
        from tensorboardX import SummaryWriter
        writers.append(SummaryWriter(out_dir))
    except ImportError:
        pass
    if use_wandb:
        try:
            import wandb
            wandb.init(project=wandb_project, dir=out_dir)
            writers.append(_WandbWriter(wandb))
        except ImportError:
            pass
    return MultiWriter(writers)


def _host(img) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


class _WandbWriter:
    def __init__(self, wandb):
        self._wandb = wandb

    def add_scalar(self, tag, value, step):
        self._wandb.log({tag: value}, step=step)

    def add_image(self, tag, img, step, dataformats="HWC"):
        self._wandb.log({tag: self._wandb.Image(_host(img))}, step=step)

    def flush(self):
        pass


class MultiWriter:
    """Fan-out scalar/image writer; silently no-ops with no backends."""

    def __init__(self, writers):
        self.writers = writers

    def add_scalar(self, tag, value, step):
        for w in self.writers:
            w.add_scalar(tag, float(value), step)

    def add_image(self, tag, img, step):
        for w in self.writers:
            w.add_image(tag, _host(img), step, dataformats="HWC")

    def flush(self):
        for w in self.writers:
            w.flush()
