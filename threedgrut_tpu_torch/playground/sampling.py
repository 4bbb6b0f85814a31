"""Anti-aliasing, SPP and depth-of-field sampling for the playground
(port of threedgrut_tpu/playground/sampling.py).

Same semantics as the JAX module: the reference playground's SPP modes
(none, independent_random, msaa, low_discrepancy_seq) with progressive
accumulation, the DirectX MSAA patterns, Burley's shuffled and scrambled
Sobol sequence, the PCG3D hash and Shirley's concentric-disc aperture.

The hashes are uint32 arithmetic with wrap-around. PyTorch's uint32
supports few operations, so the bits ride int64 tensors masked to 32
bits; a product of two 32-bit values is formed from 16-bit halves so no
intermediate leaves int64 (``_mul32``). The outputs equal JAX's bit for
bit. Random draws (the jitter of ``independent_random`` and ``msaa``,
the aperture seeds) take an explicit ``torch.Generator``, so their values
differ from JAX's ``jax.random`` draws.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF


def _u32(x, device=None) -> torch.Tensor:
    """uint32 values as an int64 tensor in [0, 2^32)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 of 32-bit values, exact in int64."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    cross = ((a_hi * b_lo + a_lo * b_hi) & 0xFFFF) << 16
    return (a_lo * b_lo + cross) & _MASK


def reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    x = x & _MASK
    x = ((x & 0xAAAAAAAA) >> 1) | ((x & 0x55555555) << 1)
    x = ((x & 0xCCCCCCCC) >> 2) | ((x & 0x33333333) << 2)
    x = ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _MASK


def laine_karras_permutation(x: torch.Tensor, seed: torch.Tensor
                             ) -> torch.Tensor:
    """Laine-Karras 2011 hash-based Owen-scramble pass (constants from
    Burley 2019, jcgt.org/published/0009/04/01)."""
    x = (x + seed) & _MASK
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def owen_scramble(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Nested uniform scramble in base 2: bit-reverse, hash, reverse."""
    return reverse_bits32(laine_karras_permutation(reverse_bits32(x), seed))


def _sobol_directions() -> Tuple[np.ndarray, np.ndarray]:
    """Direction vectors of Sobol dims 0 (van der Corput) and 1 (the
    primitive polynomial x + 1: v_i = v_{i-1} ^ (v_{i-1} >> 1))."""
    v0 = np.array([1 << (31 - i) for i in range(32)], np.int64)
    v1 = np.zeros(32, np.int64)
    v1[0] = 1 << 31
    for i in range(1, 32):
        v1[i] = v1[i - 1] ^ (v1[i - 1] >> 1)
    return v0, v1


_V0, _V1 = _sobol_directions()


def sobol2d(index: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first two Sobol dimensions at ``index`` (32-bit values)."""
    index = index & _MASK
    x0 = torch.zeros_like(index)
    x1 = torch.zeros_like(index)
    for bit in range(32):
        mask = (index >> bit) & 1
        x0 = x0 ^ (mask * int(_V0[bit]))
        x1 = x1 ^ (mask * int(_V1[bit]))
    return x0, x1


def _hash_combine(seed: torch.Tensor, v: int) -> torch.Tensor:
    return (seed ^ ((v + (seed << 6) + (seed >> 2)) & _MASK)) & _MASK


def shuffled_scrambled_sobol2d(index, seed):
    """Burley 2019: Owen-shuffle the index, Owen-scramble each dim."""
    seed = _u32(seed)
    index = owen_scramble(_u32(index, seed.device), seed)
    x0, x1 = sobol2d(index)
    return (owen_scramble(x0, _hash_combine(seed, 0)),
            owen_scramble(x1, _hash_combine(seed, 1)))


def ld_random_val_2d(index, seed):
    """Low-discrepancy 2D sample in [0, 1)^2."""
    s = np.float32(1.0 / (1 << 32))
    x0, x1 = shuffled_scrambled_sobol2d(index, seed)
    return x0.to(torch.float32) * s, x1.to(torch.float32) * s


def pcg3d(v: torch.Tensor) -> torch.Tensor:
    """PCG3D hash (Jarzynski & Olano 2020): [..., 3] 32-bit values ->
    [..., 3] 32-bit values (int64); the playground's per-ray RNG."""
    v = (_mul32(v & _MASK, 1664525) + 1013904223) & _MASK
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = (x + _mul32(y, z)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + _mul32(y, z)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    return torch.stack([x, y, z], dim=-1)


def pcg3d_float(v: torch.Tensor) -> torch.Tensor:
    return pcg3d(v).to(torch.float32) * np.float32(1.0 / (1 << 32))


# DirectX MSAA subpixel sample positions (public, Ray Tracing Gems II),
# the stratified patterns of the reference's StratifiedRayJitter
MSAA_PATTERNS = {
    1: [[0.500, 0.500]],
    2: [[0.250, 0.250], [0.750, 0.750]],
    4: [[0.375, 0.125], [0.875, 0.375], [0.625, 0.875], [0.125, 0.625]],
    8: [[0.5625, 0.6875], [0.4375, 0.3125], [0.8125, 0.4375],
        [0.3125, 0.8125], [0.1875, 0.1875], [0.0625, 0.5625],
        [0.6875, 0.0625], [0.9375, 0.9375]],
    16: [[0.5625, 0.4375], [0.4375, 0.6875], [0.3125, 0.3750],
         [0.7500, 0.5625], [0.1875, 0.6250], [0.6250, 0.1875],
         [0.1875, 0.3125], [0.6875, 0.8125], [0.3750, 0.1250],
         [0.5000, 0.9375], [0.2500, 0.8750], [0.1250, 0.2500],
         [0.0000, 0.5000], [0.9375, 0.7500], [0.8750, 0.0625],
         [0.0625, 0.0000]],
}

# max jitter radius that keeps a perturbed pattern stratified
_MSAA_RELAXATION = {1: 0.5, 2: 0.3535533905932738, 4: 0.2795084971874737,
                    8: 0.13975424859373686, 16: 0.04419417382415922}


class SPP:
    """Samples-per-pixel jitter source with progressive accumulation.

    Modes (utils/spp.py:28): ``none`` | ``independent_random`` |
    ``msaa`` | ``low_discrepancy_seq``. __call__ returns a [H, W, 2]
    jitter in [-0.5, 0.5] and advances the accumulation counter.
    """

    MODES = ("none", "independent_random", "msaa", "low_discrepancy_seq")

    def __init__(self, mode: str = "msaa", spp: int = 4,
                 batch_size: int = 1, seed: int = 0, device="cpu"):
        mode = mode.lower()
        if mode not in self.MODES:
            raise ValueError(f"unknown spp mode {mode!r}")
        if mode == "msaa" and spp not in MSAA_PATTERNS:
            raise ValueError("msaa supports spp in (1, 2, 4, 8, 16)")
        self.mode = mode
        self.spp = spp
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.spp_accumulated_for_frame = 1
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def reset_accumulation(self):
        self.spp_accumulated_for_frame = self.batch_size

    def has_more_to_accumulate(self) -> bool:
        return self.spp_accumulated_for_frame <= self.spp

    def _uniform(self, h, w):
        return torch.rand((h, w, 2), generator=self._gen,
                          device=self.device)

    def __call__(self, img_h: int, img_w: int) -> torch.Tensor:
        i = self.spp_accumulated_for_frame
        dev = self.device
        if self.mode == "none":
            jitter = torch.zeros((img_h, img_w, 2), device=dev)
        elif self.mode == "independent_random":
            jitter = self._uniform(img_h, img_w) - 0.5
        elif self.mode == "msaa":
            base = torch.tensor(MSAA_PATTERNS[self.spp][(i - 1) % self.spp],
                                dtype=torch.float32, device=dev)
            # perturb within the stratum to decorrelate pixels
            noise = (self._uniform(img_h, img_w) - 0.5) * \
                _MSAA_RELAXATION[self.spp]
            jitter = 0.5 - (base + noise)
        else:  # low_discrepancy_seq
            px = torch.arange(img_w, dtype=torch.int64, device=dev)[None, :]
            py = torch.arange(img_h, dtype=torch.int64, device=dev)[:, None]
            seed = (_mul32(px, 19349663) + _mul32(py, 96925573)) & _MASK
            seed = seed.expand(img_h, img_w)
            x0, x1 = ld_random_val_2d(torch.full_like(seed, i), seed)
            jitter = torch.stack([x0, x1], dim=-1) - 0.5
        self.spp_accumulated_for_frame += 1
        return jitter


def concentric_disc(u: torch.Tensor, v: torch.Tensor):
    """Shirley's square-to-concentric-disc map, [0, 1)^2 -> unit disc
    (depth_of_field.py:56 pixel_to_disc_shirley)."""
    ox = 2.0 * u - 1.0
    oy = 2.0 * v - 1.0
    degenerate = (torch.abs(ox) < 1e-12) & (torch.abs(oy) < 1e-12)
    use_x = torch.abs(ox) > torch.abs(oy)
    one = torch.ones_like(ox)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x, (math.pi / 4.0) * (oy / torch.where(use_x, ox, one)),
        (math.pi / 2.0) - (math.pi / 4.0) * (ox / torch.where(use_x, one,
                                                              oy)))
    zero = torch.zeros_like(ox)
    return (torch.where(degenerate, zero, r * torch.cos(theta)),
            torch.where(degenerate, zero, r * torch.sin(theta)))


class DepthOfField:
    """Thin-lens aperture sampler with progressive accumulation
    (depth_of_field.py:27): moves ray origins on a concentric-disc
    aperture in the camera's image plane and refocuses the directions at
    the focus plane ``focus_z``."""

    def __init__(self, spp: int = 64, aperture_size: float = 0.1,
                 focus_z: float = 1.0, seed: int = 0, device="cpu"):
        self.spp = spp
        self.aperture_size = aperture_size
        self.focus_z = focus_z
        self.spp_accumulated_for_frame = 1
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            seed ^ 0x5EED)

    def reset_accumulation(self):
        self.spp_accumulated_for_frame = 1

    def has_more_to_accumulate(self) -> bool:
        return self.spp_accumulated_for_frame <= self.spp

    def __call__(self, cam_right: torch.Tensor, cam_up: torch.Tensor,
                 ray_o: torch.Tensor, ray_d: torch.Tensor):
        """Aperture jitter of flat ray batches [R, 3]."""
        r = ray_o.shape[0]
        i = self.spp_accumulated_for_frame
        dev = ray_o.device
        # one aperture sample per ray and accumulation index, decorrelated
        # per ray by PCG3D
        idx = torch.arange(r, dtype=torch.int64, device=dev)
        salt = torch.randint(0, 1 << 30, (r,), generator=self._gen,
                             device=self.device).to(dev)
        h = pcg3d_float(torch.stack([idx, torch.full_like(idx, i), salt],
                                    dim=-1))
        dx, dy = concentric_disc(h[:, 0], h[:, 1])
        offset = (dx[:, None] * cam_right[None]
                  + dy[:, None] * cam_up[None]) * self.aperture_size
        focus_p = ray_o + ray_d * self.focus_z
        new_o = ray_o + offset
        new_d = focus_p - new_o
        new_d = new_d / torch.clamp(torch.linalg.norm(new_d, dim=-1,
                                                      keepdim=True),
                                    min=1e-12)
        self.spp_accumulated_for_frame += 1
        return new_o, new_d
