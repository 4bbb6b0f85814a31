"""Frozen operation and byte counts of the work an NHT training step's
view needs, whatever implements it (laid out as ``counts/raster.py``,
whose peaks, hit test and per-row work they share).

An NHT particle carries 4 x 12 control features (its table row: 13
floats of the hit test, 48 features, 3 of padding: 256 bytes); a
contributing (particle, pixel) evaluation blends them at the canonical
hit point and composites 24 ray features. The decoder (33 -> 128 -> 128
-> 128 -> 3, bias-free) runs on every pixel on the tensor cores, counted
at the peak of the precision of its products.
"""

from __future__ import annotations

from typing import Dict

from .raster import (ADAM_FLOPS_PER_ELEMENT, BWD_FLOPS_PER_EVAL,
                     FWD_FLOPS_PER_EVAL, LOSS_BWD_FACTOR,
                     PERTURB_FLOPS_PER_ROW, REGULARIZER_FLOPS_PER_ROW,
                     ROW_BWD_FLOPS, SSIM_FLOPS_PER_PIXEL, TABLE_FLOPS_PER_ROW,
                     UT_FLOPS_PER_ROW, bound_s)

# NVIDIA's H100 SXM data sheet, dense: fp16 on the tensor cores (the
# decoder's products take fp16 operands)
DECODER_PEAK = 989e12

FEATURES = 48            # 4 vertices x 12
RAY_FEATURES = 24        # (sin, cos) of the 12 blends
# Forward, per contributing evaluation: raster.py's hit test, response,
# accept tests, hit distance, compositing, depth and hit count (45, less
# its colour's 6), then the canonical hit point a + b t (7), its 4
# barycentric weights (3 x 3 multiply-adds and the remainder: 21), the
# 12 blends of 4 vertex features (4 multiply-adds each: 96), 12 sines and
# 12 cosines (24) and the 24 features' accumulation (48).
FWD_FLOPS_PER_EVAL_NHT = FWD_FLOPS_PER_EVAL - 6 + 7 + 21 + 96 + 24 + 48
# Backward: raster.py's (62, less the colour's suffix sums 6, cotangent
# 6 and its 16 table entries 16), the suffix sums of 24 features (48),
# the alpha cotangent's 24 products (48), the hit point, weights, blends
# and sines again (148), each blend's cotangent from its sine and cosine
# (36), the 48 feature cotangents (96), the 4 weights' cotangents (96),
# through the weights and the hit point to a and b (30), and the 61
# table entries accumulated (61).
BWD_FLOPS_PER_EVAL_NHT = (BWD_FLOPS_PER_EVAL - 28 + 48 + 48 + 148 + 36 + 96
                          + 96 + 30 + 61)
TABLE_ROW_BYTES_NHT = 64 * 4
# per pixel, forward: in the ray direction and its scene range (5
# floats); out 24 features, opacity, depth and hit count (27 words)
PIXEL_IN_FWD_BYTES = 5 * 4
PIXEL_OUT_FWD_BYTES_NHT = 27 * 4
# per pixel, backward: in the ray and its range (5), the features' and
# the opacity's cotangents (25), the forward's features and final
# transmittance (25)
PIXEL_IN_BWD_BYTES_NHT = 55 * 4

# the decoder's products per pixel, forward: 2 x (33 x 128 + 2 x 128 x
# 128 + 128 x 3) = 74,752; backward twice that (the weights' and the
# inputs' cotangents)
DECODER_IN = RAY_FEATURES + 9
DECODER_FWD_FLOPS_PER_PIXEL = 2 * (DECODER_IN * 128 + 2 * 128 * 128
                                   + 128 * 3)
DECODER_BWD_FLOPS_PER_PIXEL = 2 * DECODER_FWD_FLOPS_PER_PIXEL
# the rest of the decoder per pixel: the direction's encoding (3 + 9 x 2)
# and the sigmoid with its cotangent (3 x 4), fp32
DECODER_FP32_FLOPS_PER_PIXEL = 21 + 12
ROW_ELEMENTS_NHT = 3 + 4 + 3 + 1 + FEATURES


def raster_fwd(c: Dict[str, float]) -> Dict[str, float]:
    """Kernel B's NHT mode on a view (``c`` as in ``counts/raster.py``)."""
    flops = c["evals"] * FWD_FLOPS_PER_EVAL_NHT
    nbytes = (c["particles"] * TABLE_ROW_BYTES_NHT
              + c["pixels"] * (PIXEL_IN_FWD_BYTES + PIXEL_OUT_FWD_BYTES_NHT))
    return {"flops": flops, "bytes": nbytes, "bound_s": bound_s(flops,
                                                                nbytes)}


def raster_bwd(c: Dict[str, float]) -> Dict[str, float]:
    """Kernels C and D in the NHT mode: the same evaluations backwards,
    each contributing particle's row read and its gradient row written."""
    flops = c["evals"] * BWD_FLOPS_PER_EVAL_NHT
    nbytes = (2 * c["particles"] * TABLE_ROW_BYTES_NHT
              + c["pixels"] * PIXEL_IN_BWD_BYTES_NHT)
    return {"flops": flops, "bytes": nbytes, "bound_s": bound_s(flops,
                                                                nbytes)}


def decoder(c: Dict[str, float]) -> Dict[str, float]:
    """The decoder's forward and backward on every pixel, and its EMA
    update: tensor-core products at ``DECODER_PEAK``, the rest fp32; each
    pixel's 33 inputs read and 3 outputs written, the cotangents alike."""
    px = c["pixels"]
    mma = px * (DECODER_FWD_FLOPS_PER_PIXEL + DECODER_BWD_FLOPS_PER_PIXEL)
    flops = px * DECODER_FP32_FLOPS_PER_PIXEL
    nbytes = px * 2 * (DECODER_IN + 3) * 4
    return {"mma_flops": mma, "flops": flops, "bytes": nbytes,
            "bound_s": max(mma / DECODER_PEAK + bound_s(flops, 0.0),
                           bound_s(0.0, nbytes))}


def train_step_flops(c: Dict[str, float]) -> float:
    """A training step's needed fp32 operations off the decoder's
    products: the projection and table of every row, the raster forward
    and backward, the loss and its backward, the decoder's fp32 part, the
    rows' backward, Adam over every element, the regularizers and MCMC's
    perturbation (``counts/raster.py:train_step_flops`` with NHT's
    raster and rows)."""
    rows, px = c["rows"], c["pixels"]
    per_px = 6 + 6 + SSIM_FLOPS_PER_PIXEL
    return (rows * (UT_FLOPS_PER_ROW + TABLE_FLOPS_PER_ROW)
            + raster_fwd(c)["flops"] + raster_bwd(c)["flops"]
            + px * per_px * (1 + LOSS_BWD_FACTOR)
            + px * DECODER_FP32_FLOPS_PER_PIXEL
            + rows * (ROW_BWD_FLOPS + ADAM_FLOPS_PER_ELEMENT
                      * ROW_ELEMENTS_NHT + PERTURB_FLOPS_PER_ROW
                      + REGULARIZER_FLOPS_PER_ROW))


def train_step_bound_s(c: Dict[str, float]) -> float:
    """The step's needed work as time: its fp32 operations at the fp32
    peak and the decoder's products at ``DECODER_PEAK``."""
    return (bound_s(train_step_flops(c), 0.0)
            + decoder(c)["mma_flops"] / DECODER_PEAK)
