"""Frozen operation and byte counts of the work a view needs, whatever
implements it.

The rasterizer's work is counted on the (particle, pixel) evaluations
that contribute to a pixel: alpha of at least 1/255 before the pixel's
kill, as the reference (``reference/render.py``) counts them on the
views a traced run profiled. Evaluations a cull could have skipped are
not counted, so a better cull cannot read above its bound.

Bytes count each input read once and each output written once. Flops
are fp32 operations, a fused multiply-add two. A bound is the larger of
flops over the fp32 peak off the tensor cores and bytes over the HBM
bandwidth (one NVIDIA H100 SXM, NVIDIA's data sheet).
"""

from __future__ import annotations

from typing import Dict

FP32_PEAK = 67e12        # FLOP/s, fp32 without the tensor cores
HBM_BYTES_PER_S = 3.35e12

# The fewest fp32 operations one contributing (particle, pixel)
# evaluation needs. Forward: the ray's squared canonical distance as a
# ratio of two quadratic forms in the pixel's camera-plane coordinates
# (2 x 5 multiply-adds and a division: 21), the response (exp and the
# opacity product: 2), the alpha clamp and two accept tests (3), the hit
# distance as a linear over the same quadratic (6), and the compositing:
# the weight, the transmittance update and the kill test (4), colour and
# depth accumulation (8), the hit count (1).
FWD_FLOPS_PER_EVAL = 45
# Backward: the suffix sums of colour and transmittance (8), the
# cotangent of alpha (6), through the response and the quadratic forms to
# their 12 coefficients and the opacity (26), accumulation of the
# particle's 16 table entries (16), the colour cotangent (6).
BWD_FLOPS_PER_EVAL = 62
# a particle's table row: the 13 floats of the hit test and 3 of colour
TABLE_ROW_BYTES = 16 * 4
# per pixel, forward: in the ray direction and its scene range (5
# floats); out colour, opacity, depth and hit count (6 words)
PIXEL_IN_FWD_BYTES = 5 * 4
PIXEL_OUT_FWD_BYTES = 6 * 4
# per pixel, backward: in the ray and its range (5), the colour and
# opacity cotangents (4), the forward's colour and final transmittance
# (4)
PIXEL_IN_BWD_BYTES = 13 * 4

# plain per-row and per-pixel work of a step or frame (fp32 operations)
UT_FLOPS_PER_ROW = 250        # 7 sigma points through the pose and the
                              # pinhole, the 2D mean, covariance, conic
SH3_FLOPS_PER_ROW = 135       # view direction, 16 basis values, 48 FMAs
TABLE_FLOPS_PER_ROW = 49      # rotation, M = S^-1 R^T, a = M (o - p)
ROW_BWD_FLOPS = 350           # the SH and table gradients
ADAM_FLOPS_PER_ELEMENT = 12
ROW_ELEMENTS = 3 + 4 + 3 + 1 + 3 + 45
PERTURB_FLOPS_PER_ROW = 100
REGULARIZER_FLOPS_PER_ROW = 16
# SSIM: 5 maps x 3 channels through 2 separable 11-tap passes, then the
# formula on 3 channels
SSIM_FLOPS_PER_PIXEL = 15 * 2 * 11 * 2 + 3 * 30
LOSS_BWD_FACTOR = 2           # the loss's backward against its forward
ISP_FLOPS_PER_PIXEL = 60


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / FP32_PEAK, nbytes / HBM_BYTES_PER_S)


def raster_fwd(c: Dict[str, float]) -> Dict[str, float]:
    """Kernel B's needed work on a view: ``c`` holds ``evals`` (the
    contributing evaluations), ``particles`` (the particles that
    contribute to some pixel) and ``pixels``."""
    flops = c["evals"] * FWD_FLOPS_PER_EVAL
    nbytes = (c["particles"] * TABLE_ROW_BYTES
              + c["pixels"] * (PIXEL_IN_FWD_BYTES + PIXEL_OUT_FWD_BYTES))
    return {"flops": flops, "bytes": nbytes, "bound_s": bound_s(flops,
                                                                nbytes)}


def raster_bwd(c: Dict[str, float]) -> Dict[str, float]:
    """Kernels C and D's needed work: the same evaluations backwards, each
    contributing particle's table row read and its gradient row
    written."""
    flops = c["evals"] * BWD_FLOPS_PER_EVAL
    nbytes = (2 * c["particles"] * TABLE_ROW_BYTES
              + c["pixels"] * PIXEL_IN_BWD_BYTES)
    return {"flops": flops, "bytes": nbytes, "bound_s": bound_s(flops,
                                                                nbytes)}


def serve_frame_flops(c: Dict[str, float]) -> float:
    """A served frame's needed fp32 operations: projection, SH and table
    of every row, the raster forward, the background."""
    rows = c["rows"]
    return (rows * (UT_FLOPS_PER_ROW + SH3_FLOPS_PER_ROW
                    + TABLE_FLOPS_PER_ROW)
            + raster_fwd(c)["flops"] + c["pixels"] * 6)


def train_step_flops(c: Dict[str, float]) -> float:
    """A training step's needed fp32 operations: the frame's forward, the
    loss (L1, SSIM, the ISP where ``isp``) and its backward, the raster
    backward, the rows' backward, Adam over every element, the
    regularizers and MCMC's perturbation."""
    rows, px = c["rows"], c["pixels"]
    per_px = 6 + 6 + SSIM_FLOPS_PER_PIXEL
    if c.get("isp"):
        per_px += ISP_FLOPS_PER_PIXEL
    return (serve_frame_flops(c) + px * per_px * (1 + LOSS_BWD_FACTOR)
            + raster_bwd(c)["flops"]
            + rows * (ROW_BWD_FLOPS + ADAM_FLOPS_PER_ELEMENT * ROW_ELEMENTS
                      + PERTURB_FLOPS_PER_ROW + REGULARIZER_FLOPS_PER_ROW))
