"""Kernels C and D's share of their roofline in the traced training
steps: the bound of the backward work the profiled views need
(``counts/raster.py``) over the device time of C's kernels and of D's
(``csrc/fold.cu``: the fold and its inversion of the tile sort), %.
Moves ``train_steps_per_s``."""

from perfbench.counts import raster
from perfbench.harness import roofline

KERNELS = ("raster_bwd", "fold_kernel", "segment_cols_kernel",
           "invert_kernel")


def read(records):
    return roofline(records, KERNELS, raster.raster_bwd)
