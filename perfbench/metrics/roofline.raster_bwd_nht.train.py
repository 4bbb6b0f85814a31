"""Kernels C and D's share of their roofline in the traced NHT training
steps: the bound of the backward work the profiled views need
(``counts/nht.py``) over the device time of C's NHT kernel and of D's
64-wide fold with its inversion of the tile sort (``csrc/fold.cu``), %.
Moves ``train_steps_per_s``."""

from perfbench.counts import nht
from perfbench.harness import roofline

KERNELS = ("raster_bwd_nht", "fold_kernel<64", "segment_cols_kernel<64",
           "invert_kernel")


def read(records):
    return roofline(records, KERNELS, nht.raster_bwd)
