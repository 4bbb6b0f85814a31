"""Kernel B's share of its roofline in the traced training steps: the
bound of the work the profiled views need (``counts/raster.py``) over
the device time of B's kernels, %. Moves ``train_steps_per_s``."""

from perfbench.counts import raster
from perfbench.harness import roofline


def read(records):
    return roofline(records, ("raster_fwd",), raster.raster_fwd)
