"""The whole training step's share of the card's fp32 peak: the fp32
operations the profiled steps' views need (``counts/raster.py``), over
the untraced window's mean step time times 67 TFLOP/s, %. Moves
``train_steps_per_s``."""

from perfbench.counts import raster
from perfbench.harness import mfu


def read(records):
    return mfu(records, raster.train_step_flops)
