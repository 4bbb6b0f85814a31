"""The whole served frame's share of the card's fp32 peak: the fp32
operations the profiled frames' views need (``counts/raster.py``), over
the untraced window's mean frame time times 67 TFLOP/s, %. Moves
``serve_frames_per_s``."""

from perfbench.counts import raster
from perfbench.harness import mfu


def read(records):
    return mfu(records, raster.serve_frame_flops)
