"""Kernel B's NHT mode's share of its roofline in the traced training
steps: the bound of the work the profiled views need
(``counts/nht.py``) over the device time of the kernels named
``raster_fwd_nht``, %. Moves ``train_steps_per_s``."""

from perfbench.counts import nht
from perfbench.harness import roofline


def read(records):
    return roofline(records, ("raster_fwd_nht",), nht.raster_fwd)
