"""The whole NHT training step's share of the card's peaks: the time the
work the profiled steps' views need takes at the peaks
(``counts/nht.py``: fp32 operations at 67 TFLOP/s, the decoder's
products at the tensor-core peak of their precision) over the untraced
window's mean step time, %. Moves ``train_steps_per_s``."""

from perfbench.counts import nht


def read(records):
    c = records.get("counts")
    if not c:
        return None
    bound = sum(nht.train_step_bound_s(x) for x in c) / len(c)
    return 100.0 * bound / records["unit_mean_s"]
