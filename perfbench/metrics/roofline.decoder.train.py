"""The NHT decoder's share of its roofline in the traced training steps:
the bound of its forward, backward and EMA update on the profiled views'
pixels (``counts/nht.py``: products at the tensor-core peak of their
precision) over the device time of the program's ``grut.decoder`` span
and its children, the linked backward included
(``perfbench/spans.py``), %. Nothing where the program has no such span.
Moves ``train_steps_per_s``."""

from perfbench import spans
from perfbench.counts import nht


def read(records):
    c = records.get("counts")
    ms = spans.device_ms(records.get("spans", {}), ("grut.decoder",))
    if not c or not ms:
        return None
    bound_ms = 1e3 * sum(nht.decoder(x)["bound_s"] for x in c) / len(c)
    return 100.0 * bound_ms / ms
