"""95th percentile of the host-clock time of the window's training steps
(each ``train_iteration`` call ends in its own host synchronisation), ms.
Moves ``train_steps_per_s``."""

from perfbench.harness import percentile


def read(records):
    t = records.get("unit_s")
    return percentile(t, 95) * 1e3 if t else None
