"""95th percentile of the window's requests' latency, from the host's
clock when a view is asked for to its frame complete on the card, ms.
The closed loop runs the renderer at its capacity, so this tail swings
with the host's speed; it moves ``serve_frames_per_s``."""

from perfbench.harness import percentile


def read(records):
    t = records.get("unit_s")
    return percentile(t, 95) * 1e3 if t else None
