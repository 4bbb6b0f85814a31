"""Host reads a traced served frame: the program's count of its
``host_read`` calls (``threedgrut_tpu_torch/utils/timer.py``; each waits
for the card) over its ``grut.frame`` spans in the profiled segment,
whose torch.profiler capture turns the spans and the counter on (the
pad frame included). Moves ``serve_frames_per_s``."""

from perfbench.spans import host_reads_per_unit


def read(records):
    return host_reads_per_unit("grut.frame")
