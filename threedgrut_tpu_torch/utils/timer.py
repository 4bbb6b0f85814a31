"""Device timing utilities (port of threedgrut_tpu/utils/timer.py;
threedgrut/utils/timer.py equivalents).

``DeviceTimer`` times device work with CUDA events on the card, where
JAX blocks on the result around a host clock; on the CPU it reads the
host clock. ``ScopedTimer`` keeps the reference's global
``timing_options`` toggle, and names its scope for torch.profiler;
``trace_annotation`` is an nvtx range and a profiler scope;
``start_profiler_trace`` captures a torch.profiler trace for
TensorBoard.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class TimingOptions:
    """Global toggle (threedgrut/utils/timer.py:30-168)."""
    active: bool = False
    print_enabled: bool = False


timing_options = TimingOptions()


class DeviceTimer:
    """CudaTimer equivalent (timer.py:171-196): accumulates start/end
    pairs; ``timing()`` returns their mean in ms. On ``device`` (the card
    by default; a CPU device takes the host clock) with CUDA events, and
    ``end`` waits for the end event."""

    def __init__(self, enabled: bool = True, device=None):
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device=\"cpu\" for the "
                               "host clock")
        self.device = torch.device(device or "cuda")
        self.enabled = enabled
        self._cuda = self.device.type == "cuda"
        self._start = None
        self._total_ms = 0.0
        self._count = 0

    def start(self):
        if not self.enabled:
            return
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        else:
            self._start = time.perf_counter()

    def end(self, result=None):
        if not self.enabled or self._start is None:
            return result
        if self._cuda:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record(torch.cuda.current_stream(self.device))
            stop.synchronize()
            self._total_ms += self._start.elapsed_time(stop)
        else:
            self._total_ms += (time.perf_counter() - self._start) * 1000.0
        self._count += 1
        self._start = None
        return result

    def timing(self) -> float:
        return self._total_ms / max(self._count, 1)

    def reset(self):
        self._total_ms = 0.0
        self._count = 0


@contextmanager
def ScopedTimer(name: str, results: Optional[Dict[str, float]] = None):
    """Scoped wall timer honoring the global timing_options toggle; the
    scope is named in torch.profiler traces."""
    if not timing_options.active:
        yield
        return
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = (time.perf_counter() - t0) * 1000.0
    if results is not None:
        results[name] = results.get(name, 0.0) + dt
    if timing_options.print_enabled:
        print(f"[timer] {name}: {dt:.2f} ms")


@contextmanager
def trace_annotation(name: str):
    """nvtx.range equivalent: an nvtx range on the card, and a scope in
    torch.profiler traces."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


_profiler: Optional[torch.profiler.profile] = None


def start_profiler_trace(log_dir: str):
    """Start a torch.profiler capture (host and, on the card, device
    activity) that ``stop_profiler_trace`` writes to ``log_dir`` for
    TensorBoard's profiler plugin."""
    global _profiler
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    _profiler.start()


def stop_profiler_trace():
    global _profiler
    if _profiler is not None:
        _profiler.stop()
        _profiler = None
