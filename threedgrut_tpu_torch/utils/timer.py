"""Spans, host reads and the device timer (port of
threedgrut_tpu/utils/timer.py; threedgrut/utils/timer.py equivalents).

Spans mark the layers of the training step and of the served frame
(``grut.step``, ``grut.frame``, ``grut.ut``, ``grut.raster``, ...).
``ScopedTimer(name)`` opens one; ``timed(name)`` wraps a function in
one. They are off unless ``timing_options.active`` is set or a
torch.profiler capture is running; off, entering a span checks two
flags and returns a shared no-op context. On, a span

- opens a ``torch.profiler.record_function`` range, so the capture
  shows it beside the kernels its host code launched,
- pushes an nvtx range where the card is in use,
- adds its host-clock time to ``span_table()``: calls, total and self
  milliseconds (self = total less the child spans) per name, the names
  of its parents, and the units it ran in. A span opened with
  ``unit=True`` (a step, a frame) starts a new unit; the spans inside
  it carry its sequence id (the range's args, ``unit=<id>``).

A span never synchronises with the device. ``host_read(site, t)`` is
the one way the step and the frame read a device value: it returns
``t.item()`` (which waits for the device) and, while spans are on,
counts one read for ``site`` (``host_read_counts()``) inside a
``grut.read.<site>`` span. ``upload`` copies host data to the device
without waiting for it. ``reset_spans()`` clears the table and the
counts.

``DeviceTimer`` times device work with CUDA events on the card, where
JAX blocks on the result around a host clock; on the CPU it reads the
host clock.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Dict

import numpy as np
import torch
import torch.autograd.profiler as _profiler


@dataclasses.dataclass
class TimingOptions:
    """Global toggle (threedgrut/utils/timer.py:30-168)."""
    active: bool = False


timing_options = TimingOptions()


def spans_on() -> bool:
    """Whether spans record: the toggle, or a running torch.profiler
    capture (the profiler's own flag)."""
    return timing_options.active or _profiler._is_profiler_enabled


class _Off:
    """The shared context of a span that is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
# name -> [calls, total s, self s, parent names, units, last unit]
_table: Dict[str, list] = {}
_reads: Dict[str, int] = {}
_units = [0]
_local = threading.local()


class _Span:
    __slots__ = ("name", "unit", "_new_unit", "_parent", "_child", "_rf",
                 "_nvtx", "_t0")

    def __init__(self, name: str, unit: bool):
        self.name = name
        self._new_unit = unit

    def __enter__(self):
        parent = getattr(_local, "open", None)
        if self._new_unit:
            _units[0] += 1
            self.unit = _units[0]
        else:
            self.unit = parent.unit if parent is not None else _units[0]
        self._parent = parent
        self._child = 0.0
        _local.open = self
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._rf = torch.profiler.record_function(self.name,
                                                  f"unit={self.unit}")
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._rf.__exit__(None, None, None)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        parent = self._parent
        _local.open = parent
        if parent is not None:
            parent._child += dt
        row = _table.get(self.name)
        if row is None:
            row = _table[self.name] = [0, 0.0, 0.0, set(), 0, None]
        row[0] += 1
        row[1] += dt
        row[2] += dt - self._child
        row[3].add(parent.name if parent is not None else None)
        if row[5] != self.unit:
            row[4] += 1
            row[5] = self.unit
        return False


def ScopedTimer(name: str, unit: bool = False):
    """The span ``name`` as a context manager (``unit``: a step or a
    frame, which starts a new sequence id); a shared no-op while spans
    are off."""
    return _Span(name, unit) if spans_on() else _OFF


def timed(name: str, unit: bool = False):
    """Decorator: run the function inside the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not spans_on():
                return fn(*args, **kwargs)
            with _Span(name, unit):
                return fn(*args, **kwargs)
        return inner
    return wrap


def host_read(site: str, t: torch.Tensor):
    """``t.item()``: the device value on the host, which waits for the
    device. While spans are on, counts one read for ``site`` and times
    it as the span ``grut.read.<site>``."""
    if not spans_on():
        return t.item()
    with _Span("grut.read." + site, False):
        v = t.item()
    _reads[site] = _reads.get(site, 0) + 1
    return v


def upload(values, device, dtype=torch.float32) -> torch.Tensor:
    """Host ``values`` (array-like) as a tensor on ``device``; to the card
    through pinned memory without waiting for the device (a plain copy
    from pageable memory synchronises)."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def span_table() -> Dict[str, dict]:
    """Per span name: calls, total_ms, self_ms, parents (sorted names,
    None for a root) and units (the distinct units it ran in)."""
    return {name: {"calls": r[0], "total_ms": r[1] * 1e3,
                   "self_ms": r[2] * 1e3,
                   "parents": sorted(r[3], key=lambda p: p or ""),
                   "units": r[4]}
            for name, r in _table.items()}


def host_read_counts() -> Dict[str, int]:
    """Host reads by site since the last ``reset_spans``."""
    return dict(_reads)


def reset_spans() -> None:
    _table.clear()
    _reads.clear()


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
