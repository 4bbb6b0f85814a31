"""The port's spans (``threedgrut_tpu_torch/utils/timer.py``) in a
cell's units: device time, idle time and host time by ``grut.`` span,
and the program's host reads a unit.

    python3 -m perfbench.spans --workload <cell> --seed <n> [--units 5]

sets the cell up as ``perfbench.run`` does, then runs three segments of
``--units`` units each: untraced (spans off), spans on without a
profiler (the host's time by span and the reads a unit), and under
torch.profiler (one pad unit first, as ``harness.profile_units``),
whose trace ``reduce_spans`` charges to the spans. It prints one JSON
line (each segment's mean unit, the profiled one over the traced
window) and writes nothing else.

``reduce_spans`` charges each kernel's device time to the innermost
``grut.`` span around the runtime call that launched it (the profiler
gives a kernel and its launch one correlation id). A backward
kernel goes to the span of the forward operation that its autograd
node came from (the profiler's ``sequence_nr`` and ``fwd_thread``); a
host call that no span holds on its own thread (the autograd engine's
thread) goes to the span that runs on another thread at its start,
which is ``grut.backward`` while the engine runs. Each idle gap of the
device goes to the innermost span at its midpoint.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

from perfbench import harness

PREFIX = "grut."
NO_SPAN = "(no span)"
# host events of the CUDA runtime and driver: the launches and copies
RUNTIME = ("cuda", "cu")
# the units, and the layer spans that make the projection
UNIT_SPANS = ("grut.step", "grut.frame")
PROJECT = ("grut.ut", "grut.sh", "grut.table")


def _nesting(host) -> Dict[int, tuple]:
    """For each host event (by id): the innermost ``grut.`` span and the
    innermost autograd node (``fwd_thread`` set, ``sequence_nr`` >= 0)
    that hold it on its own thread, itself included."""
    out = {}
    by_thread: Dict[int, list] = {}
    for e in host:
        by_thread.setdefault(e.thread, []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
        stack: List[tuple] = []       # (end, span, node)
        for e in evs:
            while stack and stack[-1][0] <= e.time_range.start:
                stack.pop()
            span, node = (stack[-1][1], stack[-1][2]) if stack else (None,
                                                                    None)
            if e.name.startswith(PREFIX):
                span = e.name
            if getattr(e, "fwd_thread", 0) and e.sequence_nr >= 0:
                node = (e.fwd_thread, e.sequence_nr)
            out[id(e)] = (span, node)
            stack.append((e.time_range.end, span, node))
    return out


def _span_at(spans, t) -> Optional[str]:
    """The innermost span running at host time ``t`` on any thread."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or s > best[0]):
            best = (s, name)
    return best[1] if best else None


def reduce_spans(events, n_units: int) -> dict:
    """Device and idle milliseconds a unit by span, of the events inside
    the ``perfbench.traced`` range: ``device_ms`` (every kernel, copy and
    set, forward and linked backward), ``backward_ms`` (the linked
    backward part of each), ``idle_ms``, ``layer_share`` (the share of
    the device time charged to a span other than a unit's own) and
    ``uncovered`` (what is charged to a unit's span or to none, ms a
    unit, by kernel)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    traced = [e for e in events if e.name == "perfbench.traced"
              and e.device_type != cuda]
    if not traced:
        raise RuntimeError("the trace lacks its perfbench.traced range")
    t0, t1 = traced[0].time_range.start, traced[0].time_range.end
    host = [e for e in events if e.device_type != cuda
            and e.name != "perfbench.traced"
            and t0 <= e.time_range.start < t1]
    nest = _nesting(host)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in host if e.name.startswith(PREFIX))
    # an operation records the sequence number its node would take, made
    # or not: the last to record one made the node
    fwd_span = {}
    for e in sorted(host, key=lambda e: e.time_range.start):
        span, _ = nest[id(e)]
        if (e.sequence_nr >= 0 and not getattr(e, "fwd_thread", 0)
                and span is not None):
            fwd_span[(e.thread, e.sequence_nr)] = span
    launches = {e.id: e for e in host if e.name.startswith(RUNTIME)}
    dev = sorted((e for e in events if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)
                  and e.name != "perfbench.traced"
                  and e.time_range.start >= t0 and e.time_range.end <= t1),
                 key=lambda e: e.time_range.start)
    per = 1e-3 / n_units
    device: Dict[str, float] = {}
    backward: Dict[str, float] = {}
    uncovered: Dict[str, float] = {}
    for d in dev:
        ms = (d.time_range.end - d.time_range.start) * per
        launch = launches.get(d.id)
        span, linked = NO_SPAN, False
        if launch is not None:
            span, node = nest[id(launch)]
            linked = node is not None and node in fwd_span
            if linked:
                span = fwd_span[node]
            elif span is None:
                span = _span_at(spans, launch.time_range.start) or NO_SPAN
        device[span] = device.get(span, 0.0) + ms
        if linked:
            backward[span] = backward.get(span, 0.0) + ms
        if span in UNIT_SPANS or span == NO_SPAN:
            uncovered[d.name] = uncovered.get(d.name, 0.0) + ms
    gaps, end = [], t0
    for s, e in ((d.time_range.start, d.time_range.end) for d in dev):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    idle: Dict[str, float] = {}
    for s, e in gaps:
        name = _span_at(spans, 0.5 * (s + e)) or NO_SPAN
        idle[name] = idle.get(name, 0.0) + (e - s) * per
    total = sum(device.values())
    layers = sum(v for k, v in device.items()
                 if k not in UNIT_SPANS and k != NO_SPAN)
    return {
        "device_ms": device, "backward_ms": backward, "idle_ms": idle,
        "layer_share": layers / total if total else None,
        "uncovered": sorted(([k[:160], v] for k, v in uncovered.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def device_ms(reduced: dict, names) -> Optional[float]:
    """Device milliseconds a unit of the spans ``names`` (a span's own
    children by prefix: ``grut.mcmc`` holds ``grut.mcmc.relocate``);
    None where the trace holds none of them."""
    hits = [v for k, v in reduced.get("device_ms", {}).items()
            if any(k == n or k.startswith(n + ".") for n in names)]
    return sum(hits) if hits else None


def host_reads_per_unit(unit_span: str) -> Optional[float]:
    """The program's host reads a unit while spans were on: its count of
    ``host_read`` calls over the calls of ``unit_span``. None where the
    program has no counter or ran no such unit with spans on."""
    try:
        from threedgrut_tpu_torch.utils import timer
        reads, table = timer.host_read_counts(), timer.span_table()
    except (ImportError, AttributeError):
        return None
    units = table.get(unit_span, {}).get("calls")
    return sum(reads.values()) / units if units else None


def enqueue_ms(table: dict, unit_span: str) -> Optional[float]:
    """Host milliseconds a unit of ``unit_span`` less its host reads."""
    row = table.get(unit_span)
    if not row or not row["calls"]:
        return None
    reads = sum(v["total_ms"] for k, v in table.items()
                if k.startswith(PREFIX + "read."))
    return (row["total_ms"] - reads) / row["calls"]


def profile_events(unit, n: int, pad: int = 1):
    """``harness.profile_units``' capture, returning its events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(pad):
            unit()
        sync()
        time.sleep(0.02)
        with record_function("perfbench.traced"):
            for _ in range(n):
                unit()
            sync()
    return prof.events()


def segments(unit, n: int, sync) -> dict:
    """The three segments of ``n`` units: untraced, spans only, and
    profiled; each segment's mean unit in ms, the spans-only table and
    reads a unit, and both reductions of the profiled trace."""
    from threedgrut_tpu_torch.utils import timer

    def timed_units(k):
        sync()
        t = time.perf_counter()
        for _ in range(k):
            unit()
        sync()
        return (time.perf_counter() - t) * 1e3 / k

    out = {"untraced_unit_ms": timed_units(n)}
    timer.reset_spans()
    timer.timing_options.active = True
    try:
        out["spans_unit_ms"] = timed_units(n)
    finally:
        timer.timing_options.active = False
    table = timer.span_table()
    out["span_host_ms"] = {k: v["total_ms"] / n for k, v in table.items()}
    out["span_self_ms"] = {k: v["self_ms"] / n for k, v in table.items()}
    out["reads"] = {k: v / n for k, v in timer.host_read_counts().items()}
    unit_span = next(u for u in UNIT_SPANS if u in table)
    timer.reset_spans()
    events = profile_events(unit, n)
    out["trace"] = harness.reduce_trace(events, n)
    out["profiled_unit_ms"] = out["trace"]["window_s"] * 1e3 / n
    r = out["spans"] = reduce_spans(events, n)
    # the per-layer metrics of the spans, as a traced run would read them
    kind = "train" if unit_span == "grut.step" else "serve"
    out["metrics"] = {
        f"device_ms.project.{kind}": device_ms(r, PROJECT),
        f"device_ms.adam.{kind}": device_ms(r, ["grut.adam"]),
        f"device_ms.mcmc.{kind}": device_ms(r, ["grut.mcmc"]),
        f"device_ms.isp.{kind}": device_ms(r, ["grut.isp"]),
        f"host_reads.{kind}": host_reads_per_unit(unit_span),
        f"enqueue_ms.{kind}": enqueue_ms(table, unit_span)}
    timer.reset_spans()
    return out


def main(argv=None) -> int:
    from types import SimpleNamespace

    import torch

    from perfbench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=5)
    args = ap.parse_args(argv)
    cell = harness.resolve_cell(args.workload)
    run.cache_dirs(harness.ROOT)
    dev = torch.device("cuda", 0)
    driver = harness.load_driver(cell)
    st = driver.setup(SimpleNamespace(cell=cell, seed=args.seed, device=dev))
    if cell.traffic["driver"] == "train":
        def unit():
            return driver._step(st)
    else:
        def unit():
            return driver._request(st)
    out = segments(unit, args.units, torch.cuda.synchronize)
    out.update(cell=cell.name, seed=args.seed, units=args.units,
               card=harness.nvidia_smi())
    harness.log("idle by span (ms a unit): " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(out["spans"]["idle_ms"].items(),
                                          key=lambda kv: -kv[1])))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
