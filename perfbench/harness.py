"""The benchmark's general part: cells found by name, the run's result
line, the device's record and the reduction of a profiler trace.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in files of its own under the checkout, found from the
names in ``BENCHMARK.json``:

- ``BENCHMARK.json``'s ``configs`` entry names the configuration's file,
- ``perfbench/traffic/<traffic>.json`` holds a mix's parameters and names
  its driver, ``perfbench/drivers/<driver>.py``,
- ``perfbench/metrics/<metric>.py`` reads one per-layer metric,
- ``perfbench/limits/<cell>.json`` holds the limits of a cell's
  correctness numbers.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple, Optional

ROOT = Path(__file__).resolve().parents[1]

# top-level module names that must not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "threedgrut_tpu")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic file's contents
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]   # the cell's per-layer metrics
    limits: Dict[str, float]
    root: Path


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


class Stopwatch:
    """Seconds of named phases, logged as one line."""

    def __init__(self):
        import time

        self._now = time.perf_counter
        self._t = self._now()
        self.parts = []

    def lap(self, name: str) -> None:
        t = self._now()
        self.parts.append(f"{name} {t - self._t:.2f}")
        self._t = t

    def report(self, what: str) -> None:
        log(f"{what}: " + ", ".join(self.parts) + " s")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(name: str, root: Path = ROOT) -> Cell:
    """Everything a run of cell ``name`` needs, found by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf_entry["file"])
    traffic = load_json(root / "perfbench" / "traffic"
                        / f"{w['traffic']}.json")
    return Cell(
        name=name, chips=w["chips"], config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        limits=load_json(root / "perfbench" / "limits" / f"{name}.json"),
        root=root)


def _load_file(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(cell: Cell) -> ModuleType:
    kind = cell.traffic["driver"]
    return _load_file(cell.root / "perfbench" / "drivers" / f"{kind}.py",
                      f"perfbench_driver_{kind}")


def load_metric(cell: Cell, name: str) -> ModuleType:
    return _load_file(cell.root / "perfbench" / "metrics" / f"{name}.py",
                      "perfbench_metric_" + name.replace(".", "_"))


def read_metrics(cell: Cell, records: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read in; the others are left out."""
    out = {}
    for m in cell.per_layer:
        value = load_metric(cell, m["name"]).read(records)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_loaded() -> List[str]:
    """The forbidden top-level modules that ``sys.modules`` holds,
    compared by whole top-level name."""
    tops = {k.split(".", 1)[0] for k in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def nvidia_smi(fields: str = "name,power.limit") -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unavailable"


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between closest ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# --- the profiler ---------------------------------------------------------

def profile_units(unit, n: int, pad: int = 1) -> dict:
    """Trace ``n`` calls of ``unit`` with torch.profiler (after ``pad``
    untimed calls inside the session: the profiler drops a session's first
    device records) and reduce the trace: device seconds by kernel name,
    the union of device activity, the traced window's wall seconds, and
    the idle gaps labelled by the host operation they fell in."""
    import time

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
    return reduce_trace(prof.events(), n)


def reduce_trace(events, n_units: int) -> dict:
    """Device time by kernel, busy seconds, window seconds and idle gaps
    of the events inside the ``perfbench.traced`` range."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    span = [e for e in events if e.name == "perfbench.traced"]
    if not span:
        raise RuntimeError("the trace lacks its perfbench.traced range")
    t0, t1 = span[0].time_range.start, span[0].time_range.end
    # device activity: kernels, copies and sets; not the annotation ranges
    # that record_function also lays on the device's track
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)
                  and e.name != "perfbench.traced"
                  and e.time_range.start >= t0 and e.time_range.end <= t1),
                 key=lambda r: r[0])
    kernels: Dict[str, float] = {}
    for s, e, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-6
    busy, gaps, end = 0.0, [], t0
    for s, e, _ in dev:
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if t1 > end:
        gaps.append((end, t1))
    host = sorted(((e.time_range.start, e.time_range.end, e.name, e.thread)
                   for e in events if e.device_type != cuda
                   and e.name != "perfbench.traced"
                   and e.time_range.end > t0 and e.time_range.start < t1),
                  key=lambda r: r[0])
    labels = _gap_labels(gaps, host)
    idle: Dict[str, float] = {}
    for (s, e), lab in zip(gaps, labels):
        idle[lab] = idle.get(lab, 0.0) + (e - s) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "kernels": kernels, "units": n_units, "busy_s": busy * 1e-6,
        "window_s": (t1 - t0) * 1e-6,
        "device_ops": [[k[:160], v] for k, v in top],
        "idle_gaps": [[k[:160], v] for k, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def _gap_labels(gaps, host) -> List[str]:
    """The innermost host operation running at each gap's midpoint, or
    "host (no operator)" where none runs."""
    stacks: Dict[int, list] = {}
    out, i = [], 0
    for s, e in gaps:
        t = 0.5 * (s + e)
        while i < len(host) and host[i][0] <= t:
            hs, he, name, th = host[i]
            st = stacks.setdefault(th, [])
            while st and st[-1][1] < hs:
                st.pop()
            st.append((hs, he, name))
            i += 1
        best: Optional[tuple] = None
        for st in stacks.values():
            while st and st[-1][1] < t:
                st.pop()
            if st and (best is None or st[-1][0] > best[0]):
                best = st[-1]
        out.append(best[2] if best else "host (no operator)")
    return out


def kernel_seconds(records: dict, patterns) -> Optional[float]:
    """Device seconds of the kernels whose names hold any of
    ``patterns``; None where the trace holds none of them."""
    hits = [v for k, v in records.get("kernels", {}).items()
            if any(p in k for p in patterns)]
    return sum(hits) if hits else None


# --- what the per-layer readers share --------------------------------------

def idle_share(records: dict) -> Optional[float]:
    """1 - the union of device activity over the traced window, %."""
    if not records.get("window_s"):
        return None
    return 100.0 * (1.0 - records["busy_s"] / records["window_s"])


def roofline(records: dict, patterns, count) -> Optional[float]:
    """The share of their roofline that the kernels named by ``patterns``
    reach: the bound of the profiled views' work (``count`` of each view's
    counts) over those kernels' device time, %."""
    t = kernel_seconds(records, patterns)
    if not t or not records.get("counts"):
        return None
    return 100.0 * sum(count(c)["bound_s"] for c in records["counts"]) / t


def mfu(records: dict, flops) -> Optional[float]:
    """The profiled views' mean needed fp32 operations (``flops`` of each
    view's counts) over the untraced window's mean unit time at the fp32
    peak, %."""
    from perfbench.counts.raster import FP32_PEAK

    c = records.get("counts")
    if not c:
        return None
    return 100.0 * (sum(flops(x) for x in c) / len(c)) / (
        records["unit_mean_s"] * FP32_PEAK)
