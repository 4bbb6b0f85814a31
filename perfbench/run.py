"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the port's configuration, the seed's scene and views, the
program's first steps or frames, warm-up) runs from the process's start
to the first timed step; then the window runs for ``--seconds``. With
``--trace 1`` a profiled segment follows and the per-layer metrics are
read. Once the program's state is freed, the reference checks what the
timed path produced. The last line of standard output is the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from perfbench import harness  # noqa: E402


def host_probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: how fast the host runs
    the interpreter just now (a run-to-run diagnostic of a shared host)."""
    t0 = time.perf_counter()
    sum(i * i for i in range(300_000))
    return (time.perf_counter() - t0) * 1e3


def by_second(unit_s) -> list:
    """How many units ended in each whole second of the window."""
    counts, t = [], 0.0
    for d in unit_s:
        t += d
        while len(counts) <= int(t):
            counts.append(0)
        counts[int(t)] += 1
    return counts


def cache_dirs(root) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = root / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float = T_START) -> dict:
    """One run of ``cell`` on ``device``: the result line's object and the
    numbers compared with their limits."""
    import torch

    driver = harness.load_driver(cell)
    ctx = SimpleNamespace(cell=cell, seed=seed, device=device)
    st = driver.setup(ctx)
    setup_s = time.perf_counter() - t_start
    harness.log(f"set-up {setup_s:.1f} s; host probe {host_probe_ms():.1f} ms")
    w = driver.window(st, seconds)
    probe_after = host_probe_ms()
    u = sorted(w["unit_s"])
    slow = [i for i, t in enumerate(w["unit_s"]) if t > 2 * u[len(u) // 2]]
    harness.log(
        f"window {w['elapsed_s']:.2f} s, {w['attempted']} units: median "
        f"{u[len(u) // 2] * 1e3:.2f} ms, max {u[-1] * 1e3:.2f} ms, over "
        f"twice the median at {slow[:12]}; host probe {probe_after:.1f} ms")
    harness.log(f"units by second of the window: {by_second(w['unit_s'])}")
    records = dict(w)
    if trace:
        records.update(driver.trace(st, cell.traffic["profiled"]))
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.release(st)
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = driver.check(st)
    harness.log(f"check {time.perf_counter() - t0:.1f} s")
    if trace:
        records["counts"] = driver.counts(st)
        harness.log(f"traced {records['window_s']:.3f} s, counts done")
        metrics = harness.read_metrics(cell, records)
    else:
        e2e = driver.end_to_end(w)
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in e2e.items() if k in units}
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev_rec = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak),
        "power_limit": harness.nvidia_smi("power.limit") if cuda else None,
    }
    out = {"correct": correct, "attempted": w["attempted"],
           "failed": w["failed"], "metrics": metrics, "device": dev_rec}
    if trace:
        dev_rec["busy_s"] = records["busy_s"]
        dev_rec["window_s"] = records["window_s"]
        out["breakdown"] = {"device_ops": records["device_ops"],
                            "idle_gaps": records["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.resolve_cell(args.workload)
    cache_dirs(harness.ROOT)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    # after the window, in the process that prints the result
    forbidden = harness.forbidden_loaded()
    if forbidden:
        print("modules of the JAX side are loaded: " + ", ".join(forbidden),
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
