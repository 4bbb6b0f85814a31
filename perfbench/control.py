"""Readings that the limits of a cell's correctness numbers are set from.

    python3 -m perfbench.control --workload <cell> --seeds 1 2 3 [--seconds 2]

For each seed, in one process: the program's numbers against the
reference (its set-up's checked steps, or a short serving window), the
control's (the reference computed in TF32 in the program's place), and
each fault's that the cell can have, planted in the program's outputs or
in the reference put in its place:

- training: a step that returns its state unchanged (the program's
  change set to 0; it reads 1 by the measure, with no run), and
  half of the image left out of the loss, the mean taken over the rest;
- serving: one kept frame altered where it is produced (a tenth of its
  rows brightened by 2/255).

One JSON line per seed and reading. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import torch

from perfbench import harness, scene
from perfbench.reference import train as ref_train
from perfbench.run import cache_dirs


def train_readings(driver, st) -> dict:
    prog = driver.program_readings(st)
    ref32 = driver.reference_readings(st)
    out = {"program": driver.compare(prog, ref32),
           "control_tf32": driver.compare(
               driver.reference_readings(st, "tf32"), ref32),
           "fault_half_batch": driver.compare(
               driver.reference_readings(st, drop_half=True), ref32)}
    init = scene.standin_cloud(st["conf"]["rows"], st["seed"], st["device"])
    still = prog._replace(change={k: torch.zeros_like(v)
                                  for k, v in prog.change.items()},
                          rows=ref_train.row_summary(init))
    out["fault_state_unchanged"] = driver.compare(still, ref32)
    return out


def serve_readings(driver, st) -> dict:
    ref32 = driver.reference_frames(st)
    frames = dict(st["frames"])
    out = {"program": driver.compare(frames, ref32),
           "control_tf32": driver.compare(
               driver.reference_frames(st, "tf32"), ref32)}
    v = min(frames)
    bad = frames[v].clone()
    rows = bad.shape[0] // 10
    bad[:rows] += 2.0 / 255.0
    out["fault_frame_altered"] = driver.compare({**frames, v: bad}, ref32)
    return out


def readings(cell, seed: int, seconds: float, device) -> dict:
    driver = harness.load_driver(cell)
    st = driver.setup(SimpleNamespace(cell=cell, seed=seed, device=device))
    if cell.traffic["driver"] == "serve":
        driver.window(st, seconds)
    driver.release(st)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if cell.traffic["driver"] == "serve":
        return serve_readings(driver, st)
    return train_readings(driver, st)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = harness.resolve_cell(args.workload)
    cache_dirs(harness.ROOT)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = readings(cell, seed, args.seconds, torch.device("cuda", 0))
        for kind, numbers in r.items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": kind, **numbers}), flush=True)
        harness.log(f"seed {seed} done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
