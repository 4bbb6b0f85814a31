"""Readings that the limits of the NHT cell's correctness numbers are set
from (``control.py``'s, for ``drivers/train_nht.py``).

    python3 -m perfbench.control_nht --workload <cell> --seeds 1 2 3

For each seed, in one process, the numbers against the fp32 reference
of: the program's checked steps; two controls, the reference with its
decoder's products in bf16 and the reference in TF32 throughout; and the
planted faults: a step that returns its state unchanged (the program's
change and EMA change set to 0), half of the image left out of the loss,
the decoder given zeros for the direction encoding, the cosine half of
the ray features dropped, and the EMA shadow left alone. One JSON line
per seed and reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import torch

from perfbench import harness
from perfbench.run import cache_dirs

CONTROLS = ("bf16_decoder", "tf32")
FAULTS = ("half", "no_dir", "no_cos", "no_ema")


def readings(cell, seed: int, device) -> dict:
    driver = harness.load_driver(cell)
    st = driver.setup(SimpleNamespace(cell=cell, seed=seed, device=device))
    driver.release(st)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prog = driver.program_readings(st)
    ref32 = driver.reference_readings(st)
    out = {"program": driver.compare(prog, ref32)}
    for p in CONTROLS:
        out["control_" + p] = driver.compare(
            driver.reference_readings(st, p), ref32)
    for f in FAULTS:
        out["fault_" + f] = driver.compare(
            driver.reference_readings(st, fault=f), ref32)
    init = driver.nht_cloud(st["conf"], seed, device)
    still = prog._replace(
        steps=prog.steps._replace(
            change={k: torch.zeros_like(v)
                    for k, v in prog.steps.change.items()},
            rows=driver.ref_nht.row_summary(init)),
        ema_change={k: torch.zeros_like(v)
                    for k, v in prog.ema_change.items()})
    out["fault_state_unchanged"] = driver.compare(still, ref32)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.resolve_cell(args.workload)
    cache_dirs(harness.ROOT)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = readings(cell, seed, torch.device("cuda", 0))
        for kind, numbers in r.items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": kind, **numbers}), flush=True)
        harness.log(f"seed {seed} done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
