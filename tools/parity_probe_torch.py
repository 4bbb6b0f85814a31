#!/usr/bin/env python3
"""Render-versus-oracle parity probe of the PyTorch/CUDA port
(the port's counterpart of tools/parity_probe.py, same flags and columns,
plus ``--device``).

Renders the bench cloud (``threedgrut_tpu_torch/synthetic.py:bench_cloud``,
``--n`` Gaussians, seed 0) from the origin down +z through ``render_gut``
and the all-pixels x all-particles ``render_oracle`` on the device
(``render/oracle.py:oracle_probe``, the view of bench.py's probe), and
prints per configuration: PSNR (dB), the bulk PSNR over the pixels whose
hit counts agree, max |err| and the fraction of pixels whose hit counts
differ (flips). That tells a kill-boundary discontinuity (few pixels,
large error: a ~1e-7 transmittance difference flips the frozen-ray
decision on pixels whose T crosses min_transmittance) from bulk precision
noise (every pixel, small error: a kernel that lost precision).

Configurations:
  * ``exact_kill``: the port's render settings (the port always kills
    exactly, as the JAX package's exact_kill);
  * ``nokill_eps``: min_transmittance 1e-30 on both sides, no freeze
    discontinuity: the bulk precision error alone.
Left out by rule (the port keeps no TPU-only knob): the JAX probe's
``vpu_scan`` (the MXU prefix scan off) and ``unfused`` (the MXU-fused hit
dot products off); neither has a counterpart on the card.

A failed render is not caught: the probe exits non-zero.

    python tools/parity_probe_torch.py [--side 200] [--n 60000]
    python tools/parity_probe_torch.py --device cpu --side 24 --n 500
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

# the JAX probe's pair cap (86 slabs of 8192 pairs)
MAX_PAIRS = 86 * 8192


def configs():
    from threedgrut_tpu_torch.render.common import RasterConfig

    return {
        "exact_kill": RasterConfig(max_pairs=MAX_PAIRS),
        "nokill_eps": RasterConfig(max_pairs=MAX_PAIRS,
                                   min_transmittance=1e-30),
    }


def columns(got, ref):
    """The JAX probe's columns of one (render_gut, render_oracle) pair:
    {psnr, bulk, max_err, flips}."""
    g = got["pred_features"].double().cpu().numpy()
    r = ref["pred_features"].double().cpu().numpy()
    gh = got["hits_count"].cpu().numpy()[..., 0]
    rh = ref["hits_count"].cpu().numpy()[..., 0]
    err = np.abs(g - r)
    mse = float(np.mean(err ** 2))
    db = 999.0 if mse == 0 else float(-10 * np.log10(mse))
    # bulk parity over the pixels whose hit counts agree: an
    # acceptance-threshold flip adds or drops one min-alpha contribution
    # (~1/255) on isolated pixels, a floor of any reimplementation and
    # not the precision loss this probe is for
    agree = gh == rh
    mse_b = float(np.mean((err ** 2)[agree])) if agree.any() else 0.0
    db_b = 999.0 if mse_b == 0 else float(-10 * np.log10(mse_b))
    return dict(psnr=db, bulk=db_b, max_err=float(err.max()),
                flips=float(1 - agree.mean()))


def run(side=200, n=60000, device="cuda"):
    """Probe every configuration on ``device`` and print its row.
    Returns {name: (its columns, render_gut's output, render_oracle's)}
    (render/oracle.py:oracle_probe's pair)."""
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.render.oracle import oracle_probe
    from threedgrut_tpu_torch.synthetic import bench_cloud

    model = bench_cloud(n, seed=0, device=device)
    out = {}
    for name, rc in configs().items():
        got, ref = oracle_probe(model, UTConfig(), rc, side, n)
        row = columns(got, ref)
        print(f"{name:12s} psnr={row['psnr']:7.1f} dB  "
              f"bulk={row['bulk']:7.1f} dB  max|e|={row['max_err']:.2e}  "
              f"flips={row['flips']:.5f}", flush=True)
        out[name] = (row, got, ref)
    return out


def main(argv=None):
    """Print one row per configuration; return them as {name: {psnr,
    bulk, max_err, flips}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=200)
    ap.add_argument("--n", type=int, default=60000)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the probe "
                    "on the CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("parity_probe_torch.py: no CUDA device; pass "
                         "--device cpu to probe on the CPU")
    return {k: v[0] for k, v in run(args.side, args.n, device).items()}


if __name__ == "__main__":
    main()
