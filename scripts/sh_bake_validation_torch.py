#!/usr/bin/env python3
"""Validate a PPISP -> SH bake against the live ISP with the PyTorch/CUDA
port (the counterpart of scripts/sh_bake_validation.py, plus
``--device``).

For a gaussian asset + PPISP sidecar (``export/usd.py:export_ppisp_usda``),
bake the linear part of the ISP (responsivity * 2^exposure — the
reference's scale_sh_output, sh_bake.py:33) into the SH coefficients and
report the max/mean radiance error between [linearly scaled original
radiance] and [baked radiance], sampled over random view directions
(``ops/sh.py:eval_sh_radiance``). The vignetting, homography
normalization and CRF are nonlinear/spatial; fitting those requires the
optimization bake (threedgrut_tpu_torch/export/sh_bake.py). Prints
``OK`` and exits 0 when the largest error is under 1e-4.

Evaluates on the card; without one it stops, unless ``--device cpu``
asks for the CPU.

Usage:
  python scripts/sh_bake_validation_torch.py model.usdz ppisp.usda \\
      [--camera 0] [--frame 0] [--samples 4096] [--device cuda]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("asset", help="gaussian asset (.ply/.usda/.usdz/.npz)")
    ap.add_argument("ppisp", help="PPISP sidecar .usda")
    ap.add_argument("--camera", type=int, default=0)
    ap.add_argument("--frame", type=int, default=0)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu evaluates on the "
                    "CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sh_bake_validation_torch.py: no CUDA device; pass "
                         "--device cpu to evaluate on the CPU")

    from threedgrut_tpu_torch.export import usd as usd_mod
    from threedgrut_tpu_torch.export.transcode import load_any
    from threedgrut_tpu_torch.ops.sh import eval_sh_radiance

    attrs = load_any(args.asset)
    ppisp = usd_mod.import_ppisp_usda(args.ppisp)
    sh = np.asarray(attrs["sh_coefficients"], np.float32)  # [N,K,3]
    deg = int(np.sqrt(sh.shape[1])) - 1
    n = min(sh.shape[0], args.samples)
    rng = np.random.default_rng(0)
    pick = rng.choice(sh.shape[0], size=n, replace=False)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    baked = usd_mod.bake_ppisp_into_sh(sh, ppisp, camera_idx=args.camera,
                                       frame_idx=args.frame)

    def radiance(coeffs):
        return eval_sh_radiance(torch.from_numpy(coeffs[pick]).to(device),
                                torch.from_numpy(dirs).to(device),
                                deg).cpu().numpy()

    rad = radiance(sh)
    rad_baked = radiance(baked)

    s = (2.0 ** float(np.asarray(ppisp["responsivity"])[args.camera])
         * 2.0 ** float(np.asarray(ppisp["exposure"])[args.frame]))
    rad_isp = rad * s

    err = np.abs(rad_baked - rad_isp)
    print(f"samples={n} sh_degree={deg} camera={args.camera} "
          f"frame={args.frame} device={device}")
    print(f"max |baked - isp(linear part)| = {err.max():.3e}")
    print(f"mean |baked - isp(linear part)| = {err.mean():.3e}")
    ok = err.max() < 1e-4
    print("OK" if ok else "MISMATCH (vignette/CRF excluded by design; "
          "check camera/frame indices)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
