#!/usr/bin/env python3
"""Export a trained checkpoint to a USD ParticleField asset with the
PyTorch/CUDA port's export modules (the counterpart of
scripts/export_usd.py, flag for flag).

Loads a trainer checkpoint (.npz of train_torch.py or train.py, which
share their keys) or a 3DGS PLY and writes .usda (ascii stage) or .usdz
(aligned container), optionally through a 4x4 world transform (a .npy;
``export/transforms.py:estimate_normalizing_transform`` gives the
normalising one) with the SH rotated to follow it, and with float
attributes at half precision. numpy only: it renders nothing and needs
no card. NHT checkpoints are refused (no SH to write).

Usage:
  python scripts/export_usd_torch.py ckpt_last.npz model.usdz
  python scripts/export_usd_torch.py model.ply model.usda --half
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="checkpoint .npz or .ply asset")
    ap.add_argument("output", help=".usda or .usdz output path")
    ap.add_argument("--transform", type=str, default=None,
                    help=".npy 4x4 world transform applied on export")
    ap.add_argument("--half", action="store_true",
                    help="store float attributes at half precision")
    args = ap.parse_args(argv)

    from threedgrut_tpu_torch.export import usd as usd_mod
    from threedgrut_tpu_torch.export.transcode import (activated_to_raw,
                                                       load_any,
                                                       raw_to_activated)

    attrs = load_any(args.input)
    if args.transform:
        from threedgrut_tpu_torch.export.sh_rotation import (
            rotate_sh_coefficients)
        from threedgrut_tpu_torch.export.transforms import (
            apply_transform_to_gaussians)
        transform = np.load(args.transform).astype(np.float64)
        deg = attrs["sh_degree"]
        raw = apply_transform_to_gaussians(activated_to_raw(attrs),
                                           transform)
        rs = transform[:3, :3]
        s = float(np.cbrt(abs(np.linalg.det(rs))))
        sh = rotate_sh_coefficients(attrs["sh_coefficients"], rs / s, deg)
        raw["features_albedo"] = sh[:, 0, :]
        raw["features_specular"] = sh[:, 1:, :].reshape(sh.shape[0], -1)
        attrs = raw_to_activated(raw)

    deg = attrs.get("sh_degree", 3)
    kw = dict(half=True) if args.half else {}
    if args.output.endswith(".usdz"):
        usd_mod.export_usdz(args.output, attrs, sh_degree=deg, **kw)
    elif args.output.endswith(".usda"):
        usd_mod.export_usda(args.output, attrs, sh_degree=deg, **kw)
    else:
        raise SystemExit("output must end in .usda or .usdz")
    n = attrs["positions"].shape[0]
    print(f"{args.output}: {n} particles, sh_degree={deg}")


if __name__ == "__main__":
    main()
