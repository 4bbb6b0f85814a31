#!/usr/bin/env python3
"""PLY -> USD ParticleField converter of the PyTorch/CUDA port (the
counterpart of scripts/ply_to_usd.py): a thin wrapper over the port's
transcoder for the most common conversion. numpy only; no card.

Usage:
  python scripts/ply_to_usd_torch.py model.ply [model.usdz]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="3DGS .ply asset")
    ap.add_argument("output", nargs="?", default=None,
                    help=".usda/.usdz output (default: input with .usdz)")
    args = ap.parse_args(argv)
    output = args.output or os.path.splitext(args.input)[0] + ".usdz"

    from threedgrut_tpu_torch.export.transcode import transcode
    for p in transcode([args.input], output):
        print(p)


if __name__ == "__main__":
    main()
