#!/usr/bin/env python3
"""Any-to-any gaussian asset transcoder CLI of the PyTorch/CUDA port
(the counterpart of scripts/transcode.py, flag for flag).

Converts between PLY / USDA / USDC / USDZ / trainer checkpoints, merges
multiple inputs, applies a 4x4 transform (``--transform``, a .npy, with
the SH rotated to follow it, or ``--normalize``: recentre on the median
particle position and scale the median spread to 1) and KD-partitions
into size-bounded ParticleFields with a ``<stem>_partitions.json``
manifest. numpy only: it renders nothing and needs no card.

Usage:
  python scripts/transcode_torch.py in.ply out.usdz
  python scripts/transcode_torch.py a.ply b.usda merged.usda
  python scripts/transcode_torch.py ckpt_last.npz out.ply --normalize
  python scripts/transcode_torch.py big.ply out.usda --max-particles 1000000
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+",
                    help="input asset(s) followed by the output path")
    ap.add_argument("--transform", type=str, default=None,
                    help="path to a .npy 4x4 world transform to apply")
    ap.add_argument("--normalize", action="store_true",
                    help="recenter on the median particle position and "
                         "scale the median spread to 1")
    ap.add_argument("--max-particles", type=int, default=None,
                    help="KD-partition outputs to at most N particles "
                         "per file")
    args = ap.parse_args(argv)
    if len(args.paths) < 2:
        ap.error("need at least one input and one output path")
    inputs, output = args.paths[:-1], args.paths[-1]

    from threedgrut_tpu_torch.export.transcode import load_any, transcode

    transform = None
    if args.transform:
        transform = np.load(args.transform).astype(np.float64)
        if transform.shape != (4, 4):
            raise SystemExit(f"--transform must be 4x4, got "
                             f"{transform.shape}")
    if args.normalize:
        pts = np.concatenate([load_any(p)["positions"] for p in inputs])
        center = np.median(pts, axis=0)
        spread = np.median(np.linalg.norm(pts - center, axis=1))
        s = 1.0 / max(float(spread), 1e-6)
        transform = np.eye(4)
        transform[:3, :3] *= s
        transform[:3, 3] = -center * s

    written = transcode(inputs, output, transform=transform,
                        max_particles_per_partition=args.max_particles)
    for p in written:
        print(p)


if __name__ == "__main__":
    main()
