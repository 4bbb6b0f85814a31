#!/usr/bin/env python3
"""Insert a proxy mesh file into a gaussian .usdz archive with the
PyTorch/CUDA port's container writer (the counterpart of
scripts/add_mesh_to_usdz.py): packs a mesh asset (.glb/.obj/...)
alongside the default ParticleField layer in the aligned usdz container,
the default layer staying first, and lists the entries. No card.

Usage:
  python scripts/add_mesh_to_usdz_torch.py model.usdz proxy.glb
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("usdz", help="existing .usdz archive (modified in place)")
    ap.add_argument("mesh", help="mesh file to insert (.glb/.obj/...)")
    ap.add_argument("--name", default=None,
                    help="entry name inside the archive (default: basename)")
    args = ap.parse_args(argv)

    import zipfile

    from threedgrut_tpu_torch.export.usd import add_file_to_usdz
    add_file_to_usdz(args.usdz, args.mesh, entry_name=args.name)
    with zipfile.ZipFile(args.usdz) as z:
        for n in z.namelist():
            print(n)


if __name__ == "__main__":
    main()
