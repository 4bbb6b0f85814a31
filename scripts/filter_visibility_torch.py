#!/usr/bin/env python3
"""Prune particles never visible from any training view, with the
PyTorch/CUDA port (the counterpart of scripts/filter_visibility.py, plus
``--device``).

Reference: threedgrut/export/scripts/filter_visibility.py (182 LoC) -
renders every training view (``render_gut``; on the card kernels A and
B once a view), ORs the per-particle visibility masks
(``mog_visibility``), and writes the live visible particles as a PLY.
The config is composed from ``--config-name`` and the overrides, as the
JAX script composes it (add ``initialization.method=checkpoint
initialization.path=<ckpt>`` to skip building the initial cloud that
the checkpoint then overwrites). NHT checkpoints are refused: the PLY
holds SH features, which an NHT model lacks.

Renders on the card; without one it stops, unless ``--device cpu`` asks
for the CPU. Ends with the kernels' launch counts.

Usage: python scripts/filter_visibility_torch.py --checkpoint ckpt.npz \\
           --config-name apps/colmap_3dgut --out out.ply path=/data/scene
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config-name", default="apps/nerf_synthetic_3dgut")
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu renders on "
                        "the CPU, slowly)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("filter_visibility_torch.py: no CUDA device; pass "
                         "--device cpu to render on the CPU")

    from threedgrut_tpu_torch.config.loader import load_config
    from threedgrut_tpu_torch.export.ply import export_ply
    from threedgrut_tpu_torch.ops.cuda import launch_counts
    from threedgrut_tpu_torch.render.gut import render_gut
    from threedgrut_tpu_torch.train.trainer import Trainer, camera_from_batch
    from train_torch import make_dataset, make_model, trainer_config

    conf = load_config(args.config_name, overrides=args.overrides)
    if conf.model.feature_type != "sh":
        raise SystemExit("filter_visibility_torch.py: NHT checkpoints are "
                         "refused: the PLY holds SH features, which an NHT "
                         "model lacks")
    tconf = trainer_config(conf)
    dataset = make_dataset(conf, "train")
    trainer = Trainer(tconf, dataset, make_model(conf, dataset, device))
    trainer.load_checkpoint(args.checkpoint)
    model = trainer.model

    visible = torch.zeros(model.capacity, dtype=torch.bool, device=device)
    with torch.no_grad():
        for i in range(len(dataset)):
            cam = camera_from_batch(dataset[i], device)
            out = render_gut(cam, tconf.ut, tconf.raster, model,
                             tconf.max_n_features)
            visible |= out["mog_visibility"]
    keep = visible & model.active_mask()
    print(f"visible: {int(keep.sum())} / {model.n_active}")

    def rows(t):
        return t.detach()[keep].cpu().numpy()

    export_ply(args.out, rows(model.positions), rows(model.rotation),
               rows(model.scale), rows(model.density),
               rows(model.features_albedo), rows(model.features_specular))
    print(f"wrote {args.out}")
    print("launches:", json.dumps(launch_counts()))


if __name__ == "__main__":
    main()
