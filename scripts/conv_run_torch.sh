#!/bin/bash
# Full-protocol 30k convergence runs of the PyTorch/CUDA port on the
# generated synthetic scene (scripts/conv_run.sh's four modes and
# overrides, over train_torch.py), then render_torch.py on the run's
# ckpt_last.npz (the 16 test views) into runs/conv_<mode>_torch_<tag>/eval/.
# Usage (from the repository root, after
#   python scripts/gen_synthetic_scene_torch.py --out runs/synth_lego):
#   bash scripts/conv_run_torch.sh gs   [tag] [key=value ...]  # GS densify/prune/reset
#   bash scripts/conv_run_torch.sh mcmc [tag] [key=value ...]  # MCMC + SelectiveAdam
#   bash scripts/conv_run_torch.sh nht  [tag] [key=value ...]  # MCMC + NHT decoder
#   bash scripts/conv_run_torch.sh grt  [tag] [key=value ...]  # 3DGRT sorted compositing
# Extra key=value arguments go to train_torch.py (e.g. resume=<ckpt>).
# The JAX runs pinned their pair budget at 786,432 pairs a view
# (render.max_pairs=786432 render.auto_max_pairs=false, TPU knobs); the
# port sizes its pair buffer per view and drops no pair, so it passes
# neither.
set -eu
MODE=${1:-gs}
TAG=${2:-r1}
shift $(( $# > 2 ? 2 : $# ))
cd "$(dirname "$0")/.."
EXTRA=""
case "$MODE" in
  gs)
    APP=apps/nerf_synthetic_3dgut ;;
  mcmc)
    APP=apps/nerf_synthetic_3dgut_mcmc
    # cap MCMC capacity at bench scale (default add.max_n_gaussians=1M
    # would allocate a 1M-capacity model)
    EXTRA="strategy.add.max_n_gaussians=100000" ;;
  nht)
    APP=apps/nerf_synthetic_3dgut_mcmc_nht
    EXTRA="strategy.add.max_n_gaussians=100000" ;;
  grt)
    APP=apps/nerf_synthetic_3dgrt ;;
  *)
    echo "unknown mode $MODE"; exit 2 ;;
esac
NAME=conv_${MODE}_torch_${TAG}
python train_torch.py --config-name "$APP" path=runs/synth_lego \
  out_dir=runs experiment_name="$NAME" \
  checkpoint.frequency=2000 val_frequency=2000 \
  initialization.num_gaussians=30000 model.print_stats=true \
  ${EXTRA:-} "$@"
if [ "$MODE" = nht ]; then
  echo "render_torch.py refuses NHT checkpoints (render.py cannot score them)"
  exit 0
fi
python render_torch.py --checkpoint "runs/$NAME/ckpt_last.npz" \
  --path runs/synth_lego --out-dir "runs/$NAME/eval"
