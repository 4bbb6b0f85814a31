"""Multi-GPU training over torch.distributed (port of
threedgrut_tpu/parallel): band-sharded data parallelism with exact halo
SSIM (``dp.py``), depth-sliced particle parallelism (``particle.py``),
the collectives both use (``comm.py``), a one-host launcher
(``launch.py``) and the multi-device dry run (``dryrun.py``)."""
