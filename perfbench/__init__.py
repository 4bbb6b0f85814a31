"""The benchmark of the PyTorch/CUDA port (``threedgrut_tpu_torch``) on
one NVIDIA H100: cells of a configuration under a traffic mix, run by
``python3 -m perfbench.run``; see ``harness.py`` for the layout."""
