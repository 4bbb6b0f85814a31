"""PyTorch/CUDA port of ``threedgrut_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module
paths (``ops/pallas/`` becomes ``ops/cuda/``) and holds every function
against its JAX counterpart in ``tests/test_torch_*.py``. It imports
torch and numpy, and nothing of the JAX package; yaml (``config/``) and
PIL (``data/``) only where those modules are used.

Every value-carrying contraction runs in full fp32: TF32 is switched off
for matmuls and cuDNN convolutions at import (ROADMAP.md, fp32 rule).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
