"""Learned post-processing (port of
threedgrut_tpu/models/post_processing.py:35-78), by name.

JAX's facade adds no function of its own: ``apply_ppisp`` passes its
arguments to ``apply_ppisp_full``, and ``PPISPController`` wraps the
controller CNN, so here both are names for ``models/ppisp.py``'s. Its
dispatch on ``post_processing.method`` (``apply_post_processing``) is
the trainer's ``Trainer.post_process``.
"""

from .ppisp import PPISPControllerCNN as PPISPController  # noqa: F401
from .ppisp import apply_ppisp_full as apply_ppisp  # noqa: F401
