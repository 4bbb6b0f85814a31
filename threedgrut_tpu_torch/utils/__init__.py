"""Evaluation helpers (port of threedgrut_tpu/utils): colour
correction, the sRGB transfer and LPIPS."""
