"""The card's idle share of the traced served frames: 1 - the union of
device activity over the traced window's wall time, %. Moves
``serve_frames_per_s``."""

from perfbench.harness import idle_share as read  # noqa: F401
