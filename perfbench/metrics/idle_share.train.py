"""The card's idle share of the traced training steps: 1 - the union of
device activity over the traced window's wall time, %. Moves
``train_steps_per_s``."""

from perfbench.harness import idle_share as read  # noqa: F401
