"""Mean of the (tile, particle) pairs that survive the binning's cull, as
``train_iteration`` returns them, over the window's steps (kernel A's
output; the raster kernels' work grows with it). Moves
``train_steps_per_s``."""


def read(records):
    pairs = records.get("pairs")
    return sum(pairs) / len(pairs) if pairs else None
