"""Hand-written Hopper kernels (``csrc/*.cu``) and their wrappers.

Each wrapper launches its CUDA kernel on CUDA tensors and runs the plain
PyTorch version of the same function on CPU tensors.
"""


def launch_counts() -> dict:
    """Every wrapper's launch counter, non-zero ones only, as
    ``{"<wrapper>.<counter>": n}``: what a CLI prints after its run, so a
    caller sees which kernels its path launched (all zero on the CPU)."""
    from .expand import expand_decode_pairs, expand_sorted_rows
    from .fill import forward_fill
    from .fold import fold_pairs, fold_shared_segment, invert_permutation
    from .raster import rasterize_tiles, rasterize_tiles_backward
    from .scatter import id_runs, scatter_runs
    from .wmax import pair_weight_max

    counts = {}
    for fn in (expand_decode_pairs, rasterize_tiles, rasterize_tiles_backward,
               fold_pairs, invert_permutation, fold_shared_segment,
               pair_weight_max, id_runs, scatter_runs, expand_sorted_rows,
               forward_fill):
        for k, v in vars(fn).items():
            if k.startswith("launches") and v:
                counts[f"{fn.__name__}.{k}"] = v
    return counts
