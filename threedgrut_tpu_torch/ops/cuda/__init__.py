"""Hand-written Hopper kernels (``csrc/*.cu``) and their wrappers.

Each wrapper launches its CUDA kernel on CUDA tensors and runs the plain
PyTorch version of the same function on CPU tensors.
"""
