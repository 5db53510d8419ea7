"""The port's kernels: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it (see ops/paged_attention.py)."""
