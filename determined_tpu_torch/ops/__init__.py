"""The port's kernels: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it (see ops/paged_attention.py), and the
sequence-parallel attentions built on the flash kernels, exported as the
JAX package's `ops` exports its ring attention.

`ring_attention` here is the function; the module of the same name (its
per-block steps) is `importlib.import_module(
"determined_tpu_torch.ops.ring_attention")`."""

from determined_tpu_torch.ops.ring_attention import ring_attention  # noqa: F401
from determined_tpu_torch.ops.ulysses import ulysses_attention  # noqa: F401
