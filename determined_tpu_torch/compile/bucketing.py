"""Shape canonicalization: batch-size bucketing (docs/compile-farm.md).

Counterpart of determined_tpu/compile/bucketing.py, copied whole but for
the tree walk (`torch.utils._pytree` in place of `jax.tree_util`) and a
padded leaf keeping its type (a tensor stays a tensor). The preflight's
DTL205 reads `bucket_size` and `CompileConfig`; the Trainer pads every
training and validation batch with `bucketed_iter`, and the compile worker
resolves `CompileConfig`. On the port an "executable" is a step captured
by `make_multi_step` or by `Trainer.fit` (`make_captured_step`: one CUDA
graph a bucket), keyed by exact shapes as an XLA executable is.

An XLA executable is keyed by exact input shapes, so an hparam sweep that
samples `global_batch_size` raw compiles one executable per sampled value —
the recompile explosion DTL205 warns about. Bucketing rounds the batch
dimension up to a bucket boundary (powers of two by default) *consistently
at trace time and run time*: the compile farm signs and precompiles the
bucketed shape, and the Trainer pads every loader batch to the same bucket,
so all batch sizes inside a bucket share one executable.

Padding semantics: pad rows are wrap-around repeats of real rows (never
zeros — zero rows can NaN a loss and would silently skew metrics more than
duplicates do). The loss then averages over `bucket` rows instead of `b`,
i.e. rows `0..(bucket-b)` carry double weight — equivalent to a slightly
re-weighted batch, deterministic per config. Bucketing is therefore OFF by
default and opt-in via `compile: {bucket_batch_sizes: true}`; runs of the
SAME config are always bit-identical to each other (warm or cold cache)
because both apply the identical padding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

# DTL205's default ceiling: a sweep implying more distinct executables than
# this without bucketing gets flagged (docs/preflight.md).
DEFAULT_MAX_EXECUTABLES = 8


def bucket_size(n: int, buckets: Optional[List[int]] = None) -> int:
    """Smallest bucket boundary >= n.

    Default buckets are powers of two. With an explicit bucket list, sizes
    above the largest bucket stay unbucketed (exact) — better an extra
    executable than silently padding a huge batch to something huger.
    """
    if n <= 0:
        return n
    if buckets:
        for b in sorted(buckets):
            if b >= n:
                return int(b)
        return n
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass
class CompileConfig:
    """Resolved `compile:` expconf block (defaults match apply_defaults)."""

    enabled: bool = True  # participate in the farm (fetch/upload artifacts)
    background: bool = False  # master precompiles while trials queue
    bucket_batch_sizes: bool = False
    buckets: Optional[List[int]] = None  # None = powers of two
    max_executables: int = DEFAULT_MAX_EXECUTABLES  # DTL205 threshold
    upload: bool = True  # fresh compiles upload serialized executables

    @classmethod
    def from_block(cls, block: Any) -> "CompileConfig":
        if isinstance(block, bool):
            return cls(enabled=block)
        if not isinstance(block, dict):
            return cls()
        return cls(
            enabled=bool(block.get("enabled", True)),
            background=bool(block.get("background", False)),
            bucket_batch_sizes=bool(block.get("bucket_batch_sizes", False)),
            buckets=[int(b) for b in block["buckets"]]
            if block.get("buckets") else None,
            max_executables=int(
                block.get("max_executables", DEFAULT_MAX_EXECUTABLES)),
            upload=bool(block.get("upload", True)),
        )

    @classmethod
    def resolve(cls, trial: Any = None,
                expconf: Optional[Dict[str, Any]] = None) -> "CompileConfig":
        """Trial attribute `compile` wins over the experiment config block
        (the same precedence as `prefetch`, docs/trial-api.md)."""
        attr = getattr(trial, "compile", None) if trial is not None else None
        if attr is not None:
            return cls.from_block(attr)
        if expconf is not None and expconf.get("compile") is not None:
            return cls.from_block(expconf.get("compile"))
        return cls()


def _leading_batch_dim(batch: Any) -> Optional[int]:
    """The global batch size: leading dim shared by the batch leaves."""
    for leaf in pytree.tree_leaves(batch):
        shape = getattr(leaf, "shape", ())
        if len(shape) >= 1:
            return int(shape[0])
    return None


def pad_batch(batch: Any, target: int) -> Any:
    """Pad every leaf whose leading dim equals the batch size up to `target`
    rows by wrapping (repeating rows from the front). Host-side — runs
    before the async input pipeline's device transfer; a tensor leaf stays
    a tensor, any other becomes a numpy array as in the JAX package."""
    b = _leading_batch_dim(batch)
    if b is None or b >= target:
        return batch

    def one(leaf):
        shape = getattr(leaf, "shape", ())
        if len(shape) < 1 or shape[0] != b:
            return leaf
        reps = (target + b - 1) // b
        if isinstance(leaf, torch.Tensor):
            return torch.cat([leaf] * reps, dim=0)[:target]
        arr = np.asarray(leaf)
        return np.concatenate([arr] * reps, axis=0)[:target]

    return pytree.tree_map(one, batch)


def bucketed_batch(batch: Any, cfg: CompileConfig) -> Any:
    """Apply run-time bucketing to one host batch (no-op when disabled)."""
    if not cfg.bucket_batch_sizes:
        return batch
    b = _leading_batch_dim(batch)
    if b is None:
        return batch
    return pad_batch(batch, bucket_size(b, cfg.buckets))


def bucketed_iter(it: Iterable[Any], cfg: CompileConfig) -> Iterator[Any]:
    """Wrap a host-batch iterator with run-time bucketing. The wrapper is
    installed UPSTREAM of the DevicePrefetcher so padded batches are what
    get sharded and transferred (shapes seen by the jitted step match the
    signed bucketed shapes exactly)."""
    for batch in it:
        yield bucketed_batch(batch, cfg)
