"""Ulysses-style sequence parallelism for attention (DeepSpeed-Ulysses,
arXiv:2309.14509).

Counterpart of determined_tpu/ops/ulysses.py. Attention needs every
key/value for each query, so a sequence-split layout cannot compute it
locally. Ulysses swaps the split dimension with two all-to-alls instead of
gathering:

    [B, S/cp, H, Dh]  --all_to_all-->  [B, S, H/cp, Dh]   (split heads)
        attention over the FULL sequence on H/cp local heads
    [B, S, H/cp, Dh]  --all_to_all-->  [B, S/cp, H, Dh]   (split seq again)

Each exchange is one `all_to_all_single` over the `context` group, the
autograd form of `torch.distributed._functional_collectives`, whose
backward is the all-to-all the other way. Rank c sends its chunk of
every head group to the rank of that group and receives the group's
heads of every chunk, in chunk order: the JAX `all_to_all(split_axis=2,
concat_axis=1, tiled=True)`. The inner attention is `flash_attention`:
the CUDA kernels on a CUDA tensor of a shape they take, the plain version
on the CPU.

Without a mesh, or with a context axis of 1, the function is
`flash_attention` too. The JAX function falls back to its dense
`_inner_attention` there, an XLA program; here the dense form would
materialise the fp32 [B, H, S, S] logits on the card (12.9 GB a layer at
B 4, S 8192) with no kernel in it, and the kernels compute the same
attention.

q, k and v are this rank's `[B, S/cp, H/tp, Dh]`: with a `tensor` axis
above 1 the heads are already split over it, so the local head count
must divide by the context size. `n_head` is the model's (global) head
count, `H/tp * tp` when not given.
"""

from __future__ import annotations

from typing import Optional

import torch

from determined_tpu_torch.ops.flash_attention import flash_attention
from determined_tpu_torch.parallel.mesh import AxisGroup, axis_group


def _all_to_all(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """x [cp, ...] -> [cp, ...]: piece i goes to rank i; piece i of the
    result came from rank i."""
    from torch.distributed import _functional_collectives as fc

    out = fc.all_to_all_single_autograd(x.contiguous(), None, None,
                                        axis.group)
    return fc.wait_tensor(out)


def _spread(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """[b, S/cp, h, d] -> [b, S, h/cp, d]: this rank's sequence chunk of
    every head group for the full sequence of its own head group."""
    b, s, h, d = x.shape
    cp = axis.size
    pieces = x.reshape(b, s, cp, h // cp, d).permute(2, 0, 1, 3, 4)
    got = _all_to_all(pieces, axis)  # [cp (chunk), b, s, h/cp, d]
    return got.permute(1, 0, 2, 3, 4).reshape(b, cp * s, h // cp, d)


def _gather_back(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """[b, S, h/cp, d] -> [b, S/cp, h, d], the inverse of `_spread`."""
    b, s_full, hl, d = x.shape
    cp = axis.size
    s = s_full // cp
    pieces = x.reshape(b, cp, s, hl, d).permute(1, 0, 2, 3, 4)
    got = _all_to_all(pieces, axis)  # [cp (head group), b, s, h/cp, d]
    return got.permute(1, 2, 0, 3, 4).reshape(b, s, cp * hl, d)


def ulysses_attention(
    q: torch.Tensor,  # [B, S/cp, H/tp, Dh], this rank's chunk
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    mesh=None,
    n_head: Optional[int] = None,
) -> torch.Tensor:
    """Attention with the sequence dim split over the `context` axis of
    the DeviceMesh `mesh` via two all-to-alls (head-splitting inside).
    `flash_attention` when there is no mesh or the axis has size 1."""
    seq = axis_group(mesh, "context")
    if seq is None:
        return flash_attention(q, k, v, causal=causal)
    cp = seq.size

    # Inside the mesh the head dim is already split over `tensor`, so the
    # all-to-all splits the LOCAL head count: that, not the global count,
    # must divide the context size.
    head = axis_group(mesh, "tensor")
    tp = head.size if head is not None else 1
    if n_head is None:
        n_head = q.shape[2] * tp
    if n_head % tp != 0:
        raise ValueError(
            f"ulysses attention needs n_head ({n_head}) divisible by the "
            f"tensor axis size ({tp})"
        )
    local_heads = n_head // tp
    if local_heads % cp != 0:
        raise ValueError(
            f"ulysses attention needs per-shard head count {local_heads} "
            f"(n_head {n_head} / tensor size {tp}) divisible by the "
            f"context axis size ({cp})"
        )
    if q.shape[2] != local_heads:
        raise ValueError(
            f"q holds {q.shape[2]} heads; n_head {n_head} over tensor size "
            f"{tp} gives {local_heads} a rank")

    out = flash_attention(_spread(q, seq), _spread(k, seq), _spread(v, seq),
                          causal=causal)
    return _gather_back(out, seq)
