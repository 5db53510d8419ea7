"""Collectives over process groups that autograd passes through.

The JAX package needs none of these: GSPMD places the collectives of a
sharded program itself. Here a model split over a mesh axis calls them
where the split starts and ends:

  - `copy_to` (Megatron's f): identity forward, all-reduce backward. It
    stands where a replicated activation enters a product whose weight is
    split over the group: each rank's gradient of it is one part of the
    whole, and the sum is what every rank needs.
  - `reduce_from` (Megatron's g): all-reduce forward, identity backward.
    It sums the parts a split product leaves on each rank; every rank's
    result, and so its gradient, is the same.
  - `sum_over`: all-reduce forward and backward, for a value that every
    rank holds a part of and every rank uses whole (the MoE load-balance
    loss's f and p, the mean loss over the context axis): the gradient of
    a rank's part is the sum of every rank's use of the whole.
  - `max_over`: the maximum, outside autograd (a softmax's shift).
  - `gather_from`: all-gather along a dim forward, the rank's own slice
    of the gradient backward (Megatron's gather). It stands where a split
    activation (a conv's or a product's output channels) is made whole
    for consumers that compute replicated over the group: each rank then
    holds the same full gradient of the whole, and its slice is the
    gradient of its piece. A reduce-scatter there would count the
    gradient once per rank.

`groups` are process groups (`parallel/mesh.axis_group(...).group`);
a sequence of them reduces over each in turn, which over the axes of one
mesh is the reduction over their product.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch


def all_reduce(t: torch.Tensor, groups: Sequence[Any],
               op: str = "sum") -> torch.Tensor:
    """A copy of `t` reduced over each group in turn (no autograd)."""
    import torch.distributed as dist

    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    t = t.detach().clone()
    for g in groups:
        dist.all_reduce(t, op=red, group=g)
    return t


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.groups), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        return all_reduce(t, groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return all_reduce(t, groups)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.groups), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        import torch.distributed as dist

        ctx.dim, ctx.index = dim, dist.get_rank(group)
        ctx.size = t.shape[dim]
        t = t.contiguous()
        pieces = [torch.empty_like(t)
                  for _ in range(dist.get_world_size(group))]
        dist.all_gather(pieces, t, group=group)
        return torch.cat(pieces, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), \
            None, None


def _tuple(groups) -> tuple:
    return tuple(groups) if isinstance(groups, (list, tuple)) else (groups,)


def copy_to(t: torch.Tensor, groups) -> torch.Tensor:
    """Megatron's f over `groups` (a group or a sequence of them)."""
    return _CopyTo.apply(t, _tuple(groups))


def reduce_from(t: torch.Tensor, groups) -> torch.Tensor:
    """Megatron's g over `groups`."""
    return _ReduceFrom.apply(t, _tuple(groups))


def sum_over(t: torch.Tensor, groups) -> torch.Tensor:
    """The sum over `groups`, forward and backward."""
    return _SumOver.apply(t, _tuple(groups))


def max_over(t: torch.Tensor, groups) -> torch.Tensor:
    """The elementwise maximum over `groups`, detached."""
    return all_reduce(t, _tuple(groups), op="max")


def gather_from(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Megatron's gather over one process group: the ranks' pieces of
    `t` concatenated along `dim` in group-rank order; the gradient of
    this rank's piece is its slice of the whole's gradient."""
    return _GatherFrom.apply(t, group, dim)
