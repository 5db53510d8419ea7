"""Pipeline parallelism: GPipe-style microbatched execution over the
`pipeline` mesh axis.

Counterpart of determined_tpu/parallel/pipeline.py: the same functions
(`pipeline_stage_count`, `pipeline_microbatches_default`,
`pipeline_apply`) and the same contract. The L stacked layers are split
into S stages of L/S layers (the "layers" dim of a stacked leaf is sharded
over `pipeline`); M microbatches flow through them in M + S - 1 ticks,
stage `s` running microbatch `t - s` at tick `t` when `0 <= t - s < M`;
the output equals the plain loop over the L layers and is replicated over
the axis. Bubble fraction: (S - 1) / (M + S - 1).

The JAX package writes the schedule as a `shard_map` that is manual over
the pipeline axis: a scan over ticks, where every stage computes each
tick (on clamped inputs in the bubble, masked out after) and `ppermute`s
its result on. PyTorch runs one process per device, so here each process
runs its own stage's ticks, skips its bubble ticks (the function is the
same) and moves activations with point-to-point send and receive. The
schedule runs under autograd, so a loss built on it is differentiated by
the step factories as any other (train/step.py). Its parts stay apart:

  - the tick bookkeeping: `microbatch_at` (which microbatch a stage runs
    at a tick) and `commit_slot` (which output slot the last stage fills);
  - one stage's pass over one microbatch: `stage_forward`;
  - the transfer: `P2P`, an `autograd.Function` pair (`_Send`, `_Recv`)
    whose backward sends each gradient back to the stage that sent the
    activation, as the f/g pair of parallel/collectives.py does for a
    collective; `Handoff` hands activations on inside one process.

`run_schedule` puts them together. `walk` runs all S stages in one
process through `Handoff` (the schedule's plain version: the CPU tests
and the card's smoke run hold it to the plain loop and to
`pipeline_apply`).

Across processes a blocking send must meet its receive in the same order
on both ends. The forward runs the ticks in order on every stage. The
backward's order is fixed by the graph: each microbatch's first node
(`_Recv`, or the injection on stage 0) takes the token of the previous
microbatch's last node (`_Send`'s, or the committed output's on the last
stage) as an input, so autograd can run a microbatch's backward only
after the next one's. Every stage thus sends and receives gradients for
microbatches M - 1 down to 0, one at a time.

The stages' outputs are replicated over the axis by a broadcast from the
last stage (`from_last`), as the JAX package's `psum(outputs * is_last)`
does. Its backward passes the last stage's gradient through and gives
the other stages none: every stage's loss is the same function of the
same values, so the last stage's gradient is the gradient. A leaf
replicated over the axis (an embedding used on the first stage, a head on
the last) then holds a stage's share of the gradient on each stage, and
the shares are summed over the axis (`sharding.gather_for_use`'s
`sum_over`); a stage's own layers keep their gradient there.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from determined_tpu_torch.parallel import sharding
from determined_tpu_torch.parallel.mesh import axis_group
from determined_tpu_torch.parallel.sharding import LogicalRules


def _axis_size(mesh, axis: str) -> int:
    """The size of `axis` on a DeviceMesh or a resolved MeshConfig (1 for
    None or a mesh without it)."""
    if mesh is None:
        return 1
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:  # a MeshConfig
        return int(getattr(mesh, axis, 1))
    return mesh.size(names.index(axis)) if axis in names else 1


def pipeline_stage_count(mesh, axis: str = "pipeline") -> int:
    return _axis_size(mesh, axis)


def _batch_shards(mesh, rules: Optional[LogicalRules]) -> int:
    """How many ways the batch dim is sharded under the rules table."""
    axes = (rules or LogicalRules()).mesh_axes("batch")
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= _axis_size(mesh, a)
    return n


def pipeline_microbatches_default(mesh, batch: int,
                                  rules: Optional[LogicalRules] = None
                                  ) -> int:
    """Pick a microbatch count: toward 4*stages for a small bubble, while
    each microbatch stays divisible by the batch sharding. `batch` is the
    global batch; `mesh` a DeviceMesh or a resolved MeshConfig."""
    s = pipeline_stage_count(mesh)
    if s == 1:
        return 1
    local = max(batch // _batch_shards(mesh, rules), 1)
    want = min(local, 4 * s)
    while local % want:
        want -= 1
    return max(want, 1)


# ------------------------------------------------------ tick bookkeeping


def ticks(n_stages: int, num_microbatches: int) -> int:
    """The ticks of a GPipe schedule: M + S - 1."""
    return num_microbatches + n_stages - 1


def microbatch_at(tick: int, stage: int, n_stages: int,
                  num_microbatches: int) -> Optional[int]:
    """The microbatch `stage` runs at `tick`, or None in its bubble."""
    i = tick - stage
    return i if 0 <= i < num_microbatches else None


def commit_slot(tick: int, n_stages: int, num_microbatches: int
                ) -> Optional[int]:
    """The output slot the last stage fills at `tick` (the microbatch it
    finishes then), or None before the first has reached it."""
    return microbatch_at(tick, n_stages - 1, n_stages, num_microbatches)


# ------------------------------------------------ one stage, one microbatch


def stage_forward(block_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                  layers: Sequence[Any], x: torch.Tensor) -> torch.Tensor:
    """One stage's pass over one microbatch: its layers in order."""
    for lp in layers:
        x = block_fn(x, lp)
    return x


# ------------------------------------------------------------ the transfer


class _Tie(torch.autograd.Function):
    """`t` itself, after `deps` in the backward: autograd runs the nodes
    that made `deps` only once `t`'s gradient has passed here. `zero`:
    the deps get zero gradients (so the collectives in their backward run
    on every stage), else none."""

    @staticmethod
    def forward(ctx, t, zero, *deps):
        ctx.zero = zero
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        deps = [torch.zeros(s, dtype=dt, device=dev) if ctx.zero else None
                for s, dt, dev in ctx.deps]
        return (grad, None, *deps)


def tie(t: torch.Tensor, *deps: torch.Tensor, zero: bool = False
        ) -> torch.Tensor:
    """`t`, with `deps` in its graph (`_Tie`); deps that need no gradient
    are left out."""
    deps = tuple(d for d in deps if d is not None and d.requires_grad)
    if not deps:
        return t
    return _Tie.apply(t, zero, *deps)


class _Send(torch.autograd.Function):
    """Forward: send `y` to `dst`, return an empty token. Backward: receive
    `y`'s gradient from `dst`."""

    @staticmethod
    def forward(ctx, y, dst, group):
        import torch.distributed as dist

        ctx.meta = (y.shape, y.dtype, y.device, dst, group)
        dist.send(y.contiguous(), dst, group=group)
        return y.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        import torch.distributed as dist

        shape, dtype, device, dst, group = ctx.meta
        grad = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(grad, dst, group=group)
        return grad, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive an activation from `src` (after `anchor`).
    Backward: send its gradient back to `src`."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, group):
        import torch.distributed as dist

        ctx.meta = (anchor.shape, src, group)
        out = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        shape, src, group = ctx.meta
        dist.send(grad.contiguous(), src, group=group)
        return grad.new_zeros(shape), None, None, None, None


class P2P:
    """The transfer between the stages of one process group: this rank is
    `stage` of `n_stages`; activations of `shape` and `dtype` go to the
    next stage's rank and come from the previous one's. `anchor`: what the
    first received microbatch depends on (the stage's input and a leaf of
    its layers, with zero gradients), so that its backward runs whatever
    the caller asks gradients for."""

    def __init__(self, group, stage: int, n_stages: int, shape, dtype,
                 anchor: torch.Tensor):
        import torch.distributed as dist

        self.group, self.stage, self.n_stages = group, stage, n_stages
        self.shape, self.dtype = tuple(shape), dtype
        rank = (lambda i: dist.get_global_rank(group, i))
        self.prev = rank(stage - 1) if stage > 0 else None
        self.next = rank(stage + 1) if stage < n_stages - 1 else None
        # The token the next microbatch's first node waits on (module
        # docstring); None before stage 0's first microbatch. After the
        # last, the stage's tail: what its share of the loss hangs on.
        self.chain: Optional[torch.Tensor] = anchor if stage > 0 else None

    def take(self, stage: int, i: int, x: Optional[torch.Tensor]
             ) -> torch.Tensor:
        if stage == 0:
            return x if self.chain is None else tie(x, self.chain)
        return _Recv.apply(self.chain, self.shape, self.dtype, self.prev,
                           self.group)

    def give(self, stage: int, i: int, y: torch.Tensor) -> None:
        if stage < self.n_stages - 1:
            self.chain = _Send.apply(y, self.next, self.group)
        else:
            self.chain = tie(y.new_empty(0), y)


class Handoff:
    """The transfer inside one process: stage s's output of microbatch i
    is stage s + 1's input."""

    def __init__(self, n_stages: int):
        self.n_stages = n_stages
        self.box: Dict[Tuple[int, int], torch.Tensor] = {}

    def take(self, stage: int, i: int, x: Optional[torch.Tensor]
             ) -> torch.Tensor:
        return x if stage == 0 else self.box.pop((stage, i))

    def give(self, stage: int, i: int, y: torch.Tensor) -> None:
        if stage < self.n_stages - 1:
            self.box[(stage + 1, i)] = y


class _FromLast(torch.autograd.Function):
    """Forward: the last stage's `t` broadcast over the group (`t` on the
    others is their tail token, which only orders the backward). Backward:
    the gradient to the last stage's `t`; the others' tokens get zero."""

    @staticmethod
    def forward(ctx, t, shape, dtype, src, group, is_src):
        import torch.distributed as dist

        ctx.meta = (is_src, t.shape)
        out = t.detach().clone() if is_src else \
            torch.empty(shape, dtype=dtype, device=t.device)
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        is_src, shape = ctx.meta
        g = grad if is_src else grad.new_zeros(shape)
        return g, None, None, None, None, None


def from_last(t: torch.Tensor, shape, dtype, stage: "Stage"
              ) -> torch.Tensor:
    """The value of `t` on the last stage, on every stage of the axis."""
    import torch.distributed as dist

    src = dist.get_global_rank(stage.group, stage.n_stages - 1)
    return _FromLast.apply(t, tuple(shape), dtype, src, stage.group,
                           stage.last)


# ----------------------------------------------------------- the schedule


def run_schedule(stage_fn: Callable[[int, torch.Tensor], torch.Tensor],
                 micro: Sequence[Optional[torch.Tensor]], n_stages: int,
                 stages: Sequence[int], transfer,
                 commit: Callable[[int, int, int], Optional[int]]
                 = commit_slot) -> List[Optional[torch.Tensor]]:
    """Run the GPipe ticks for `stages` (this process's stage, or all of
    them in one process): stage s at tick t runs microbatch t - s
    (`microbatch_at`; its bubble ticks are skipped), stage 0 on
    `micro[i]`, the others on what `transfer` hands them. Returns the last
    stage's outputs by slot (`commit`), None where this process holds no
    last stage."""
    m = len(micro)
    outputs: List[Optional[torch.Tensor]] = [None] * m
    for t in range(ticks(n_stages, m)):
        for s in stages:
            i = microbatch_at(t, s, n_stages, m)
            if i is None:
                continue
            x = transfer.take(s, i, micro[i] if s == 0 else None)
            y = stage_fn(s, x)
            if s == n_stages - 1:
                outputs[commit(t, n_stages, m)] = y
            transfer.give(s, i, y)
    return outputs


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> List[Any]:
    out: List[Any] = []
    _tree_map(out.append, tree)
    return out


def unstack(tree, n: int) -> List[Any]:
    """A tree of `[n, ...]` leaves as n trees of per-layer views (one
    unbind per leaf, so a leaf's backward stacks its n gradients once)."""
    parts = [p.unbind(0) for p in _leaves(tree)]

    def layer(i):
        it = iter(parts)
        return _tree_map(lambda _: next(it)[i], tree)

    return [layer(i) for i in range(n)]


def _n_layers(tree) -> int:
    return _leaves(tree)[0].shape[0]


def walk(block_fn: Callable[[torch.Tensor, Any], torch.Tensor],
         stacked_params: Any, x: torch.Tensor, n_stages: int,
         num_microbatches: int,
         commit: Callable[[int, int, int], Optional[int]] = commit_slot,
         slices: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The schedule of `pipeline_apply` over `n_stages` stages, walked in
    one process: every stage in turn at each tick, each activation handed
    on in memory. `stacked_params` are plain `[L, ...]` leaves; stage s
    runs layer slice `slices[s]` (by default s). Same function as the
    plain loop over the L layers."""
    n_layers = _n_layers(stacked_params)
    _check_layers(n_layers, n_stages)
    _check_batch(x.shape[0], num_microbatches, 1)
    per = n_layers // n_stages
    layers = unstack(stacked_params, n_layers)
    slices = list(range(n_stages)) if slices is None else list(slices)
    outputs = run_schedule(
        lambda s, xin: stage_forward(
            block_fn, layers[slices[s] * per:(slices[s] + 1) * per], xin),
        x.chunk(num_microbatches, dim=0), n_stages, range(n_stages),
        Handoff(n_stages), commit)
    return torch.cat(outputs, dim=0)


def _check_layers(n_layers: int, n_stages: int) -> None:
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers not divisible by {n_stages} stages")


def _check_batch(batch: int, m: int, shards: int) -> None:
    """The JAX package's refusals of a microbatch count; `batch` is the
    global batch."""
    if batch % m:
        raise ValueError(
            f"batch {batch} not divisible by {m} microbatches")
    mb = batch // m
    if mb % shards:
        raise ValueError(
            f"microbatch size {mb} (batch {batch} / {m} microbatches) must "
            f"stay divisible by the {shards}-way batch sharding — use "
            "pipeline_microbatches_default() to pick a valid count")


class Stage:
    """Where this rank sits on the pipeline axis of `mesh`: its stage, the
    count of stages and the axis's process group (None without one)."""

    def __init__(self, mesh, axis: str = "pipeline"):
        g = axis_group(mesh, axis)
        self.group = g.group if g is not None else None
        self.n_stages = g.size if g is not None else 1
        self.index = g.index if g is not None else 0

    @property
    def last(self) -> bool:
        return self.index == self.n_stages - 1


def stage_layers(stacked_params: Any, stage: Stage,
                 axis: str = "pipeline") -> List[Any]:
    """This stage's layers of `stacked_params` as per-layer trees: a
    DTensor leaf split over `axis` gathered for use keeping that split
    (this stage's L/S layers; its gradient stays there) and its `tensor`
    split; any other leaf sliced to the stage's layers (a plain tensor's
    gradient is then its slice's on each stage)."""
    n_layers = _n_layers(stacked_params)
    _check_layers(n_layers, stage.n_stages)
    per = n_layers // stage.n_stages

    def local(p):
        if axis in sharding.shard_axes(p):
            return sharding.gather_for_use(p, keep=(axis, "tensor"))
        # Replicated over the axis (or a plain tensor): the stage's slice,
        # whose gradient the sum over the axis puts together.
        full = sharding.gather_for_use(p, keep=("tensor",), sum_over=(axis,))
        return full.narrow(0, stage.index * per, per)

    return unstack(_tree_map(local, stacked_params), per)


def run_stage(block_fn: Callable[[torch.Tensor, Any], torch.Tensor],
              layers: Sequence[Any], x: torch.Tensor, *, stage: Stage,
              num_microbatches: int, shards: int = 1,
              compute_dtype: Any = None
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """This rank's stage of the schedule over its process group: x [B, ...]
    (this rank's rows, the same on every stage; stage 0 splits it into
    microbatches) -> (the last stage's output [B, ...] in x's dtype, None
    on the other stages; on those, the stage's tail token, which their
    loss must hang on: `from_last`)."""
    m = num_microbatches
    _check_batch(x.shape[0] * shards, m, shards)
    micro = list(x.chunk(m, dim=0))
    if compute_dtype is not None:
        micro = [t.to(compute_dtype) for t in micro]
    mb = micro[0]
    first_leaf = _leaves(layers[0])[0] if layers else None
    anchor = tie(mb.new_empty(0), x, first_leaf, zero=True)
    transfer = P2P(stage.group, stage.index, stage.n_stages, mb.shape,
                   mb.dtype, anchor)
    outputs = run_schedule(
        lambda s, xin: stage_forward(block_fn, layers, xin),
        micro, stage.n_stages, [stage.index], transfer)
    if not stage.last:
        return None, transfer.chain
    return torch.cat(outputs, dim=0).to(x.dtype), None


def pipeline_apply(block_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                   stacked_params: Any, x: torch.Tensor, *, mesh,
                   num_microbatches: int, axis: str = "pipeline",
                   rules: Optional[LogicalRules] = None,
                   compute_dtype: Any = None) -> torch.Tensor:
    """Run L stacked layers as a pipeline over mesh axis `axis`.

    block_fn(x, layer_params) -> x applies ONE layer. L must divide
    evenly into stages; the global batch (x holds this rank's rows of it)
    must divide into `num_microbatches`, and each microbatch over the
    batch sharding. Returns activations after the last layer, replicated
    over the pipeline axis. `stacked_params`: `[L, ...]` leaves, DTensors
    laid out by their logical axes ("layers" over `pipeline`) or plain
    tensors (each stage slices its layers; its gradient is then its
    slice's). compute_dtype: activations cast to it inside the stages and
    back to x's dtype on return."""
    stage = Stage(mesh, axis)
    if stage.n_stages == 1:
        def plain(p):
            return sharding.gather_for_use(p, keep=("tensor",))

        full = _tree_map(plain, stacked_params)
        xin = x if compute_dtype is None else x.to(compute_dtype)
        y = stage_forward(block_fn, unstack(full, _n_layers(full)), xin)
        return y.to(x.dtype)
    layers = stage_layers(stacked_params, stage, axis)
    y, tail = run_stage(block_fn, layers, x, stage=stage,
                        num_microbatches=num_microbatches,
                        shards=_batch_shards(mesh, rules),
                        compute_dtype=compute_dtype)
    return from_last(y if stage.last else tail, x.shape, x.dtype, stage)
