"""Train and eval step factories.

Counterpart of determined_tpu/train/step.py. The JAX package jits forward,
backward and the optimizer update into one program per trial; PyTorch
runs eagerly, so a step here is the same sequence of calls (the CUDA
kernels and PyTorch's own) issued from the host without a sync.

Over a mesh of more than one device (data, fsdp, expert, context and
tensor axes), the params are DTensors (train/state.py) that the model
gathers before use; their gradients come back reduce-scattered over fsdp
and averaged over data and context (`parallel/sharding.gather_for_use`;
an MoE model's experts stay split over `expert`, ops/moe.py; a
tensor-split leaf keeps its own piece's gradient, and a replicated one is
already whole on every tensor rank through Megatron's f/g pair,
models/gpt2.py). Over `context` each rank's gradient is its own chunk's
loss's, once: the loss's mean over the group sums in the backward
(`collectives.sum_over`), and the average over the axis divides. The
global norm counts each shard once and each replica once, and the
reported loss and metrics are the means over every rank (an all-reduce;
the ranks of an expert, context or tensor group hold the same rows and
the same loss), as the JAX step's are over the global batch.

`make_multi_step` is the counterpart of the JAX package's `lax.scan` over
N steps in one executable: on CUDA one training step captured as a CUDA
graph and replayed N times, each batch copied into the graph's static
input buffers first.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from determined_tpu_torch.core._checkpoint import _map_tensors
from determined_tpu_torch.parallel import sharding
from determined_tpu_torch.parallel.sharding import LogicalRules
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.state import TrainState, extra_leaves

# loss_fn(params, batch, rng) -> scalar loss OR (loss, aux_metrics)
LossFn = Callable[..., Any]


def _call_loss(loss_fn: LossFn, params, batch, rng
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    out = loss_fn(params, batch, rng)
    if isinstance(out, tuple):
        loss, aux = out
    else:
        loss, aux = out, {}
    return loss, aux


def _is_sharded(mesh) -> bool:
    return mesh is not None and mesh.size() > 1


def _sharded_sq_sum(leaves: List[Any]):
    """The global sum of squares of sharded leaves from their local
    tensors: the local sums of the leaves sharded over the same mesh dims
    are all-reduced over those dims' groups (each shard counted once);
    replicated leaves count their local sum (each replica once)."""
    import torch.distributed as dist

    dims = [sharding.shard_mesh_dims(p) for p in leaves]
    meshes = [p.device_mesh for p in leaves if sharding.shard_mesh_dims(p)]

    def sq_sum(tensors):
        groups: Dict[Tuple[int, ...], List[torch.Tensor]] = {}
        for t, d in zip(tensors, dims):
            groups.setdefault(d, []).append(t)
        total = None
        for d, ts in groups.items():
            s = optim.sq_sum(ts).reshape(1)
            for i in d:
                dist.all_reduce(s, group=meshes[0].get_group(i))
            total = s if total is None else total + s
        return total.reshape(())

    return sq_sum


def global_mean(values: List[torch.Tensor], mesh=None) -> List[torch.Tensor]:
    """The mean over every rank of `mesh` of each fp32 scalar: one
    all-reduce over each of its dims above 1 (the mesh may span a prefix
    of the world, an elastic run's, whose other ranks stand by); without
    a mesh, one over the default group."""
    import torch.distributed as dist

    t = torch.stack([v.detach().float().reshape(()) for v in values])
    if mesh is None:
        dist.all_reduce(t)
        t /= dist.get_world_size()
        return list(t.unbind(0))
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(t, group=mesh.get_group(i))
    t /= mesh.size()
    return list(t.unbind(0))


def _step_fn(loss_fn: LossFn, tx: optim.GradientTransformation,
             stateful: bool, mesh):
    sharded = _is_sharded(mesh)

    def step(state: TrainState, batch: Any, rng: torch.Generator,
             hyper: Optional[torch.Tensor] = None):
        params = state.leaves()
        if stateful:
            loss, aux, new_extra = loss_fn(state.params, state.extra, batch,
                                           rng)
        else:
            loss, aux = _call_loss(loss_fn, state.params, batch, rng)
            new_extra = None
        loss = loss.float()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in aux.items()}
            if sharded:
                grads = optim.LocalShards(
                    [sharding.local_value(g) for g in grads],
                    _sharded_sq_sum(params))
                keys = [k for k, v in aux.items()
                        if isinstance(v, torch.Tensor)]
                loss, *vals = global_mean([loss] + [aux[k] for k in keys],
                                           mesh)
                aux.update(zip(keys, vals))
            gnorm = optim.global_norm(grads)
            # Divergence sentinel (train/health.py): grad_norm reduces over
            # every gradient leaf, so a NaN/Inf anywhere reaches it; one
            # logical-and over (loss, grad_norm) covers the whole step.
            all_finite = torch.logical_and(torch.isfinite(loss),
                                           torch.isfinite(gnorm))
            state.apply_gradients(grads, tx, new_extra, hyper=hyper)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "all_finite": all_finite.float(), **aux}
        return state, metrics

    return step


def make_train_step(loss_fn: LossFn, tx: optim.GradientTransformation,
                    stateful: bool = False, mesh=None):
    """Build `step(state, batch, rng) -> (state, metrics)`.

    Stateless (default): loss_fn(params, batch, rng) -> loss | (loss,
    metrics). Stateful (BatchNorm etc.): loss_fn(params, extra, batch, rng)
    -> (loss, metrics, new_extra); new_extra lands in state.extra.

    metrics always include `loss`, `grad_norm` (the global norm of the raw
    gradients, before any clipping in `tx`) and `all_finite`, as fp32
    device scalars: nothing here waits for the device. The state is
    updated in place and returned. With a `mesh` of more than one device
    the batch holds this rank's rows and the state is sharded
    (`create_train_state(mesh=...)`); the metrics are the global means.
    """
    step = _step_fn(loss_fn, tx, stateful, mesh)

    def train_step(state: TrainState, batch: Any, rng: torch.Generator):
        return step(state, batch, rng)

    return train_step


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    _map(tree, out.append)
    return out


class _MultiStep:
    """`multi_step(state, batches, rng) -> (state, window-mean metrics)`;
    see `make_multi_step`."""

    def __init__(self, step, tx, steps_per_call: int, sharded: bool):
        self._step = step
        self._tx = tx
        self.steps_per_call = steps_per_call
        self._sharded = sharded
        self.graph = None          # the captured step (CUDA)
        self._static = None        # the graph's input batch
        self._hyper = None         # the update's host floats, on the device
        self._hyper_all = None     # those of every step of a call
        self._acc = None           # the graph's metric sums
        self._keys: List[str] = []
        self._ptrs: List[int] = []
        self._graph_launches: Dict[str, int] = {}
        # Kernel launches the replays made: a replay does not pass through
        # the kernels' wrappers, so their own counters see only the
        # warm-up and capture calls.
        self.replayed_launches: Dict[str, int] = {}
        self.replays = 0

    def __call__(self, state: TrainState, batches: Any, rng):
        n = self.steps_per_call
        for leaf in _leaves(batches):
            if not hasattr(leaf, "shape") or len(leaf.shape) < 1 or \
                    leaf.shape[0] != n:
                raise ValueError(
                    f"every batch leaf needs a leading [steps_per_call={n}] "
                    f"axis; got {getattr(leaf, 'shape', type(leaf))}")
        device = sharding.local_value(state.leaves()[0]).device
        if device.type != "cuda":
            return self._eager(state, batches, rng)
        if self._sharded:
            raise NotImplementedError(
                "make_multi_step over a mesh of more than one process on "
                "CUDA: capturing the NCCL collectives of the sharded step in "
                "the graph is not ported (ROADMAP.md Queue 1 item 4)")
        if self._tx.hyper is None:
            raise ValueError(
                "make_multi_step on CUDA needs a transformation with "
                "`hyper` (train/optim.py) to replay its update")
        batches = _map(batches, lambda x: torch.as_tensor(x).to(
            device, non_blocking=True))
        start = 0
        if self.graph is None:
            self._capture(state, batches, rng)  # step 0 runs as warm-up
            start = 1
        else:
            self._check_state(state)
            self._acc.zero_()
        floats, opt = [], state.opt_state
        for _ in range(start, n):
            f, opt = self._tx.hyper(opt)
            floats.append(f)
        if floats:
            self._hyper_all[:len(floats)].copy_(
                torch.tensor(floats, dtype=torch.float32), non_blocking=True)
        for i in range(start, n):
            self._copy_batch(batches, i)
            self._hyper.copy_(self._hyper_all[i - start])
            self.graph.replay()
            self.replays += 1
            for k, v in self._graph_launches.items():
                self.replayed_launches[k] = \
                    self.replayed_launches.get(k, 0) + v
        state.opt_state = opt
        state.step += n - start
        means = (self._acc / n).unbind(0)
        return state, dict(zip(self._keys, means))

    def _eager(self, state, batches, rng):
        """The plain version: the same steps called one after another."""
        sums: Dict[str, torch.Tensor] = {}
        for i in range(self.steps_per_call):
            batch = _map(batches, lambda x: x[i])
            state, m = self._step(state, batch, rng)
            for k, v in m.items():
                v = torch.as_tensor(v).float()
                sums[k] = sums[k] + v if k in sums else v
        return state, {k: v / self.steps_per_call for k, v in sums.items()}

    def _copy_batch(self, batches, i: int) -> None:
        # On the current stream, which a prefetched batch's consumer has
        # already made wait for that batch's copy (data/prefetch.py).
        for dst, src in zip(_leaves(self._static), _leaves(batches)):
            dst.copy_(src[i], non_blocking=True)

    def _state_ptrs(self, state) -> List[int]:
        out: List[int] = []
        for t in state.leaves():
            out.append(sharding.local_value(t).data_ptr())
        _map_tensors(state.opt_state, lambda t: out.append(t.data_ptr()))
        out += [t.data_ptr() for t in extra_leaves(state.extra)]
        return out

    def _check_state(self, state) -> None:
        if self._state_ptrs(state) != self._ptrs:
            raise RuntimeError(
                "the train state's tensors are not the ones the multi step "
                "captured (a restore replaces them): build a new "
                "make_multi_step for the new state")

    def _capture(self, state, batches, rng) -> None:
        from determined_tpu_torch.ops import flash_attention as fa

        self._static = _map(batches, lambda x: torch.empty_like(x[0]))
        floats, _ = self._tx.hyper(state.opt_state)
        dev = self._static_device()
        self._hyper = torch.zeros(len(floats), dtype=torch.float32,
                                  device=dev)
        self._hyper_all = torch.zeros(
            (self.steps_per_call, len(floats)), dtype=torch.float32,
            device=dev)
        # Warm-up on a side stream, as capture requires: this is the
        # window's real step 0.
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._copy_batch(batches, 0)
            state, m = self._step(state, self._static, rng)
            self._keys = list(m)
            self._acc = torch.stack(
                [torch.as_tensor(m[k]).float().reshape(())
                 for k in self._keys])
        torch.cuda.current_stream(dev).wait_stream(side)
        self._ptrs = self._state_ptrs(state)
        counters = {"flash_fwd": fa.flash_fwd_cuda,
                    "flash_dq": fa.flash_dq_cuda,
                    "flash_dkv": fa.flash_dkv_cuda}
        before = {k: f.launches for k, f in counters.items()}
        # The capture runs the step's Python once more: its host
        # bookkeeping (the optimizer's count, `state.step`) is put back.
        opt, step = state.opt_state, state.step
        graph = torch.cuda.CUDAGraph()
        if isinstance(rng, torch.Generator) and rng.device.type == "cuda":
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    "this PyTorch cannot register a generator with a CUDA "
                    "graph; replaying its draws would repeat them")
            register(rng)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            _, m = self._step(state, self._static, rng, hyper=self._hyper)
            self._acc.add_(torch.stack(
                [torch.as_tensor(m[k]).float().reshape(())
                 for k in self._keys]))
        state.opt_state, state.step = opt, step
        self._graph_launches = {k: f.launches - before[k]
                                for k, f in counters.items()}
        self.graph = graph

    def _static_device(self) -> torch.device:
        return _leaves(self._static)[0].device


def make_multi_step(loss_fn: LossFn, tx: optim.GradientTransformation,
                    steps_per_call: int, mesh=None,
                    rules: Optional[LogicalRules] = None,
                    stateful: bool = False):
    """Build `multi_step(state, batches, rng) -> (state, metrics)` running
    `steps_per_call` optimizer steps per call, the JAX package's contract:
    every batch leaf has a leading `[steps_per_call, ...]` axis, and the
    metrics are the per-window mean of each scalar (`loss`, `grad_norm`,
    `all_finite`, aux).

    On CUDA the first call runs step 0 eagerly (the warm-up capture
    needs) and captures one step as a CUDA graph; every later step of
    that call and of the calls after it is a replay: the batch copied
    into the graph's static input buffers on the current stream (which a
    prefetched batch's consumer has made wait for its copy), the
    optimizer's host floats into a device buffer, then
    `CUDAGraph.replay()`. Nothing in the step syncs with the host. The
    state's tensors must stay the ones captured (a restore replaces them:
    build a new multi step then). On the CPU it runs the same steps
    eagerly: the plain version. A mesh over more than one process on CUDA
    raises (ROADMAP.md Queue 1 item 4): the port does not capture NCCL
    collectives yet. `rules` is the JAX package's argument, kept for its
    signature: a rank's batch already holds only its rows
    (`step_input_shardings`), so there is nothing to constrain.
    `stateful`: `loss_fn` takes and returns the state's `extra`, as in
    `make_train_step`; each replay writes the new values into the same
    buffers (`TrainState.apply_gradients`), so replay N reads replay
    N - 1's (BatchNorm's running stats)."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    step = _step_fn(loss_fn, tx, stateful, mesh)
    return _MultiStep(step, tx, steps_per_call, _is_sharded(mesh))


def batch_placements(mesh, rules: Optional[LogicalRules] = None,
                     leading_dims: int = 1) -> list:
    """The DTensor placements of a global batch over `mesh`: its batch
    dim (dim 1 under a `[steps, batch, ...]` window) split over the
    batch rule's axes, ("data", "fsdp") by default, in that order. A
    rank's loader yields the rows this places on it: rank r of the
    (data, fsdp) grid holds the r-th block of rows
    (`make_array_from_process_local_data`'s counterpart)."""
    rules = rules or LogicalRules()
    axes = rules.mesh_axes("batch")
    spec = [None] * (leading_dims - 1) + [axes]
    return sharding.spec_to_placements(spec, mesh.mesh_dim_names)


def step_input_shardings(mesh, rules: Optional[LogicalRules] = None,
                         batch: Any = None, leading_dims: int = 1) -> Any:
    """The step's batch placements, one source for the loader and the
    step (the JAX package's pre-partitioned input contract): without
    `batch` the batch-dim placements; with an example `batch`, a matching
    per-leaf tree in which leaves of rank below `leading_dims` replicate."""
    from torch.distributed.tensor import Replicate

    sharded = batch_placements(mesh, rules, leading_dims)
    if batch is None:
        return sharded

    def leaf(x):
        if getattr(x, "ndim", 0) < leading_dims:
            return [Replicate()] * mesh.ndim
        return sharded

    return _map(batch, leaf)


def make_eval_step(eval_fn: Callable[..., Dict[str, Any]],
                   stateful: bool = False):
    """Build `eval_step(state, batch) -> metrics` (per-batch sums/means),
    run without autograd. Stateless: eval_fn(params, batch); stateful:
    eval_fn(params, extra, batch)."""

    def step(state: TrainState, batch: Any):
        with torch.no_grad():
            if stateful:
                return eval_fn(state.params, state.extra, batch)
            return eval_fn(state.params, batch)

    return step
