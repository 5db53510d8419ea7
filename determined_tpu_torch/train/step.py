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
already whole on every tensor rank through Megatron's f/g pair and
gather, models/gpt2.py and the conv models). Over `context` each rank's
gradient is its own chunk's loss's, once: the loss's mean over the group
sums in the backward (`collectives.sum_over`), and the average over the
axis divides. A model that names no "seq" axis (MNIST, ResNet, the
diffusion UNet) computes replicated over `context`: the group's ranks
hold the same rows, so their gradients are equal and the average over
the axis leaves them as they are. The ranks of a tensor or context group
must draw the same random numbers (the diffusion loss's timesteps and
noise): the Trainer seeds every rank's step generator with `seed + 1`
(train/trainer.py). The
global norm counts each shard once and each replica once, and the
reported loss and metrics are the means over every rank (an all-reduce;
the ranks of an expert, context or tensor group hold the same rows and
the same loss), as the JAX step's are over the global batch.

`make_multi_step` is the counterpart of the JAX package's `lax.scan` over
N steps in one executable: on CUDA one training step captured as a CUDA
graph and replayed N times, each batch copied into the graph's static
input buffers first. Over a mesh of several processes each rank captures
its own sharded step, NCCL collectives included, and the ranks replay
their graphs in lockstep: every collective is a kernel node of the graph
on the NCCL stream, so replay k of one rank meets replay k of the others
on the card, with no host in between. The warm-up step 0 runs before the
capture and creates every communicator the step uses (the mesh groups'
and the per-pair ones that P2P creates at first use), which a capture
cannot. How each axis's collectives enter the graph:

  - data, fsdp: `sharding.gather_for_use`'s DTensor `redistribute` to
    `Replicate` (a functional all-gather and its `wait_tensor`, or, with
    `overlap_allgather`, an AsyncCollectiveTensor waited on at first use)
    and its backward reduce-scatter or all-reduce; `_sharded_sq_sum`'s
    and `global_mean`'s all-reduces;
  - tensor: Megatron's f/g and gathers (`parallel/collectives.py`), the
    vocab-split logits' functional all-gather (`models/gpt2.py`);
  - context: the ring's `batch_isend_irecv` pairs (ops/ring_attention.py)
    or Ulysses' functional all-to-alls (ops/ulysses.py), and the loss's
    `sum_over`;
  - expert: the routing's count all-gather (ops/moe.py) besides f/g;
  - pipeline: the stages' blocking sends and receives
    (parallel/pipeline.py), in one order on every replay.

A step that reads a device value on the host could not be captured; none
does (tests/test_torch_multi_step_mesh.py holds each axis to that, and
to one sequence of collectives every step).

`make_captured_step` is the counterpart of the JAX package's jitted train
step, `Trainer.fit`'s step on one card or on each rank of a mesh: one
CUDA graph a tuple of batch-leaf shapes, captured at the first batch of
those shapes and replayed for every later one, all graphs over the same
state tensors and one memory pool. `make_captured_eval_step` is the
jitted eval step's counterpart, the same over the eval function (no
autograd, no rng, no optimizer). `_Capture` is the capture core all
three share (warm-up on a side stream, the optimizer's floats through a
device tensor, the rng registered with the graph, the host bookkeeping
put back). Over a mesh every call of a captured step is agreed on first
(`_agree`, one gloo all-reduce a call): every rank refuses it, or
captures, or replays the same graph. A graph that holds collectives is
released before its process group is destroyed: NCCL's destroy waits for
every such graph to be gone (`parallel/mesh.release_graphs`).
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from determined_tpu_torch.core._checkpoint import _map_tensors
from determined_tpu_torch.parallel import mesh as mesh_lib
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


def _paths(tree: Any, prefix: str = "") -> List[str]:
    """Each leaf's key path, in `_leaves` order: a batch's structure."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


def _state_ptrs(state) -> List[int]:
    """The addresses of every tensor of the state: a CUDA graph reads and
    writes these, so a path that replaces one would leave a replay
    working on memory the state no longer holds."""
    out: List[int] = []
    for t in state.leaves():
        out.append(sharding.local_value(t).data_ptr())
    _map_tensors(state.opt_state, lambda t: out.append(t.data_ptr()))
    out += [t.data_ptr() for t in extra_leaves(state.extra)]
    return out


def _flash_counters() -> Dict[str, Any]:
    from determined_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd_cuda, "flash_dq": fa.flash_dq_cuda,
            "flash_dkv": fa.flash_dkv_cuda}


class _Capture:
    """One training step captured as a CUDA graph over the graph's own
    input buffers: the capture core of `make_multi_step` and of
    `make_captured_step`.

    `warm_up` runs a real step eagerly on a side stream, as capture
    requires (the kernels loaded, the allocator warm, every communicator
    made), from the input buffers. `capture` then records the same step
    with the optimizer's host floats read from a device tensor
    (`GradientTransformation.hyper`), `epilogue(metrics)` appended, the
    rng (a CUDA generator) registered with the graph, so that each replay
    draws what an eager step would draw from the generator's state at
    that time (a `manual_seed` in between included), and puts back the
    host bookkeeping the recording advanced (`state.step`, the
    optimizer's count). Several captures may share one memory `pool`:
    each keeps its outputs alive, so replays of any of them may follow
    one another in any order on one stream. `load` and the replays run
    on the current stream. An eval step has no `tx` (no floats) and no
    rng."""

    def __init__(self, step, tx, batch: Any, pool=None):
        self._step, self._tx, self._pool = step, tx, pool
        self.static = _map(batch, torch.empty_like)  # the input buffers
        self.device = _leaves(self.static)[0].device
        self.hyper: Optional[torch.Tensor] = None  # the update's floats
        self.graph = None
        self.outputs: Dict[str, Any] = {}  # the recorded step's metrics
        self.launches: Dict[str, int] = {}  # flash launches it holds
        self.rng = None

    def load(self, batch: Any, floats: Optional[List[float]] = None
             ) -> None:
        # On the current stream, which a prefetched batch's consumer has
        # already made wait for that batch's copy (data/prefetch.py).
        for dst, src in zip(_leaves(self.static), _leaves(batch)):
            dst.copy_(src, non_blocking=True)
        if floats is not None:
            self.hyper.copy_(torch.tensor(floats, dtype=torch.float32),
                             non_blocking=True)

    def warm_up(self, state, batch: Any, rng) -> Dict[str, Any]:
        """One real step from `batch` (through the input buffers), eager,
        on a side stream; -> its metrics."""
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.load(batch)
            _, metrics = self._step(state, self.static, rng)
        torch.cuda.current_stream(self.device).wait_stream(side)
        return metrics

    def capture(self, state, rng, epilogue=None) -> None:
        if self._tx is not None:
            floats, _ = self._tx.hyper(state.opt_state)
            self.hyper = torch.zeros(len(floats), dtype=torch.float32,
                                     device=self.device)
        counters = _flash_counters()
        before = {k: f.launches for k, f in counters.items()}
        opt, step = state.opt_state, state.step
        graph = torch.cuda.CUDAGraph()
        if isinstance(rng, torch.Generator) and rng.device.type == "cuda":
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    "this PyTorch cannot register a generator with a CUDA "
                    "graph; replaying its draws would repeat them")
            register(rng)
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            _, metrics = self._step(state, self.static, rng,
                                    hyper=self.hyper)
            if epilogue is not None:
                epilogue(metrics)
        state.opt_state, state.step = opt, step
        self.outputs = metrics
        self.launches = {k: f.launches - before[k]
                         for k, f in counters.items()}
        self.graph, self.rng = graph, rng

    def replay(self) -> None:
        if self.graph is None:
            raise RuntimeError(
                "this step's CUDA graph was released when the process group "
                "its collectives ran over was destroyed; build the step "
                "again over a live group")
        self.graph.replay()

    def release(self) -> None:
        """Destroy the graph (parallel/mesh.release_graphs)."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


def _stale_state(what: str, remedy: str) -> RuntimeError:
    return RuntimeError(
        f"the train state's tensors are not the ones {what} captured (a "
        f"restore replaces them): {remedy}")


class _MultiStep:
    """`multi_step(state, batches, rng) -> (state, window-mean metrics)`;
    see `make_multi_step`."""

    def __init__(self, step, tx, steps_per_call: int, mesh):
        self._step = step
        self._tx = tx
        self.steps_per_call = steps_per_call
        self._mesh = mesh if _is_sharded(mesh) else None
        self._cap: Optional[_Capture] = None  # the captured step (CUDA)
        self._hyper_all = None     # the update floats of every step of a call
        self._acc = None           # the graph's metric sums
        self._keys: List[str] = []
        self._ptrs: List[int] = []
        # Kernel launches the replays made: a replay does not pass through
        # the kernels' wrappers, so their own counters see only the
        # warm-up and capture calls.
        self.replayed_launches: Dict[str, int] = {}
        self.replays = 0

    @property
    def graph(self):
        return None if self._cap is None else self._cap.graph

    @property
    def _graph_launches(self) -> Dict[str, int]:
        return {} if self._cap is None else self._cap.launches

    def __call__(self, state: TrainState, batches: Any, rng):
        n = self.steps_per_call
        device = sharding.local_value(state.leaves()[0]).device
        refusal = self._refusal(state, batches, device)
        if self._mesh is not None:
            # Over several processes every rank refuses, or none does: a
            # rank that raised while the others replayed would leave them
            # waiting in the graph's collectives.
            refusal = _agree(self._mesh, refusal, "make_multi_step call")
        if refusal is not None:
            raise refusal[0](refusal[1])
        if device.type != "cuda":
            return self._eager(state, batches, rng)
        batches = _map(batches, lambda x: torch.as_tensor(x).to(
            device, non_blocking=True))
        start = 0
        if self._cap is None:
            self._capture(state, batches, rng)  # step 0 runs as warm-up
            start = 1
        else:
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
            self._cap.hyper.copy_(self._hyper_all[i - start])
            self._cap.replay()
            self.replays += 1
            for k, v in self._cap.launches.items():
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
        self._cap.load(_map(batches, lambda x: x[i]))

    def _refusal(self, state, batches, device):
        """Why this call cannot run, as (exception type, message), or
        None."""
        n = self.steps_per_call
        for leaf in _leaves(batches):
            if not hasattr(leaf, "shape") or len(leaf.shape) < 1 or \
                    leaf.shape[0] != n:
                return ValueError, (
                    f"every batch leaf needs a leading [steps_per_call={n}] "
                    f"axis; got {getattr(leaf, 'shape', type(leaf))}")
        if device.type != "cuda":
            return None
        if self._tx.hyper is None:
            return ValueError, (
                "make_multi_step on CUDA needs a transformation with "
                "`hyper` (train/optim.py) to replay its update")
        if self._cap is None:
            return None
        shapes = [tuple(x.shape[1:]) for x in _leaves(batches)]
        static = [tuple(x.shape) for x in _leaves(self._cap.static)]
        if shapes != static:
            return ValueError, (
                f"the batch's shapes {shapes} (a step's) are not the "
                f"captured step's {static}")
        if _state_ptrs(state) != self._ptrs:
            err = _stale_state("the multi step", "build a new "
                               "make_multi_step for the new state")
            return type(err), str(err)
        return None

    def _capture(self, state, batches, rng) -> None:
        cap = _Capture(self._step, self._tx, _map(batches, lambda x: x[0]))
        metrics = cap.warm_up(state, _map(batches, lambda x: x[0]), rng)
        self._keys = list(metrics)
        self._acc = torch.stack([torch.as_tensor(metrics[k]).float()
                                 .reshape(()) for k in self._keys])
        self._hyper_all = torch.zeros(
            (self.steps_per_call, len(self._tx.hyper(state.opt_state)[0])),
            dtype=torch.float32, device=cap.device)
        self._ptrs = _state_ptrs(state)

        def accumulate(m):
            self._acc.add_(torch.stack(
                [torch.as_tensor(m[k]).float().reshape(())
                 for k in self._keys]))

        cap.capture(state, rng, epilogue=accumulate)
        if self._mesh is not None:
            mesh_lib.hold_graph(cap)
        self._cap = cap


# A batch's leaf shapes in a vote (`_agree`): (ndim + 1, dims...) a leaf.
_VOTE_SHAPE_INTS = 32


def _vote_row(refused: bool, key, known: bool) -> torch.Tensor:
    """This rank's row of a vote: [refused, the key's digest, 0 without a
    key else 1 + known, the key's shapes]. `key`: the batch's (path,
    shape, dtype) a leaf, the same on every rank for the same batch."""
    row = torch.zeros(3 + _VOTE_SHAPE_INTS, dtype=torch.int64)
    row[0] = int(refused)
    if key is not None:
        digest = hashlib.blake2b(repr(key).encode(), digest_size=7).digest()
        row[1] = int.from_bytes(digest, "big")
        row[2] = 1 + int(known)
        ints = [n for _, shape, _ in key for n in (len(shape) + 1, *shape)]
        ints = ints[:_VOTE_SHAPE_INTS]
        row[3:3 + len(ints)] = torch.tensor(ints, dtype=torch.int64)
    return row


def _vote_shapes(row: torch.Tensor) -> List[tuple]:
    ints, shapes, i = row[3:].tolist(), [], 0
    while i < len(ints) and ints[i] > 0:
        n = ints[i] - 1
        shapes.append(tuple(ints[i + 1:i + 1 + n]))
        i += 1 + n
    return shapes


def _agree(mesh, refusal, what: str, key=None, known: bool = False):
    """This rank's refusal, or else the first refusing rank's, on every
    rank of `mesh`, and with a batch `key` (its (path, shape, dtype) a
    leaf) also a refusal when the ranks' keys differ, or when some ranks
    have a graph for the key and others have not: one all-reduce of a row
    a rank over the mesh's control group (gloo, host memory: nothing
    waits on the card). So every rank refuses a call or none does, and
    every rank captures, or replays, the same shapes' graph."""
    import torch.distributed as dist

    group = mesh_lib.control_group(mesh)
    me = dist.get_rank(group)
    votes = torch.zeros((dist.get_world_size(group), 3 + _VOTE_SHAPE_INTS),
                        dtype=torch.int64)
    votes[me] = _vote_row(refusal is not None, key, known)
    dist.all_reduce(votes, group=group)
    if refusal is not None:
        return refusal
    refused = votes[:, 0].nonzero()
    if len(refused):
        return RuntimeError, (
            f"rank {int(refused[0])} of the mesh refused this {what} (its "
            "error says why); every rank refuses it")
    if key is None:
        return None
    if bool((votes[:, 1] != votes[me, 1]).any()):
        shapes = "; ".join(f"rank {r}: {_vote_shapes(row)}"
                           for r, row in enumerate(votes))
        return ValueError, (
            f"the ranks' batches differ ({shapes}): every rank of the mesh "
            f"runs one graph for a batch's shapes, so a {what} needs the "
            "same shapes on every rank (a global batch split unevenly, a "
            "ragged last one, is one cause)")
    if bool((votes[:, 2] != votes[me, 2]).any()):
        have = [r for r, v in enumerate(votes[:, 2].tolist()) if v == 2]
        return RuntimeError, (
            f"ranks {have} of the mesh hold a graph for this batch's shapes "
            f"and the others none: this {what} would capture on some "
            "ranks while the others replay")
    return None


class _CapturedStep:
    """`step(state, batch, rng) -> (state, metrics)`; see
    `make_captured_step`."""

    def __init__(self, step, tx, mesh=None, what: str = "captured step"):
        self._step = step
        self._tx = tx
        self._mesh = mesh if _is_sharded(mesh) else None
        self._what = what
        self.graphs: Dict[tuple, _Capture] = {}  # by the batch's shapes
        self._pool = None   # the graphs' shared memory pool
        self._ptrs: Optional[List[int]] = None
        # The plain version's outputs by the batch's shapes (`_kept`).
        self._outputs: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def __call__(self, state: TrainState, batch: Any, rng=None):
        device = sharding.local_value(state.leaves()[0]).device
        refusal, key = self._refusal(state, batch, rng, device)
        cap = self.graphs.get(key)
        if self._mesh is not None:
            # Over several processes every rank refuses, or none does, and
            # every rank captures, or replays, the same shapes: a rank
            # that raised, captured or replayed alone would leave the
            # others waiting in the graph's collectives.
            refusal = _agree(
                self._mesh, refusal, f"{self._what} call",
                None if key is None else tuple(k[:3] for k in key),
                cap is not None)
        if refusal is not None:
            raise refusal[0](refusal[1])
        if device.type != "cuda":
            return self._plain(state, batch, rng)
        if cap is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            cap = _Capture(self._step, self._tx, batch, self._pool)
            metrics = cap.warm_up(state, batch, rng)
            cap.capture(state, rng)
            if self._mesh is not None:
                mesh_lib.hold_graph(cap)
            self.graphs[key] = cap
            return self._out(state, metrics)
        return self._replay(cap, state, batch)

    def _replay(self, cap: _Capture, state, batch):
        floats, opt = self._tx.hyper(state.opt_state)
        cap.load(batch, floats)
        cap.replay()
        state.opt_state = opt
        state.step += 1
        return state, dict(cap.outputs)

    def _refusal(self, state, batch, rng, device):
        """(why this call cannot run, as (exception type, message), or
        None; the batch's key: (path, shape, dtype, device) a leaf, or
        None)."""
        leaves = _leaves(batch)
        for leaf in leaves:
            if not isinstance(leaf, torch.Tensor):
                return (TypeError, (
                    "a captured step takes a batch of tensors only (a graph "
                    f"would hold the value of a {type(leaf).__name__} "
                    "leaf); make it a tensor")), None
        key = tuple((path, tuple(x.shape), x.dtype, x.device)
                    for path, x in zip(_paths(batch), leaves))
        ptrs = _state_ptrs(state)
        if self._ptrs is None:
            self._ptrs = ptrs
        elif ptrs != self._ptrs:
            err = _stale_state("the step", "restore into the live state "
                               "(`restore_state(..., into=True)`)")
            return (type(err), str(err)), key
        cap = self.graphs.get(key)
        if device.type == "cuda" and cap is not None and rng is not cap.rng:
            return (ValueError, (
                "the rng is not the generator the captured step registered "
                "(its replays draw from that one): pass the same generator "
                "at every step")), key
        return None, key

    def _out(self, state, metrics):
        return state, metrics

    def _plain(self, state, batch, rng):
        """The plain version: the step the graph holds, called eagerly,
        the optimizer's floats passed as a tensor as a replay reads
        them."""
        floats, _ = self._tx.hyper(state.opt_state)
        state, metrics = self._step(
            state, batch, rng, hyper=torch.tensor(floats, dtype=torch.float32))
        return state, self._kept(batch, metrics)

    def _kept(self, batch, metrics):
        """`metrics` written into tensors kept for the batch's shapes, as a
        replay writes its graph's outputs: the next call of those shapes
        overwrites them, on the CPU as on the card."""
        key = tuple((path, tuple(x.shape)) for path, x in
                    zip(_paths(batch), _leaves(batch)))
        outputs = self._outputs.setdefault(key, {})
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                if k not in outputs:
                    outputs[k] = torch.empty_like(v)
                metrics[k] = outputs[k].copy_(v)
        return metrics

    def release(self) -> None:
        """Destroy every graph (a resize drops the step with its state)."""
        for cap in self.graphs.values():
            cap.release()


class _CapturedEvalStep(_CapturedStep):
    """`eval_step(state, batch) -> metrics`; see
    `make_captured_eval_step`."""

    def __init__(self, step, mesh=None):
        super().__init__(step, None, mesh, what="captured eval step")

    def __call__(self, state: TrainState, batch: Any):
        return super().__call__(state, batch, None)

    def _out(self, state, metrics):
        return metrics

    def _replay(self, cap: _Capture, state, batch):
        cap.load(batch)
        cap.replay()
        return dict(cap.outputs)

    def _plain(self, state, batch, rng):
        return self._kept(batch, self._step(state, batch)[1])


def make_captured_step(loss_fn: LossFn, tx: optim.GradientTransformation,
                       stateful: bool = False, mesh=None):
    """Build `step(state, batch, rng) -> (state, metrics)`, the counterpart
    of the JAX package's jitted train step: `Trainer.fit`'s step, on one
    card or on each rank of a mesh. The same contract as
    `make_train_step`.

    On CUDA the first call with a batch of new shapes runs that step
    eagerly (the warm-up capture needs) and captures it as a CUDA graph;
    every later call with those shapes copies the batch into the graph's
    input buffers and the optimizer's host floats into a device tensor
    (`tx.hyper`), on the current stream, and replays it: one graph a
    tuple of batch-leaf shapes (a bucket, a ragged last batch), all over
    the same state tensors and one memory pool, as the JAX step retraces
    a new shape. The metrics a replay returns are the graph's output
    tensors: the next replay of that graph overwrites them. Nothing syncs
    with the host. The rng, a CUDA generator, is registered with each
    graph: every call must pass that same generator, and a replay draws
    from its state at the time, a `manual_seed` in between included.

    With a `mesh` of several processes each rank captures its sharded
    step with its collectives (as `make_multi_step` does; the module
    docstring lists them by axis), and every call is agreed on first
    (`_agree`: one gloo all-reduce in host memory): a call that one rank
    refuses is refused on every rank, and the ranks' batches must have
    the same shapes (else every rank raises, naming them), so every rank
    captures, or replays, the same graph at the same call. The graphs
    are released before the process group is destroyed
    (`DistributedContext.shutdown`).

    The state's tensors must stay the ones of the first call: a call on a
    state whose tensors were replaced raises (a restore writes into the
    live state instead, `restore_state(..., into=True)`), on the CPU too.
    On the CPU the step runs eagerly, its plain version: the step the
    graph holds, with the floats as a tensor, with the same vote over a
    mesh. `tx` must have `hyper`."""
    if tx.hyper is None:
        raise ValueError(
            "make_captured_step needs a transformation with `hyper` "
            "(train/optim.py) to replay its update")
    return _CapturedStep(_step_fn(loss_fn, tx, stateful, mesh), tx, mesh)


def make_captured_eval_step(eval_fn: Callable[..., Dict[str, Any]],
                            stateful: bool = False, mesh=None):
    """Build `eval_step(state, batch) -> metrics`, the counterpart of the
    JAX package's jitted eval step: `make_eval_step`'s function, on CUDA
    one CUDA graph a tuple of batch-leaf shapes, captured at the first
    batch of those shapes and replayed for every later one (no autograd,
    no rng, no optimizer). The metrics a replay returns are the graph's
    output tensors, which the next replay of that graph overwrites: a
    caller that keeps them across calls copies or adds them first. Over
    a `mesh` of several processes every call is agreed on as the train
    step's are (`make_captured_step`): the forward issues collectives. On
    the CPU the plain version, whose outputs are kept likewise."""
    fn = make_eval_step(eval_fn, stateful)

    def step(state, batch, rng=None, hyper=None):
        return state, fn(state, batch)

    return _CapturedEvalStep(step, mesh)


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
    eagerly: the plain version; a CUDA state never takes that route.

    With a `mesh` over several processes (the DeviceMesh `Trainer` or
    `core.init()` made, one rank a card) each rank captures its sharded
    step, its NCCL collectives included (the module docstring lists them
    by axis), and replays it as many times as every other rank, in the
    same order: a replay's collectives meet the peers' on the card. The
    window's metrics are the global means, as `make_train_step`'s. A call
    that one rank refuses (the batch's leading axis or shapes, a state
    whose tensors are not the captured ones, a `tx` without `hyper`) is
    refused on every rank before any replays (one gloo all-reduce a
    call), so no rank is left waiting in a collective. The rng, a CUDA
    generator, is registered with the graph: the ranks of a tensor or
    context group keep drawing the same numbers.

    `rules` is the JAX package's argument, kept for its signature: a
    rank's batch already holds only its rows (`step_input_shardings`), so
    there is nothing to constrain.
    `stateful`: `loss_fn` takes and returns the state's `extra`, as in
    `make_train_step`; each replay writes the new values into the same
    buffers (`TrainState.apply_gradients`), so replay N reads replay
    N - 1's (BatchNorm's running stats)."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    step = _step_fn(loss_fn, tx, stateful, mesh)
    return _MultiStep(step, tx, steps_per_call, mesh)


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
