"""Train state, on one device or sharded over a DeviceMesh.

Counterpart of determined_tpu/train/state.py: one object carrying step,
params, opt_state and the non-gradient `extra`. The JAX package donates
the state to its jitted step so XLA reuses the buffers; here the step
updates the parameters and the optimizer's moment buffers in place
(`apply_gradients`), which keeps one copy of each on the device the same
way. `step` and the optimizer counts are host integers.

Sharded (a mesh with axes above 1): each param leaf is a DTensor laid out
by the spec its logical axes resolve to (`param_specs`, the JAX
package's, over `parallel/sharding.py`'s rules), and each rank holds its
shard: for GPT-2 under the default rules, `Shard` along the "embed" dim
on the fsdp axis and replicated over data. The optimizer works on the
local tensors (`LocalShards`), so its moments are local shards that
mirror their leaves (`_mirrors` says which leaf each mirrors).
Checkpoints hold the full state (`unshard_state`, a collective): a run
with fsdp=2 writes what a one-process run writes, and either restores
the other's (`reshard_state`, no collective).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch

from determined_tpu_torch.models.gpt2 import _flatten, _unflatten
from determined_tpu_torch.parallel import sharding
from determined_tpu_torch.parallel.sharding import LogicalRules, PartitionSpec
from determined_tpu_torch.train import optim


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any
    # Non-gradient mutable collections (e.g. BatchNorm running stats). None
    # for purely functional models.
    extra: Any = None

    def leaves(self) -> List[torch.Tensor]:
        """The param leaves in a fixed order (the `/`-joined key paths of a
        nested dict, or the tensor itself): what the optimizer state
        mirrors. DTensors when the state is sharded."""
        return param_leaves(self.params)

    def apply_gradients(self, grads: List[torch.Tensor],
                        tx: optim.GradientTransformation,
                        new_extra: Any = None,
                        hyper: Optional[torch.Tensor] = None
                        ) -> "TrainState":
        """One optimizer update, in place: `grads` (ordered as `leaves()`,
        the local tensors of sharded leaves in a `LocalShards`) become the
        updates and are added into the params' local tensors. `hyper`: the
        update's host floats as a device tensor (a replayed step,
        `optim.GradientTransformation.hyper`)."""
        with torch.no_grad():
            params = [sharding.local_value(p) for p in self.leaves()]
            if not isinstance(grads, optim.LocalShards):
                grads = list(grads)
            kwargs = {} if hyper is None else {"hyper": hyper}
            updates, self.opt_state = tx.update(grads, self.opt_state,
                                                params, **kwargs)
            optim.apply_updates(params, updates)
        self.step += 1
        if new_extra is not None:
            self.extra = new_extra
        return self


def param_leaves(params: Any) -> List[torch.Tensor]:
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return list(_flatten(params).values())
    return [p for p in params]


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree if tree.device == device else tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


# ------------------------------------------------------------ specs


def param_specs(param_logical_axes: Any,
                rules: Optional[LogicalRules] = None) -> Any:
    """Tree of PartitionSpec matching a params tree of logical-axis tuples."""
    rules = rules or LogicalRules()
    if isinstance(param_logical_axes, dict):
        return {k: param_specs(v, rules)
                for k, v in param_logical_axes.items()}
    return rules.spec(param_logical_axes)


def _lookup_axes(param_logical_axes: Any, path: str) -> Optional[tuple]:
    """Logical-axis tuple at `path` (a `/`-joined key path) or None."""
    node = param_logical_axes
    for key in path.split("/"):
        if isinstance(node, dict) and key in node:
            node = node[key]
        else:
            return None
    return node if isinstance(node, tuple) else None


def aligned_param_specs(params: Any, param_logical_axes: Any,
                        rules: Optional[LogicalRules] = None) -> Any:
    """PartitionSpecs with the structure of the ACTUAL params tree.

    `param_logical_axes` is a *partial* annotation: leaves it matches (by
    key path) get their logical spec, everything else replicates, as in
    the JAX package."""
    rules = rules or LogicalRules()
    if not isinstance(params, dict):
        return PartitionSpec()
    flat = {}
    for path in _flatten(params):
        axes = _lookup_axes(param_logical_axes, path)
        flat[path] = rules.spec(axes) if axes is not None else PartitionSpec()
    return _unflatten(flat)


def _mirrors(opt_state: Any, locals_: List[torch.Tensor]):
    """Yield (tensor, leaf index or None) for every tensor of `opt_state`:
    a list of len(leaves) whose i-th tensor has leaf i's local shape and
    dtype mirrors the leaves (Adam's mu and nu); anything else (counts,
    scalars) is replicated."""
    if isinstance(opt_state, torch.Tensor):
        yield opt_state, None
    elif isinstance(opt_state, dict):
        for v in opt_state.values():
            yield from _mirrors(v, locals_)
    elif isinstance(opt_state, (list, tuple)):
        if len(opt_state) == len(locals_) and all(
                isinstance(t, torch.Tensor) and t.shape == p.shape
                and t.dtype == p.dtype for t, p in zip(opt_state, locals_)):
            yield from ((t, i) for i, t in enumerate(opt_state))
        else:
            for v in opt_state:
                yield from _mirrors(v, locals_)


def _map_opt(opt_state: Any, locals_: List[torch.Tensor], fn) -> Any:
    """`opt_state` with each tensor t replaced by fn(t, leaf index or
    None), in `_mirrors`' reading."""
    pairs = {id(t): i for t, i in _mirrors(opt_state, locals_)}

    def walk(node):
        if isinstance(node, torch.Tensor):
            return fn(node, pairs.get(id(node)))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(opt_state)


def is_sharded(state: TrainState) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in state.leaves())


def unshard_state(state: TrainState) -> TrainState:
    """The full state on every rank, as plain tensors: each sharded leaf
    and each moment that mirrors one all-gathered (a collective: every
    rank calls it), everything else as it is. What a checkpoint holds."""
    from torch.distributed.tensor import DTensor

    leaves = state.leaves()
    locals_ = [sharding.local_value(p) for p in leaves]

    def moment(t, i):
        p = leaves[i] if i is not None else None
        if not isinstance(p, DTensor):
            return t.detach()
        d = DTensor.from_local(t, p.device_mesh, p.placements,
                               run_check=False, shape=p.shape,
                               stride=p.stride())
        return d.full_tensor()

    params = _rebuild(state.params, [sharding.full_value(p) for p in leaves])
    return TrainState(step=state.step, params=params,
                      opt_state=_map_opt(state.opt_state, locals_, moment),
                      extra=state.extra)


def reshard_state(full: TrainState, like: TrainState) -> TrainState:
    """`full` (plain tensors, the same on every rank: a checkpoint read)
    laid out as `like`: each leaf of a sharded `like` becomes this rank's
    piece of the full leaf, each moment that mirrors it likewise. No
    collective. Leaves of `like` that are plain tensors are taken as they
    are."""
    from torch.distributed.tensor import DTensor

    like_leaves = like.leaves()
    full_leaves = full.leaves()
    like_locals = [sharding.local_value(p) for p in like_leaves]
    full_locals = [p.detach() for p in full_leaves]
    params = []
    for p, f in zip(like_leaves, full_leaves):
        if isinstance(p, DTensor):
            d = sharding.distribute_full(f.detach(), p.device_mesh,
                                         p.placements)
            params.append(d.requires_grad_(p.requires_grad))
        else:
            params.append(f)
    opt_like = list(_mirrors(like.opt_state, like_locals))
    full_idx = {id(t): i for t, i in _mirrors(full.opt_state, full_locals)}

    def moment(t, i):
        if i is None:
            return t
        p = like_leaves[i]
        if not isinstance(p, DTensor):
            return t
        return sharding.distribute_full(t, p.device_mesh,
                                        p.placements)._local_tensor

    if len(opt_like) != len(full_idx):
        raise ValueError("checkpoint and state optimizer structures differ")
    return TrainState(step=full.step, params=_rebuild(like.params, params),
                      opt_state=_map_opt(full.opt_state, full_locals, moment),
                      extra=full.extra)


def full_template(state: TrainState) -> TrainState:
    """A state with `state`'s structure, devices, dtypes and requires_grad,
    whose tensors have the full shapes of the leaves (uninitialised): the
    template a sharded state restores a checkpoint into."""
    from torch.distributed.tensor import DTensor

    leaves = state.leaves()
    locals_ = [sharding.local_value(p) for p in leaves]

    def empty(t, shape):
        return torch.empty(shape, dtype=t.dtype, device=t.device
                           ).requires_grad_(t.requires_grad)

    params = _rebuild(state.params, [
        empty(sharding.local_value(p), p.shape).requires_grad_(
            p.requires_grad) for p in leaves])

    def moment(t, i):
        p = leaves[i] if i is not None else None
        return empty(t, p.shape) if isinstance(p, DTensor) else t

    return TrainState(step=state.step, params=params,
                      opt_state=_map_opt(state.opt_state, locals_, moment),
                      extra=state.extra)


def _rebuild(params: Any, leaves: List[torch.Tensor]) -> Any:
    """`params`' structure with `leaves` (in `param_leaves` order)."""
    if isinstance(params, torch.Tensor):
        return leaves[0]
    if isinstance(params, dict):
        return _unflatten(dict(zip(_flatten(params), leaves)))
    return type(params)(leaves)


def create_train_state(
    init_fn: Callable[[torch.Generator], Any],
    tx: optim.GradientTransformation,
    generator: torch.Generator,
    device: Optional[torch.device] = None,
    extra: Any = None,
    mesh: Any = None,
    param_logical_axes: Optional[Any] = None,
    rules: Optional[LogicalRules] = None,
) -> TrainState:
    """Initialise a TrainState on `device`: the params from `init_fn`
    (moved there when it made them elsewhere), marked to take gradients,
    and the optimizer state built over them.

    With a `mesh` of more than one device and `param_logical_axes`, every
    rank draws the same full params from the same generator seed and keeps
    its shard of each leaf (the placements of `aligned_param_specs`); the
    optimizer state is built over the shards."""
    params = init_fn(generator)
    if device is not None:
        params = _to_device(params, torch.device(device))
    if mesh is not None and mesh.size() > 1:
        specs = aligned_param_specs(params, param_logical_axes or {}, rules)
        flat_specs = _flatten(specs) if isinstance(specs, dict) else \
            {"0": specs}
        leaves = param_leaves(params)
        params = _rebuild(params, [
            sharding.distribute_full(p.detach(), mesh,
                                     sharding.mesh_placements(s, mesh))
            for p, s in zip(leaves, flat_specs.values())])
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return TrainState(step=0, params=params,
                      opt_state=tx.init([sharding.local_value(p)
                                         for p in leaves]),
                      extra=extra)
