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
on the fsdp axis and replicated over data (and over expert, but for an
MoE model's expert leaves, `Shard` along their expert dim there). The optimizer works on the
local tensors (`LocalShards`), so its moments are local shards that
mirror their leaves (`_mirrors` says which leaf each mirrors).
`unshard_state` gathers the full state (a collective), as a one-process
run holds it.

Checkpoints are per rank (core/_checkpoint.py): `checkpoint_view` shows
each moment that mirrors a sharded leaf as a DTensor laid out as its leaf
(the same memory), so each rank writes its pieces of the params and of
the moments, and a restore into a view of a state of any width reads the
pieces its own layout overlaps; `from_checkpoint_view` takes the moments
back to local tensors. An elastic resize restores into
`empty_train_state`: built from the checkpoint's structure
(`CheckpointContext.abstract_state`, meta tensors) with `torch.empty` for
each local shard of the new mesh and the optimizer's `init` over them,
without calling the trial's `init_params` (the JAX package's
`abstract_train_state`).

Over a `tensor` axis a leaf whose logical axes name a `Fused` dim (GPT-2's
qkv kernel and bias: q, k and v side by side) is kept in the tensor
layout (`parallel/sharding.fused_layout`): the DTensor's value has that
dim's pieces interleaved by split, so each rank's contiguous slice holds
the q, k and v of its own heads, and so do the moments that mirror it.
The leaf records its layout; `unshard_state` converts to the one-process
layout through `sharding.full_value`, and a checkpoint records the layout
its pieces were written in, so a restore at another tensor width converts
them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch

from determined_tpu_torch.core._checkpoint import _map_tensors
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
    # for purely functional models. A step writes new values into these
    # tensors in place (`apply_gradients`).
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
            if self.extra is None:
                self.extra = new_extra
            else:
                # Into the state's own buffers: a captured step (a CUDA
                # graph) reads and writes these same tensors at each replay.
                with torch.no_grad():
                    _copy_into(self.extra, new_extra)
        return self


def _copy_into(dst: Any, src: Any) -> None:
    """Copy each tensor of `src` into the tensor at the same place (dict
    key, list index) of `dst`."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"new extra keys {sorted(src)} differ from the "
                             f"state's {sorted(dst)}")
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src, strict=True):
            _copy_into(d, s)


def extra_leaves(extra: Any) -> List[torch.Tensor]:
    """The tensors of a non-gradient state tree, in a fixed order."""
    out: List[torch.Tensor] = []
    _map_tensors(extra, out.append)
    return out


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
        return sharding.full_value(d, sharding.layout_of(p))

    params = _rebuild(state.params, full_leaves(state))
    return TrainState(step=state.step, params=params,
                      opt_state=_map_opt(state.opt_state, locals_, moment),
                      extra=state.extra)


def full_leaves(state: TrainState, leaves: Optional[List[Any]] = None
                ) -> List[torch.Tensor]:
    """The state's param leaves, or `leaves` laid out as they are (their
    gradients), each whole and in the one-process layout, detached: a
    collective for a sharded state."""
    own = state.leaves()
    leaves = own if leaves is None else leaves
    return [sharding.full_value(g, sharding.layout_of(p))
            for p, g in zip(own, leaves)]


def gathered(params: Any) -> Any:
    """A param tree whose sharded leaves are whole plain tensors in the
    one-process layout (a collective for a sharded tree): what a model
    computes with as one process would."""
    if isinstance(params, dict):
        return {k: gathered(v) for k, v in params.items()}
    return sharding.full_value(params)


def checkpoint_view(state: TrainState) -> TrainState:
    """`state` as a checkpoint writes and a restore reads it: each moment
    that mirrors a DTensor leaf shown as a DTensor with the leaf's mesh,
    placements and fused layout over the same memory (no copy, no
    collective), so the moments are written and read per rank as their
    leaves are. A state without DTensor leaves is returned as it is."""
    from torch.distributed.tensor import DTensor

    leaves = state.leaves()
    if not any(isinstance(p, DTensor) for p in leaves):
        return state
    locals_ = [sharding.local_value(p) for p in leaves]

    def moment(t, i):
        p = leaves[i] if i is not None else None
        if not isinstance(p, DTensor):
            return t
        d = DTensor.from_local(t, p.device_mesh, p.placements,
                               run_check=False, shape=p.shape,
                               stride=p.stride())
        d.fused_layout = sharding.layout_of(p)
        return d

    return TrainState(step=state.step, params=state.params,
                      opt_state=_map_opt(state.opt_state, locals_, moment),
                      extra=state.extra)


def from_checkpoint_view(state: TrainState) -> TrainState:
    """The inverse of `checkpoint_view`: the moments as local tensors."""
    def walk(node):
        if isinstance(node, torch.Tensor):
            return sharding.local_value(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return TrainState(step=state.step, params=state.params,
                      opt_state=walk(state.opt_state), extra=state.extra)


def empty_train_state(abstract: Any, tx: optim.GradientTransformation,
                      device: Any, mesh: Any = None,
                      param_logical_axes: Optional[Any] = None,
                      rules: Optional[LogicalRules] = None) -> TrainState:
    """A template to restore into, built from a checkpoint's structure
    (`abstract`: `CheckpointContext.abstract_state`, the saved tree of
    meta tensors) without the trial's `init_params`: each param leaf laid
    out over `mesh` as `create_train_state` lays it (the placements of
    `aligned_param_specs`, a `Fused` dim in the tensor layout), with
    `torch.empty` for this rank's shard on `device`; the optimizer state
    `tx.init` builds over the shards; `extra` empty likewise."""
    from torch.distributed.tensor import DTensor

    device = torch.device(device)
    params = abstract["params"]
    leaves = param_leaves(params)
    if mesh is not None and mesh.size() > 1:
        specs = aligned_param_specs(params, param_logical_axes or {}, rules)
        flat_specs = _flatten(specs) if isinstance(specs, dict) else \
            {"0": specs}
        coord = mesh.get_coordinate()
        shards = []
        for path, p in zip(flat_specs, leaves):
            placements = sharding.mesh_placements(flat_specs[path], mesh)
            axes = _lookup_axes(param_logical_axes or {}, path) \
                if isinstance(params, dict) else None
            _, sizes = sharding.region(p.shape, tuple(mesh.mesh.shape),
                                       placements, coord)
            d = DTensor.from_local(
                torch.empty(sizes, dtype=p.dtype, device=device), mesh,
                placements, run_check=False, shape=p.shape,
                stride=p.stride())
            d.fused_layout = sharding.fused_layout(axes, placements, mesh)
            shards.append(d)
    else:
        shards = [torch.empty(p.shape, dtype=p.dtype, device=device)
                  for p in leaves]
    params = _rebuild(params, shards)
    for p in shards:
        p.requires_grad_(True)
    extra = abstract.get("extra")
    if extra is not None:
        extra = _map_tensors(extra, lambda t: torch.empty(
            t.shape, dtype=t.dtype, device=device))
    return TrainState(step=0, params=params,
                      opt_state=tx.init([sharding.local_value(p)
                                         for p in shards]),
                      extra=extra)


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
    its shard of each leaf (the placements of `aligned_param_specs`; a
    `Fused` dim split over the mesh in the tensor layout); the optimizer
    state is built over the shards."""
    params = init_fn(generator)
    if device is not None:
        params = _to_device(params, torch.device(device))
    if extra is not None:
        # The state's own buffers, updated in place by each step.
        extra = _map_tensors(extra, lambda t: t.detach().to(
            t.device if device is None else device, copy=True))
    if mesh is not None and mesh.size() > 1:
        specs = aligned_param_specs(params, param_logical_axes or {}, rules)
        flat_specs = _flatten(specs) if isinstance(specs, dict) else \
            {"0": specs}
        leaves = param_leaves(params)
        sharded = []
        for path, p in zip(flat_specs, leaves):
            placements = sharding.mesh_placements(flat_specs[path], mesh)
            axes = _lookup_axes(param_logical_axes or {}, path) \
                if isinstance(params, dict) else None
            sharded.append(sharding.distribute_full(
                p.detach(), mesh, placements,
                sharding.fused_layout(axes, placements, mesh)))
        params = _rebuild(params, sharded)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return TrainState(step=0, params=params,
                      opt_state=tx.init([sharding.local_value(p)
                                         for p in leaves]),
                      extra=extra)
