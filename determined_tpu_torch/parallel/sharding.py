"""Logical-axis sharding rules, and their DTensor placements.

Counterpart of determined_tpu/parallel/sharding.py. Models name the dims
of their arrays with *logical* axes ("batch", "embed", "heads", ...); a
`LogicalRules` table maps logical names to mesh axes, and `spec` turns an
array's logical names into a `PartitionSpec` (copied whole from the JAX
package, with its own `PartitionSpec`: the port cannot import
`jax.sharding`). Where the JAX package hands the spec to GSPMD, the port
turns it into DTensor placements over the `DeviceMesh`
(`spec_to_placements`): `Shard(d)` on each mesh axis the spec names for
tensor dim `d`, `Replicate()` on the others.

The helpers below are the only places the port's train path touches
DTensor: `distribute_full` cuts a rank's shard out of a full tensor
without a collective (every rank holds the full value, as after a
checkpoint read), `gather_for_use` is the all-gather before a leaf is used
(its backward is the gradient's reduce-scatter over the sharded axes and
its mean over the replicated ones), and `full_value` gathers a leaf for a
checkpoint.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

from determined_tpu_torch.parallel.mesh import AXIS_ORDER

MeshAxes = Union[None, str, Tuple[str, ...]]

# Canonical rules: batch over (data, fsdp); params sharded over fsdp on their
# largest dim and over tensor on the "parallel" dim (Megatron layout); sequence
# over context for ring attention.
DEFAULT_RULES: Tuple[Tuple[str, MeshAxes], ...] = (
    ("batch", ("data", "fsdp")),
    ("seq", "context"),
    ("layers", "pipeline"),  # stacked-layer dim → pipeline stages
    ("embed", "fsdp"),
    ("heads", "tensor"),
    ("kv", None),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("expert", "expert"),
    ("unmodeled", None),
)


class PartitionSpec(tuple):
    """One entry per array dim: None (replicated), a mesh axis name, or a
    tuple of mesh axis names (the dim split over all of them, the first
    outermost), as `jax.sharding.PartitionSpec`."""

    def __new__(cls, *entries: MeshAxes) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class LogicalRules:
    def __init__(self, rules: Sequence[Tuple[str, MeshAxes]] = DEFAULT_RULES):
        self._table: dict = {}
        for name, axes in rules:
            self._table[name] = axes

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        if logical not in self._table:
            raise KeyError(f"no sharding rule for logical axis {logical!r}")
        return self._table[logical]

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        """PartitionSpec for an array whose dims carry these logical names.

        A mesh axis may be consumed at most once per array; later dims that
        would reuse an already-consumed mesh axis fall back to replication.
        """
        used: set = set()
        out = []
        for logical in logical_axes:
            axes = self.mesh_axes(logical)
            if axes is None:
                out.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            free = tuple(a for a in axes if a not in used)
            used.update(free)
            if not free:
                out.append(None)
            elif len(free) == 1:
                out.append(free[0])
            else:
                out.append(free)
        return PartitionSpec(*out)

    def override(self, **kwargs: MeshAxes) -> "LogicalRules":
        table = dict(self._table)
        table.update(kwargs)
        return LogicalRules(tuple(table.items()))


def logical_to_mesh_spec(
    logical_axes: Sequence[Optional[str]], rules: Optional[LogicalRules] = None
) -> PartitionSpec:
    return (rules or LogicalRules()).spec(logical_axes)


def spec_to_placements(spec: Sequence[MeshAxes],
                       mesh_dim_names: Sequence[str] = AXIS_ORDER) -> list:
    """DTensor placements, one per mesh dim, for an array laid out by
    `spec`: `Shard(d)` on every mesh axis that entry `d` names,
    `Replicate()` on the rest. DTensor splits a dim sharded over several
    mesh axes in the order of the mesh's dims, so an entry naming several
    axes must name them in that order (JAX's outermost-first); a mesh axis
    named twice, or one the mesh lacks, raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_dim_names)
    placements: list = [Replicate()] * len(names)
    seen: set = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh axis {a!r} of {spec} is not in the "
                                 f"mesh's {tuple(names)}")
            if a in seen:
                raise ValueError(f"mesh axis {a!r} appears twice in {spec}")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"entry {axes} of {spec} splits one dim over mesh axes out "
                f"of the mesh's order {tuple(names)}")
        for i in idx:
            placements[i] = Shard(dim)
    return placements


def mesh_placements(spec: Sequence[MeshAxes], mesh) -> list:
    """`spec_to_placements` over `mesh`, with mesh axes of size 1
    replicated (a split in one piece is no split, and DTensor refuses to
    unbind or index a dim it counts as sharded)."""
    from torch.distributed.tensor import Replicate

    placements = spec_to_placements(spec, mesh.mesh_dim_names)
    return [p if mesh.size(i) > 1 else Replicate()
            for i, p in enumerate(placements)]


def distribute_full(full, mesh, placements):
    """A DTensor whose local tensor is this rank's piece of `full` (the
    same on every rank), cut as DTensor cuts it (`torch.chunk` per sharded
    mesh dim, in mesh-dim order): no collective."""
    from torch.distributed.tensor import DTensor

    local = full
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())


def gather_for_use(p):
    """A leaf as a plain full tensor for the model to use: a DTensor is
    all-gathered (`redistribute` to `Replicate`) and unwrapped, so the
    kernels' `autograd.Function`s see plain tensors; other tensors pass
    through. In the backward the gradient of the unwrapped tensor counts
    as a mean over every mesh axis above 1 (each rank's loss is the mean
    over its own rows, the global loss the mean of those), so it comes
    back reduce-scattered over the axes the leaf is sharded on and
    all-reduced over the rest."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(p, DTensor):
        return p
    mesh = p.device_mesh
    full = p.redistribute(mesh, [Replicate()] * mesh.ndim)
    grads = [Partial("avg") if mesh.size(i) > 1 else Replicate()
             for i in range(mesh.ndim)]
    return full.to_local(grad_placements=grads)


def full_value(p):
    """The full value of a leaf on every rank (a collective for a sharded
    DTensor), detached."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor):
        return p.detach().full_tensor()
    return p.detach()


def local_value(p):
    """This rank's storage of a leaf: the DTensor's local tensor (the same
    memory, so an in-place update of it updates the leaf), or the tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor):
        return p._local_tensor
    return p


def shard_mesh_dims(p) -> Tuple[int, ...]:
    """The mesh dims (above size 1) a leaf is sharded over; () for a plain
    tensor or a replicated DTensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return ()
    mesh = p.device_mesh
    return tuple(i for i, pl in enumerate(p.placements)
                 if pl.is_shard() and mesh.size(i) > 1)
