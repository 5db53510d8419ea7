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

A fused dim holds several tensors side by side: GPT-2's qkv kernel is
`[D, 3D]`, q's columns, then k's, then v's. The JAX package shards it on
that dim as it is and lets GSPMD reshard where the product is split into
q, k and v; a contiguous split of `[q|k|v]` over the `tensor` axis would
give a rank q's heads and none of k's. The model names such a dim with
`Fused(name, pieces)` in its logical axes, a `str` that is the logical
name everywhere else (so the specs are the JAX package's). Where the mesh
splits that dim, `distribute_full` keeps the leaf in the tensor layout
(`to_split_layout`): the pieces interleaved by split, so that each rank's
contiguous slice holds the q, k and v columns of its own heads. The leaf
records its layout (`fused_layout`, `layout_of`), and `full_value` gives
it back in the one-process layout (`from_split_layout`), which
checkpoints hold.

`check_even_split` refuses a leaf that the `tensor` axis would split
into unequal pieces, as the JAX package's jit refuses one, but on a dim
its model names with `Uneven(name)`: a model that computes over unequal
pieces of that dim says so in its logical axes.
"""

from __future__ import annotations

import math
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


class Fused(str):
    """A logical axis name for a dim of `pieces` equal tensors laid side
    by side (the module docstring); equal to the plain name."""

    def __new__(cls, name: str, pieces: int) -> "Fused":
        out = super().__new__(cls, name)
        out.pieces = pieces
        return out

    def __repr__(self) -> str:
        return f"Fused({str.__repr__(self)}, {self.pieces})"


def fused_dims(logical_axes: Sequence[Optional[str]]) -> dict:
    """{dim: pieces} of the `Fused` names among a leaf's logical axes."""
    return {d: a.pieces for d, a in enumerate(logical_axes or ())
            if isinstance(a, Fused)}


def _regroup(t, dim: int, outer: int, inner: int):
    """View `dim` of `t` as [outer, inner, rest] and swap outer and
    inner."""
    shape = t.shape
    n = shape[dim]
    if n % (outer * inner):
        raise ValueError(
            f"dim {dim} of {tuple(shape)} does not split into {outer} x "
            f"{inner} equal parts")
    x = t.reshape(*shape[:dim], outer, inner, n // (outer * inner),
                  *shape[dim + 1:])
    return x.transpose(dim, dim + 1).reshape(shape)


def fused_layout(logical_axes, placements, mesh
                 ) -> Tuple[Tuple[int, int, int], ...]:
    """The (dim, pieces, parts) of a leaf's `Fused` dims that the mesh
    splits: `parts` the product of the sizes of the mesh dims that shard
    it. () when there are none."""
    out = []
    for dim, pieces in fused_dims(logical_axes).items():
        parts = math.prod(mesh.size(i) for i, p in enumerate(placements)
                          if p.is_shard() and p.dim == dim)
        if parts > 1:
            out.append((dim, pieces, parts))
    return tuple(out)


def layout_of(p) -> Tuple[Tuple[int, int, int], ...]:
    """The fused layout a leaf was distributed with (`distribute_full`);
    () for a plain tensor or a leaf without one."""
    return getattr(p, "fused_layout", ())


def to_split_layout(t, dim: int, pieces: int, parts: int):
    """A fused dim in the tensor layout: [pieces, parts, n] ->
    [parts, pieces, n], so the p-th of `parts` contiguous slices holds the
    p-th slice of every piece."""
    return _regroup(t, dim, pieces, parts)


def from_split_layout(t, dim: int, pieces: int, parts: int):
    """The inverse of `to_split_layout`: the one-process layout."""
    return _regroup(t, dim, parts, pieces)


class Uneven(str):
    """A logical axis name for a dim that the model computes over in
    unequal pieces, so `check_even_split` lets it pass; equal to the plain
    name."""


def check_even_split(name: str, shape: Sequence[int], logical_axes,
                     placements, mesh) -> None:
    """Raise ValueError, naming the leaf and the axis, when the `tensor`
    mesh axis splits a dim of `shape` into unequal pieces (as the JAX
    package's jit refuses one), but for a dim named `Uneven`."""
    names = mesh.mesh_dim_names
    for i, p in enumerate(placements):
        n = mesh.size(i)
        if names[i] != "tensor" or not p.is_shard() or n == 1 or \
                shape[p.dim] % n == 0:
            continue
        logical = (logical_axes or (None,) * len(shape))[p.dim]
        if isinstance(logical, Uneven):
            continue
        raise ValueError(
            f"leaf {name!r}: dim {p.dim} ({logical!r}) of {tuple(shape)} "
            f"does not split into {n} equal parts over the tensor mesh "
            f"axis (tensor={n}); choose a tensor size that divides "
            f"{shape[p.dim]}")


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


def distribute_full(full, mesh, placements, layout=()):
    """A DTensor whose local tensor is this rank's piece of `full` (the
    same on every rank, in the one-process layout), cut as DTensor cuts it
    (`torch.chunk` per sharded mesh dim, in mesh-dim order): no
    collective. `layout` (`fused_layout`) puts the fused dims in the
    tensor layout first; the DTensor records it."""
    from torch.distributed.tensor import DTensor

    for dim, pieces, parts in layout:
        full = to_split_layout(full, dim, pieces, parts)
    local = full
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    out = DTensor.from_local(local.contiguous(), mesh, placements,
                             run_check=False, shape=full.shape,
                             stride=full.contiguous().stride())
    out.fused_layout = tuple(layout)
    return out


def gather_for_use(p, keep: Sequence[str] = (), async_op: bool = False,
                   sum_over: Sequence[str] = ()):
    """A leaf as a plain tensor for the model to use: a DTensor is
    all-gathered (`redistribute` to `Replicate`) and unwrapped, so the
    kernels' `autograd.Function`s see plain tensors; other tensors pass
    through. In the backward the gradient of the unwrapped tensor counts
    as a mean over every mesh axis above 1 (each rank's loss is the mean
    over its own rows, the global loss the mean of those), so it comes
    back reduce-scattered over the axes the leaf is sharded on and
    all-reduced over the rest.

    The mesh axes named in `keep` on which the leaf is split stay split:
    the rank's tensor is its piece along them (an MoE rank's own experts,
    ops/moe.py; a tensor-parallel rank's heads, columns or rows,
    models/gpt2.py), and its gradient is that piece's. A leaf replicated
    on a kept axis has its gradient averaged there as on the others.

    `async_op`: issue the gather and return at once; the tensor waits for
    it at its first use (a functional collective's AsyncCollectiveTensor),
    so the gather overlaps whatever runs in between.

    `sum_over`: mesh axes over which the leaf is replicated and each rank
    holds a share of its gradient rather than a copy (a pipeline stage's,
    parallel/pipeline.py): the shares are summed there, not averaged."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(p, DTensor):
        return p
    mesh = p.device_mesh
    names = mesh.mesh_dim_names
    target = [pl if names[i] in keep else Replicate()
              for i, pl in enumerate(p.placements)]
    full = p.redistribute(mesh, target, async_op=async_op)
    grads = [target[i] if target[i].is_shard() or mesh.size(i) == 1
             else Partial("sum" if names[i] in sum_over else "avg")
             for i in range(mesh.ndim)]
    return full.to_local(grad_placements=grads)


def mesh_of(p):
    """The DeviceMesh a DTensor leaf lies on; None for a plain tensor."""
    from torch.distributed.tensor import DTensor

    return p.device_mesh if isinstance(p, DTensor) else None


def full_value(p, layout=None):
    """The full value of a leaf on every rank (a collective for a sharded
    DTensor), detached, in the one-process layout: `layout` is the fused
    layout its value is in, by default the one it records (a gradient or
    a moment passes its leaf's)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return p.detach()
    t = p.detach().full_tensor()
    for dim, pieces, parts in reversed(layout_of(p) if layout is None
                                       else layout):
        t = from_split_layout(t, dim, pieces, parts)
    return t


def local_value(p):
    """This rank's storage of a leaf: the DTensor's local tensor (the same
    memory, so an in-place update of it updates the leaf), or the tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor):
        return p._local_tensor
    return p


def shard_axes(p) -> Tuple[str, ...]:
    """The names of the mesh axes (above size 1) a leaf is sharded over;
    () for a plain tensor or a replicated DTensor."""
    if not shard_mesh_dims(p):
        return ()
    names = p.device_mesh.mesh_dim_names
    return tuple(names[i] for i in shard_mesh_dims(p))


def shard_mesh_dims(p) -> Tuple[int, ...]:
    """The mesh dims (above size 1) a leaf is sharded over; () for a plain
    tensor or a replicated DTensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return ()
    mesh = p.device_mesh
    return tuple(i for i, pl in enumerate(p.placements)
                 if pl.is_shard() and mesh.size(i) > 1)


def region(shape: Sequence[int], mesh_shape: Sequence[int], placements,
           coord: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(offsets, sizes) of the piece of a tensor of `shape` that the mesh
    coordinate `coord` holds under `placements`, cut as `distribute_full`
    cuts it: `torch.chunk` per sharded mesh dim, in mesh-dim order."""
    offsets, sizes = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if p.is_shard() and mesh_shape[i] > 1:
            d, n = p.dim, sizes[p.dim]
            step = -(-n // mesh_shape[i])
            start = min(coord[i] * step, n)
            offsets[d] += start
            sizes[d] = min(step, n - start)
    return tuple(offsets), tuple(sizes)


def tensor_piece(full, logical_axes, index: int, size: int):
    """Rank `index`'s piece of a leaf (`full`, in the one-process layout)
    on a mesh whose only axis above 1 is `tensor`, of `size`, under the
    default rules: the piece `distribute_full` keeps there (a `Fused` dim
    in the tensor layout) and `gather_for_use(keep=("tensor",))` hands the
    model. One process can then run each tensor rank's part of a layer
    (chip_smoke.py's phase 18a)."""
    placements = spec_to_placements(LogicalRules().spec(logical_axes))
    split = placements[AXIS_ORDER.index("tensor")]
    for dim, pieces in fused_dims(logical_axes).items():
        if split.is_shard() and split.dim == dim and size > 1:
            full = to_split_layout(full, dim, pieces, size)
    offsets, sizes = region(
        full.shape, [size if a == "tensor" else 1 for a in AXIS_ORDER],
        placements, [index if a == "tensor" else 0 for a in AXIS_ORDER])
    for dim, (start, n) in enumerate(zip(offsets, sizes)):
        full = full.narrow(dim, start, n)
    return full


def regions(p) -> list:
    """[(rank, offsets, sizes)] of every rank of a DTensor leaf's mesh, in
    the order of its ranks: which piece of the leaf (in the layout it is
    kept in) each rank holds."""
    import numpy as np

    mesh = p.device_mesh
    ranks = mesh.mesh.cpu().numpy()
    out = []
    for coord in np.ndindex(ranks.shape):
        offsets, sizes = region(p.shape, ranks.shape, p.placements, coord)
        out.append((int(ranks[coord]), offsets, sizes))
    return sorted(out)
