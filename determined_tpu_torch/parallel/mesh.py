"""The device mesh over the processes of a run.

Counterpart of determined_tpu/parallel/mesh.py. `MeshConfig` is the JAX
package's, copied whole: the same axes in the same order, the same
`resolve` and `from_dict`. What differs is what a mesh spans. JAX runs one
process per host, which owns every local chip, and its `Mesh` is laid over
the global device list. PyTorch on GPUs runs one process per device, so
`create_mesh` lays a `torch.distributed` `DeviceMesh` over the ranks of the
default process group, rank-major in `AXIS_ORDER`: rank
`((((data * pipeline + p) * fsdp + f) * expert + e) * context + c) *
tensor + t` holds the device at those coordinates, as a numpy reshape of
JAX's device list would. Axes of size 1 are always present, so a placement
can name any axis.

  data     — pure data parallelism (replicated params)
  pipeline — pipeline (layer-stage) parallelism
  fsdp     — fully-sharded data parallelism (ZeRO-3 analogue)
  expert   — MoE expert parallelism
  context  — sequence/context parallelism (ring attention)
  tensor   — Megatron-style tensor parallelism
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Mapping, NamedTuple, Optional, Tuple

AXIS_ORDER = ("data", "pipeline", "fsdp", "expert", "context", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh request, part of an experiment's resources config.

    Sizes of -1 mean "absorb all remaining devices" (at most one axis may be
    -1, like a numpy reshape).  Unspecified axes default to 1.
    """

    data: int = -1
    pipeline: int = 1
    fsdp: int = 1
    expert: int = 1
    context: int = 1
    tensor: int = 1

    def sizes(self) -> tuple:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    def resolve(self, n_devices: int) -> "MeshConfig":
        """Fill in any -1 axis from the device count and validate the product."""
        sizes = list(self.sizes())
        unknown = [i for i, s in enumerate(sizes) if s == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {self}")
        known = math.prod(s for s in sizes if s != -1)
        if unknown:
            if n_devices % known != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {known}"
                )
            sizes[unknown[0]] = n_devices // known
        if math.prod(sizes) != n_devices:
            raise ValueError(
                f"mesh {dict(zip(AXIS_ORDER, sizes))} needs {math.prod(sizes)} "
                f"devices, allocation has {n_devices}"
            )
        return MeshConfig(**dict(zip(AXIS_ORDER, sizes)))

    def resolvable(self, n_devices: int) -> bool:
        """True when `resolve(n_devices)` would succeed — the elastic
        feasibility check (preflight DTL204, Trainer resize) without the
        exception control flow."""
        try:
            self.resolve(n_devices)
            return True
        except ValueError:
            return False

    @staticmethod
    def from_dict(d: Mapping[str, int]) -> "MeshConfig":
        unknown = set(d) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid: {AXIS_ORDER}")
        return MeshConfig(**dict(d))


def mesh_shape_for_devices(n_devices: int, config: Optional[MeshConfig] = None) -> tuple:
    cfg = (config or MeshConfig()).resolve(n_devices)
    return cfg.sizes()


def batch_shard(config: MeshConfig, rank: int, world: int
                ) -> Tuple[int, int]:
    """(index, count): the block of the global batch that `rank` holds
    when the batch dim is split over the default rules' batch axes, data
    then fsdp, of the mesh `config` resolves to over `world` ranks. Ranks
    that differ only along other axes (an expert, context or tensor group)
    hold the same block."""
    sizes, coords = _coords(config, rank, world)
    index, count = 0, 1
    for a in ("data", "fsdp"):
        index = index * sizes[a] + coords[a]
        count *= sizes[a]
    return index, count


def _coords(config: MeshConfig, rank: int, world: int
            ) -> Tuple[dict, dict]:
    """({axis: size}, {axis: coordinate of `rank`}) on the mesh `config`
    resolves to over `world` ranks (rank-major in AXIS_ORDER)."""
    sizes = dict(zip(AXIS_ORDER, config.resolve(world).sizes()))
    coords, rest = {}, rank
    for a in reversed(AXIS_ORDER):
        coords[a] = rest % sizes[a]
        rest //= sizes[a]
    return sizes, coords


def seq_shard(config: MeshConfig, rank: int, world: int, length: int
              ) -> Tuple[int, int]:
    """(start, stop): the contiguous chunk of a sequence of `length` that
    `rank` holds when the sequence is split over the `context` axis of the
    mesh `config` resolves to over `world` ranks. Chunk i belongs to
    context rank i, the order `jax.lax.axis_index` gives the JAX package's
    ring; no zigzag balancing. The length must divide evenly."""
    sizes, coords = _coords(config, rank, world)
    return chunk(length, coords["context"], sizes["context"])


def chunk(length: int, index: int, count: int) -> Tuple[int, int]:
    """(start, stop) of the index-th of `count` equal contiguous chunks."""
    if length % count:
        raise ValueError(
            f"a sequence of {length} does not split into {count} equal "
            "chunks over the context axis")
    n = length // count
    return index * n, (index + 1) * n


class AxisGroup(NamedTuple):
    """A mesh axis as this rank sees it: the process group of the ranks
    that differ from it only along the axis, their count and this rank's
    coordinate."""
    group: Any
    size: int
    index: int


def axis_group(mesh, axis: str) -> Optional[AxisGroup]:
    """`axis` of the DeviceMesh `mesh` when it is above 1, else None (no
    mesh, or an axis of one rank: nothing to communicate)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return None
    i = mesh.mesh_dim_names.index(axis)
    if mesh.size(i) == 1:
        return None
    return AxisGroup(mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i))


# The meshes made over the current default process group, by (ranks,
# shape, device type), each beside the group it was made over and its
# control group (`control_group`).
_MESHES: dict = {}


def create_mesh(config: Optional[MeshConfig] = None,
                device_type: str = "cuda", ranks: Optional[int] = None):
    """A `DeviceMesh` with the axis names and order of `AXIS_ORDER` and
    the sizes `config` resolves to, over the first `ranks` ranks of the
    default process group (all of them by default). The process group
    must exist (`core.init()` makes it from the launcher's environment);
    each rank must have selected its device before this call.

    A mesh over a prefix is how an elastic run shrinks or grows in
    process (train/trainer.py): the ranks past the prefix stand by. A
    mesh's groups are made with `new_group`, which is collective over the
    whole default group, so EVERY rank of the world, in the mesh or not,
    must call this with the same arguments, in the same order; a rank
    outside the prefix gets a mesh whose `get_coordinate()` is None.

    The mesh of a given prefix and shape is made once per default group
    and handed out again after: a run that shrinks and grows back reuses
    its groups, so no resize adds communicators. None is destroyed while
    the group lives: DTensor's sharding cache compares meshes by their
    ranks, shape and names, and may hand an op the equal mesh of an
    earlier generation.

    A mesh of several ranks comes with a gloo group over those ranks, made
    beside it (`control_group`): host-side agreement among them that
    issues nothing on the card."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs the default process group; core.init() "
            "makes it from RANK/WORLD_SIZE/MASTER_ADDR (the launcher's "
            "environment) or a multi-host rendezvous")
    world = dist.get_world_size()
    n = world if ranks is None else int(ranks)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh over {n} ranks in a world of {world}")
    shape = mesh_shape_for_devices(n, config)
    default = dist.distributed_c10d._get_default_group()
    key = (n, shape, device_type)
    made = _MESHES.get(key)
    if made is not None and made[0] is default:
        return made[1]
    if n == world:
        mesh = init_device_mesh(device_type, shape, mesh_dim_names=AXIS_ORDER)
    else:
        mesh = DeviceMesh(device_type, torch.arange(n).reshape(shape),
                          mesh_dim_names=AXIS_ORDER)
    control = dist.new_group(list(range(n)), backend="gloo") if n > 1 \
        else None
    _MESHES[key] = (default, mesh, control)
    return mesh


def control_group(mesh):
    """The gloo group over the ranks of `mesh`, a mesh of several ranks
    that `create_mesh` made over the current default group."""
    import torch.distributed as dist

    default = dist.distributed_c10d._get_default_group()
    for made_over, made, control in _MESHES.values():
        if made is mesh and made_over is default and control is not None:
            return control
    raise ValueError(
        "this mesh was not made by parallel.mesh.create_mesh over the "
        "current process group, or holds one rank: it has no control group")


# The captured steps whose CUDA graphs hold collectives over this
# process's communicators (train/step.py registers them). NCCL's
# communicator destroy waits until no graph holds its collectives any
# more, so a graph still alive when the process group is destroyed hangs
# `destroy_process_group` on every rank: `release_graphs` drops them all
# first (`DistributedContext.shutdown`).
_GRAPHS: "weakref.WeakSet" = weakref.WeakSet()


def hold_graph(capture) -> None:
    """Register `capture` (an object with `release()`, which destroys its
    CUDA graph) as holding collectives over this process's communicators."""
    _GRAPHS.add(capture)


def release_graphs() -> int:
    """Release every registered graph -> how many there were. A step whose
    graph was released raises if it is called again."""
    held = list(_GRAPHS)
    for capture in held:
        capture.release()
    _GRAPHS.clear()
    return len(held)


def single_device_mesh(device_type: str = "cuda"):
    """A 1-device mesh (all axes size 1) for a single-process run. A
    `DeviceMesh` needs a default process group: one of world size 1 over
    an in-memory store is made when none exists."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(
            f"single_device_mesh in a world of {dist.get_world_size()} "
            "ranks; use create_mesh")
    return create_mesh(MeshConfig(data=1), device_type)
