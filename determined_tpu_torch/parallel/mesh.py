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
from typing import Mapping, Optional

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


def create_mesh(config: Optional[MeshConfig] = None,
                device_type: str = "cuda"):
    """A `DeviceMesh` over every rank of the default process group, with
    the axis names and order of `AXIS_ORDER` and the sizes `config`
    resolves to over the world size. The process group must exist
    (`core.init()` makes it from the launcher's environment); each rank
    must have selected its device before this call."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs the default process group; core.init() "
            "makes it from RANK/WORLD_SIZE/MASTER_ADDR (the launcher's "
            "environment) or a multi-host rendezvous")
    shape = mesh_shape_for_devices(dist.get_world_size(), config)
    return init_device_mesh(device_type, shape, mesh_dim_names=AXIS_ORDER)


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
