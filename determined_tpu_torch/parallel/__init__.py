"""Parallelism: the device mesh over the processes of a run and the
logical sharding rules (counterpart of determined_tpu/parallel/)."""

from determined_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    MeshConfig,
    axis_group,
    batch_shard,
    create_mesh,
    mesh_shape_for_devices,
    seq_shard,
    single_device_mesh,
)
from determined_tpu_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    LogicalRules,
    PartitionSpec,
    logical_to_mesh_spec,
    spec_to_placements,
)
