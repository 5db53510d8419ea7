"""Core API — the training services, managed (a master) or local
(counterpart of determined_tpu/core/)."""

from determined_tpu_torch.core._checkpoint import CheckpointContext, state_id_step  # noqa: F401
from determined_tpu_torch.core._context import Context, init  # noqa: F401
from determined_tpu_torch.core._distributed import DistributedContext  # noqa: F401
from determined_tpu_torch.core._integrity import CorruptCheckpoint  # noqa: F401
from determined_tpu_torch.core._preempt import PreemptContext  # noqa: F401
from determined_tpu_torch.core._profiler import ProfilerContext  # noqa: F401
from determined_tpu_torch.core._searcher import SearcherContext, SearcherOperation  # noqa: F401
from determined_tpu_torch.core._train import TrainContext  # noqa: F401
