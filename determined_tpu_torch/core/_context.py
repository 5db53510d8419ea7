"""core.init() — one context bundling the training services, local mode.

Counterpart of determined_tpu/core/_context.py. The JAX package runs in two
modes: managed (launched by an agent, talking to the master) and local (no
master: metrics in memory, one searcher op of `max_length`, checkpoints in
a local directory). The port has local mode only. A process launched
inside a cluster (any of the `DET_*` variables an agent sets) makes
`init()` raise NotImplementedError: it never trains as local mode in
silence there.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

from determined_tpu_torch.common.trace import Tracer
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.core._preempt import PreemptContext
from determined_tpu_torch.core._profiler import ProfilerContext
from determined_tpu_torch.core._searcher import SearcherContext
from determined_tpu_torch.core._train import TrainContext

# The variables that mark a process the cluster launched
# (determined_tpu/_info.py reads them).
CLUSTER_ENV = ("DET_MASTER", "DET_TRIAL_ID", "DET_ALLOCATION_ID",
               "DET_SESSION_TOKEN", "DET_CONTAINER_ADDRS",
               "DET_LATEST_CHECKPOINT", "DET_HPARAMS")


def default_checkpoint_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "determined_tpu_torch",
                        "checkpoints")


class Context:
    def __init__(self, train: TrainContext, searcher: SearcherContext,
                 checkpoint: CheckpointContext, preempt: PreemptContext,
                 distributed: DistributedContext, profiler: ProfilerContext,
                 tracer: Optional[Tracer] = None):
        self.train = train
        self.searcher = searcher
        self.checkpoint = checkpoint
        self.preempt = preempt
        self.distributed = distributed
        self.profiler = profiler
        # Local mode has no cluster info: no experiment config, hparams or
        # resume pointer come from outside the process.
        self.info = None
        self.tracer = tracer if tracer is not None else Tracer()

    @property
    def hparams(self) -> Dict[str, Any]:
        return {}

    @property
    def trial_seed(self) -> int:
        return 0

    @property
    def latest_checkpoint(self) -> Optional[str]:
        return None

    def close(self) -> None:
        self.tracer.close()
        self.profiler.close()
        self.preempt.close()
        self.distributed.shutdown()

    def __enter__(self) -> "Context":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()


def init(*, max_length: Optional[int] = None,
         checkpoint_dir: Optional[str] = None) -> Context:
    """Bring up the Core API in local mode. Checkpoints go to
    `checkpoint_dir` (default: under the temporary directory)."""
    found = sorted(k for k in CLUSTER_ENV if os.environ.get(k))
    if found:
        raise NotImplementedError(
            f"core.init(): cluster environment found ({', '.join(found)}), "
            "but the PyTorch port runs in local mode only; managed mode "
            "(the master session, searcher, preemption and checkpoint "
            "registry) is not ported yet (ROADMAP.md)")
    train = TrainContext()
    checkpoint = CheckpointContext(checkpoint_dir or default_checkpoint_dir())
    tracer = Tracer()
    checkpoint.tracer = tracer
    return Context(train, SearcherContext(local_max_length=max_length),
                   checkpoint, PreemptContext(), DistributedContext.local(),
                   ProfilerContext(train), tracer=tracer)
