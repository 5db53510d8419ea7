"""core.init() — one context bundling the training services.

Counterpart of determined_tpu/core/_context.py, in its two modes:

  - **managed**: launched by an agent. `ClusterInfo` comes from the
    `DET_*` environment (`_info.py`); a `Session` fenced with the
    allocation's epoch talks to the master: metric and progress reports,
    the searcher's ops, the preemption long-poll, the checkpoint registry
    and the span sink. Checkpoints go to the trial config's
    `checkpoint_storage`.
  - **local**: no master. Metrics accumulate in memory, the searcher
    yields one op of `max_length`, checkpoints go to a local directory.

The same user code runs in both, in one process or many. The processes
of a run come from the GPU-slot launcher (`launch/torch_distributed.py`:
RANK, WORLD_SIZE, MASTER_ADDR, ... one process per device) or from a
multi-host rendezvous (one process per host): either way `init` forms the
`torch.distributed` process group (`DistributedContext`) and hands it to
the sub-contexts, which keep the master's work on the chief and broadcast
its decisions, as the JAX package's do. Checkpoints go through the
storage manager `checkpoint_storage` names (storage/: `shared_fs`,
`directory`, `gcs`, `s3`, `azure`); a cloud type whose SDK does not
import raises, naming the package, and never falls back to a directory.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

from determined_tpu_torch._info import ClusterInfo, get_cluster_info
from determined_tpu_torch.common.api import Session
from determined_tpu_torch.common.trace import Tracer
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.core._preempt import PreemptContext
from determined_tpu_torch.core._profiler import ProfilerContext
from determined_tpu_torch.core._searcher import SearcherContext
from determined_tpu_torch.core._train import TrainContext
from determined_tpu_torch.storage import from_config

logger = logging.getLogger("determined_tpu_torch.core")


def checkpoint_base(storage: Optional[Dict[str, Any]],
                    default_base: Optional[str] = None) -> str:
    """The directory a filesystem `checkpoint_storage` (`shared_fs`,
    `directory`) keeps its checkpoints in. A cloud type keeps them in a
    bucket and has none: it raises, naming the type."""
    stype = (storage or {}).get("type", "shared_fs")
    if stype not in ("shared_fs", "directory"):
        raise NotImplementedError(
            f"checkpoint_storage type {stype!r} keeps its checkpoints in a "
            "bucket, not a directory; storage.from_config builds its manager")
    return from_config(storage, default_base).base_path


class Context:
    def __init__(self, train: TrainContext, searcher: SearcherContext,
                 checkpoint: CheckpointContext, preempt: PreemptContext,
                 distributed: DistributedContext, profiler: ProfilerContext,
                 info: Optional[ClusterInfo] = None,
                 tracer: Optional[Tracer] = None):
        self.train = train
        self.searcher = searcher
        self.checkpoint = checkpoint
        self.preempt = preempt
        self.distributed = distributed
        self.profiler = profiler
        self.info = info  # None in local mode
        self.tracer = tracer if tracer is not None else Tracer()

    @property
    def hparams(self) -> Dict[str, Any]:
        return self.info.trial.hparams if (self.info and self.info.trial) \
            else {}

    @property
    def trial_seed(self) -> int:
        return self.info.trial.trial_seed if (self.info and self.info.trial) \
            else 0

    @property
    def latest_checkpoint(self) -> Optional[str]:
        return self.info.trial.latest_checkpoint \
            if (self.info and self.info.trial) else None

    def close(self) -> None:
        # The order matters: drain the checkpoint write first, so the
        # phase-2 commit spans make the tracer's final batch; then the
        # final tensorboard sync, the watchers, distributed.
        self.checkpoint.close()
        self.tracer.close()
        if self.train._tb is not None:
            self.train._tb.close()
        self.profiler.close()
        self.preempt.close()
        self.distributed.shutdown()

    def __enter__(self) -> "Context":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()


def _distributed_context(info: Optional[ClusterInfo]) -> DistributedContext:
    """The launcher's environment (WORLD_SIZE set), else a rendezvous of
    more than one host, else one local process."""
    launched = DistributedContext.from_env()
    if launched is not None:
        return launched
    rdzv = info.rendezvous if info is not None else None
    if rdzv is not None and rdzv.num_hosts > 1:
        return DistributedContext.from_allocation(
            coordinator_addr=rdzv.coordinator_addr
            or rdzv.container_addrs[0] + ":8476",
            num_processes=rdzv.num_hosts,
            process_id=rdzv.container_rank,
            backend=os.environ.get("DET_TORCH_BACKEND", "nccl"))
    return DistributedContext.local()


def init(*, max_length: Optional[int] = None,
         storage_config: Optional[Dict[str, Any]] = None,
         checkpoint_dir: Optional[str] = None,
         distributed: Optional[DistributedContext] = None,
         async_checkpointing: bool = True) -> Context:
    """Bring up the Core API: managed mode when the environment names a
    master (`DET_MASTER`), else local mode. Checkpoints go to
    `storage_config`, else the trial config's `checkpoint_storage`, else
    `checkpoint_dir` (default: under the temporary directory). The
    process topology is `distributed` when given, else built from the
    launcher's environment or the rendezvous (`_distributed_context`)."""
    info = get_cluster_info()
    if distributed is None:
        distributed = _distributed_context(info)
    session: Optional[Session] = None
    trial_id, run_id, allocation_id = 0, 0, None
    if info is not None:
        # Every call carries the fencing epoch of this allocation run: a
        # zombie of a superseded run gets a 409 instead of writing into
        # its successor's lineage.
        fence = ({"X-Allocation-Epoch": str(info.allocation_epoch)}
                 if info.allocation_epoch is not None else None)
        session = Session(info.master_url, info.session_token, headers=fence)
        allocation_id = info.allocation_id
        if info.trial is not None:
            trial_id, run_id = info.trial.trial_id, info.trial.run_id
            storage_config = storage_config or \
                info.trial.config.get("checkpoint_storage")
    storage = from_config(storage_config, default_base=checkpoint_dir)

    tb_manager = None
    if info is not None and info.trial is not None and distributed.is_chief:
        from determined_tpu_torch.tensorboard import TensorboardManager

        tb_manager = TensorboardManager(storage, info.trial.experiment_id,
                                        info.trial.trial_id)
    train = TrainContext(session, trial_id=trial_id, run_id=run_id,
                         distributed=distributed,
                         tensorboard_manager=tb_manager)
    searcher = SearcherContext(session, trial_id=trial_id,
                               distributed=distributed,
                               local_max_length=max_length)
    checkpoint = CheckpointContext(
        storage, trial_id=trial_id, session=session,
        allocation_id=allocation_id, distributed=distributed,
        async_save=async_checkpointing)
    preempt = PreemptContext(session, allocation_id=allocation_id,
                             distributed=distributed)
    # Spans are the chief's alone: the other ranks would repeat each one.
    tracer = Tracer(session if distributed.is_chief else None,
                    trial_id=trial_id,
                    enabled=None if distributed.is_chief else False)
    checkpoint.tracer = tracer  # phase-1 and phase-2 commit spans
    ctx = Context(train, searcher, checkpoint, preempt, distributed,
                  ProfilerContext(train), info, tracer=tracer)
    if session is not None:
        try:
            session.post(f"/api/v1/trials/{trial_id}/run_prepare", body={})
        except Exception:
            logger.debug("run_prepare failed", exc_info=True)
    return ctx
