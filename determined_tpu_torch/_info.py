"""Task-side view of the cluster: the `DET_*` environment an agent sets.

The port's copy of determined_tpu/_info.py, with the same variable names
and fields. A process the agent launched reads its master, trial and
allocation identity from the environment, plus
``$DET_RUN_DIR/info/rendezvous.json`` when the agent wrote one.
``DET_TPU_WORKER_ID`` and ``DET_MESH_CONFIG`` are read as the JAX package
reads them, so both packages see one environment alike; the port trains
on one device and uses neither.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional


def _env(name: str, default: Optional[str] = None) -> Optional[str]:
    v = os.environ.get(name)
    return v if v not in (None, "") else default


@dataclasses.dataclass
class TrialInfo:
    trial_id: int
    experiment_id: int
    trial_seed: int
    hparams: Dict[str, Any]
    config: Dict[str, Any]
    steps_completed: int = 0
    latest_checkpoint: Optional[str] = None
    # Which run of the trial this process is (bumped on every requeue or
    # restart); stamped onto metric reports as trial_run_id.
    run_id: int = 0

    @classmethod
    def _from_env(cls) -> Optional["TrialInfo"]:
        tid = _env("DET_TRIAL_ID")
        if tid is None:
            return None
        return cls(
            trial_id=int(tid),
            experiment_id=int(_env("DET_EXPERIMENT_ID", "0")),
            trial_seed=int(_env("DET_TRIAL_SEED", "0")),
            hparams=json.loads(_env("DET_HPARAMS", "{}")),
            config=json.loads(_env("DET_EXPERIMENT_CONFIG", "{}")),
            steps_completed=int(_env("DET_STEPS_COMPLETED", "0")),
            latest_checkpoint=_env("DET_LATEST_CHECKPOINT"),
            run_id=int(_env("DET_TRIAL_RUN_ID", "0")),
        )


@dataclasses.dataclass
class RendezvousInfo:
    """Addresses and ranks of every host of one allocation."""

    container_addrs: List[str]
    container_rank: int
    slot_ids: List[int]
    coordinator_addr: Optional[str] = None

    @property
    def num_hosts(self) -> int:
        return len(self.container_addrs)


@dataclasses.dataclass
class ClusterInfo:
    master_url: str
    cluster_id: str = "local"
    agent_id: str = "local"
    task_id: Optional[str] = None
    task_type: str = "TRIAL"
    allocation_id: Optional[str] = None
    # Fencing epoch of this allocation run: echoed on every call to the
    # master as X-Allocation-Epoch, so a superseded run's late writes are
    # refused (409). None: launched outside a fenced allocation.
    allocation_epoch: Optional[int] = None
    session_token: Optional[str] = None
    run_dir: Optional[str] = None
    trial: Optional[TrialInfo] = None
    rendezvous: Optional[RendezvousInfo] = None
    mesh_config: Optional[Dict[str, int]] = None
    tpu_worker_id: int = 0

    @property
    def task_container_rank(self) -> int:
        return self.rendezvous.container_rank if self.rendezvous else 0

    @classmethod
    def from_env(cls) -> Optional["ClusterInfo"]:
        master = _env("DET_MASTER")
        if master is None:
            return None
        run_dir = _env("DET_RUN_DIR")
        rendezvous = None
        info_file = os.path.join(run_dir, "info", "rendezvous.json") \
            if run_dir else None
        if info_file and os.path.exists(info_file):
            with open(info_file) as f:
                rendezvous = RendezvousInfo(**json.load(f))
        elif _env("DET_CONTAINER_ADDRS"):
            rendezvous = RendezvousInfo(
                container_addrs=_env("DET_CONTAINER_ADDRS", "").split(","),
                container_rank=int(_env("DET_CONTAINER_RANK", "0")),
                slot_ids=[int(s) for s in _env("DET_SLOT_IDS", "0").split(",")
                          if s],
                coordinator_addr=_env("DET_COORDINATOR_ADDR"),
            )
        mesh_cfg = _env("DET_MESH_CONFIG")
        epoch = _env("DET_ALLOCATION_EPOCH")
        return cls(
            master_url=master,
            cluster_id=_env("DET_CLUSTER_ID", "local"),
            agent_id=_env("DET_AGENT_ID", "local"),
            task_id=_env("DET_TASK_ID"),
            task_type=_env("DET_TASK_TYPE", "TRIAL"),
            allocation_id=_env("DET_ALLOCATION_ID"),
            allocation_epoch=int(epoch) if epoch is not None else None,
            session_token=_env("DET_SESSION_TOKEN"),
            run_dir=run_dir,
            trial=TrialInfo._from_env(),
            rendezvous=rendezvous,
            mesh_config=json.loads(mesh_cfg) if mesh_cfg else None,
            tpu_worker_id=int(_env("DET_TPU_WORKER_ID", "0")),
        )


def get_cluster_info() -> Optional[ClusterInfo]:
    """The environment's ClusterInfo, read afresh on each call; None
    outside a task the cluster launched (local mode)."""
    return ClusterInfo.from_env()
