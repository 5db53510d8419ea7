"""Core API v2: a module-level context bound to an unmanaged experiment
and trial that `init` registers with the master (counterpart of
determined_tpu/experimental/core_v2/_core_v2.py)."""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional

from determined_tpu_torch.common.api import Session
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.core._searcher import SearcherContext
from determined_tpu_torch.core._train import TrainContext
from determined_tpu_torch.storage import from_config
from determined_tpu_torch.storage.base import StorageManager


class Context:
    """An unmanaged run bound to a master-tracked experiment and trial."""

    def __init__(self, session: Session, experiment_id: int, trial_id: int,
                 storage: StorageManager, max_length: Optional[int] = None):
        self.experiment_id = experiment_id
        self.trial_id = trial_id
        self._session = session
        self.distributed = DistributedContext.local()
        self.train = TrainContext(session, trial_id=trial_id)
        # The run owns its loop: the searcher is local, one op of
        # max_length.
        self.searcher = SearcherContext(None, trial_id=trial_id,
                                        local_max_length=max_length)
        self.checkpoint = CheckpointContext(storage, trial_id=trial_id,
                                            session=session)

    def close(self, state: str = "COMPLETED") -> None:
        self.checkpoint.close()
        try:
            self._session.post(
                f"/api/v1/experiments/{self.experiment_id}/complete",
                body={"state": state})
        except Exception as e:
            # close() runs in finally blocks and must not raise, but a run
            # left RUNNING in the master must not pass unnoticed either.
            warnings.warn(
                f"core_v2.close: failed to report final state {state!r} for "
                f"experiment {self.experiment_id} to the master: {e}; the "
                "run will appear RUNNING until completed manually",
                RuntimeWarning)


class _Active:
    """The context `init` bound, shared by the module-level handles."""

    ctx: Optional[Context] = None


def init(*, config: Optional[Dict[str, Any]] = None,
         master: Optional[str] = None, user: str = "determined",
         password: str = "", hparams: Optional[Dict[str, Any]] = None,
         checkpoint_storage: Optional[Dict[str, Any]] = None,
         max_length: Optional[int] = None) -> Context:
    """Log in, register an unmanaged experiment and trial with the master,
    and bind the module-level train/checkpoint/searcher handles to them.
    Checkpoints go to `checkpoint_storage` (any type storage/ reads)."""
    config = dict(config or {})
    config.setdefault("name", "unmanaged-run")
    config.setdefault(
        "searcher",
        {"name": "single", "metric": config.get("metric", "loss"),
         "max_length": {"batches": max_length or 0}})
    if hparams:
        config.setdefault("hyperparameters", hparams)
    storage = from_config(checkpoint_storage
                          or config.get("checkpoint_storage"))
    master = master or os.environ.get("DET_MASTER", "http://127.0.0.1:8080")
    session = Session.login(master, user, password)
    exp = session.post("/api/v1/experiments",
                       body={"config": config, "unmanaged": True})
    eid = exp["id"]
    trial = session.post(f"/api/v1/experiments/{eid}/trials",
                         body={"hparams": hparams or {}})
    _Active.ctx = Context(session, eid, trial["id"], storage,
                          max_length=max_length)
    return _Active.ctx


def close(state: str = "COMPLETED") -> None:
    if _Active.ctx is not None:
        ctx, _Active.ctx = _Active.ctx, None
        ctx.close(state)


class _Proxy:
    """A module-level handle that resolves to the active context's part."""

    def __init__(self, attr: str):
        self._attr = attr

    def __getattr__(self, name: str) -> Any:
        if _Active.ctx is None:
            raise RuntimeError("core_v2.init() has not been called")
        return getattr(getattr(_Active.ctx, self._attr), name)


train = _Proxy("train")
checkpoint = _Proxy("checkpoint")
searcher = _Proxy("searcher")
