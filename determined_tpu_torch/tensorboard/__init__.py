"""Per-trial tensorboard events, synced into checkpoint storage.

The port's copy of determined_tpu/tensorboard/__init__.py. The chief of a
managed trial writes its metric reports as tfevents into a local
directory, and a background thread uploads that directory into the
checkpoint storage (a storage manager, storage/) every `sync_period`
seconds and on `close()`, at
``<storage base>/tensorboard/<experiment_id>/<trial_id>/``.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
from typing import Any, Dict, Optional

logger = logging.getLogger("determined_tpu_torch.tensorboard")


def storage_prefix(experiment_id: int, trial_id: int) -> str:
    return os.path.join("tensorboard", str(experiment_id), str(trial_id))


class MetricWriter:
    """Scalar tfevents writer (torch.utils.tensorboard, where the host has
    the tensorboard package; without it, a warning and no events)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=log_dir)
        except Exception:
            logger.warning("tensorboard writer unavailable", exc_info=True)

    def add_scalars(self, metrics: Dict[str, Any], step: int,
                    prefix: str = "") -> None:
        if self._writer is None:
            return
        for key, value in metrics.items():
            try:
                self._writer.add_scalar(
                    f"{prefix}{key}" if prefix else key, float(value), step)
            except (TypeError, ValueError):
                continue

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class TensorboardManager:
    """Writes tfevents locally and syncs them into `storage` (None: no
    sync)."""

    def __init__(self, storage, experiment_id: int,
                 trial_id: int, base_dir: Optional[str] = None,
                 sync_period: float = 10.0):
        self._storage = storage
        self._prefix = storage_prefix(experiment_id, trial_id)
        self.log_dir = base_dir or os.path.join(
            tempfile.gettempdir(), "determined_tpu_torch", "tensorboard",
            str(experiment_id), str(trial_id))
        self.writer = MetricWriter(self.log_dir)
        self._sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if storage is not None:
            self._thread = threading.Thread(
                target=self._sync_loop, daemon=True, name="tensorboard-sync")
            self._thread.start()

    def on_metrics(self, group: str, steps_completed: int,
                   metrics: Dict[str, Any]) -> None:
        self.writer.add_scalars(metrics, steps_completed, prefix=f"{group}/")

    def sync(self) -> None:
        if self._storage is None:
            return
        self.writer.flush()
        try:
            self._storage.upload(self.log_dir, self._prefix)
        except Exception:
            logger.debug("tensorboard sync failed", exc_info=True)

    def _sync_loop(self) -> None:
        while not self._stop.wait(self._sync_period):
            self.sync()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.sync()
        self.writer.close()
