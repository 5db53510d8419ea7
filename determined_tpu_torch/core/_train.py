"""TrainContext — metric reporting.

Counterpart of determined_tpu/core/_train.py. In managed mode reports go
to the master: `POST /api/v1/trials/{id}/metrics` (idempotency-keyed),
`/progress` and `/runner/metadata` (the trial's status). Without a master
they are kept in memory (`local_training_metrics`,
`local_validation_metrics`, and `local_other_metrics` for other groups
such as the profiler's) and logged. The per-trial tensorboard manager,
where core.init built one, sees every report. In a run of several
processes only the chief reports; the Trainer's metrics are already the
means over every rank.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, List

logger = logging.getLogger("determined_tpu_torch.core")


def _clean_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-safe scalars: tensors -> python floats; NaN/Inf -> strings."""
    out: Dict[str, Any] = {}
    for k, v in metrics.items():
        if hasattr(v, "item"):
            try:
                v = v.item()
            except Exception:
                continue
        if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
            v = str(v)
        out[k] = v
    return out


class TrainContext:
    def __init__(self, session=None, trial_id: int = 0, run_id: int = 0,
                 tensorboard_manager=None, distributed=None):
        self._session = session
        self._dist = distributed
        self._trial_id = trial_id
        self._run_id = run_id
        self._tb = tensorboard_manager
        self.local_training_metrics: List[Dict[str, Any]] = []
        self.local_validation_metrics: List[Dict[str, Any]] = []
        self.local_other_metrics: List[Dict[str, Any]] = []

    def _is_chief(self) -> bool:
        return self._dist is None or self._dist.is_chief

    def _report(self, group: str, steps_completed: int,
                metrics: Dict[str, Any]) -> None:
        if not self._is_chief():
            return
        metrics = _clean_metrics(metrics)
        if self._tb is not None:
            self._tb.on_metrics(group, steps_completed, metrics)
        record = {
            "trial_id": self._trial_id,
            "trial_run_id": self._run_id,
            "group": group,
            "steps_completed": steps_completed,
            "metrics": metrics,
            "report_time": time.time(),
        }
        if self._session is not None:
            # Idempotent: a retry after a lost response must not count
            # this report twice.
            self._session.post(f"/api/v1/trials/{self._trial_id}/metrics",
                               body=record, idempotent=True)
            return
        store = {"training": self.local_training_metrics,
                 "validation": self.local_validation_metrics}.get(
                     group, self.local_other_metrics)
        store.append(record)
        logger.info("[%s] step=%d %s", group, steps_completed, metrics)

    def report_training_metrics(self, steps_completed: int,
                                metrics: Dict[str, Any]) -> None:
        self._report("training", steps_completed, metrics)

    def report_validation_metrics(self, steps_completed: int,
                                  metrics: Dict[str, Any]) -> None:
        self._report("validation", steps_completed, metrics)

    def report_metrics(self, group: str, steps_completed: int,
                       metrics: Dict[str, Any]) -> None:
        """Arbitrary metric groups (e.g. the profiler's "profiling")."""
        self._report(group, steps_completed, metrics)

    def report_progress(self, progress: float) -> None:
        if self._session is None or not self._is_chief():
            return
        self._session.post(f"/api/v1/trials/{self._trial_id}/progress",
                           body={"progress": float(progress)})

    def set_status(self, status: str) -> None:
        if self._session is None or not self._is_chief():
            return
        try:
            self._session.post(
                f"/api/v1/trials/{self._trial_id}/runner/metadata",
                body={"state": status})
        except Exception:
            logger.debug("set_status(%s) failed", status, exc_info=True)
