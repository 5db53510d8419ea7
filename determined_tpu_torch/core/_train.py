"""TrainContext — metric reporting, local mode.

Counterpart of determined_tpu/core/_train.py without a master: reports are
kept in memory (`local_training_metrics`, `local_validation_metrics`) and
logged, as the JAX package does when it has no session.
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
    def __init__(self, trial_id: int = 0, run_id: int = 0):
        self._trial_id = trial_id
        self._run_id = run_id
        self.local_training_metrics: List[Dict[str, Any]] = []
        self.local_validation_metrics: List[Dict[str, Any]] = []
        self.local_other_metrics: List[Dict[str, Any]] = []

    def _report(self, group: str, steps_completed: int,
                metrics: Dict[str, Any]) -> None:
        metrics = _clean_metrics(metrics)
        record = {
            "trial_id": self._trial_id,
            "trial_run_id": self._run_id,
            "group": group,
            "steps_completed": steps_completed,
            "metrics": metrics,
            "report_time": time.time(),
        }
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
