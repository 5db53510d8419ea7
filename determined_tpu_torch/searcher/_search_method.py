"""SearchMethod ABC + operations, the port's copy of
determined_tpu/searcher/_search_method.py (reference _search_method.py)."""

from __future__ import annotations

import abc
import uuid
from typing import Any, Dict, List, Optional


class Operation:
    """Base class for searcher operations sent to the master."""

    def to_json(self) -> Dict[str, Any]:
        raise NotImplementedError


class Create(Operation):
    """Create a trial with the given hparams (reference Create op)."""

    def __init__(self, hparams: Dict[str, Any],
                 request_id: Optional[str] = None, seed: int = 0):
        self.request_id = request_id or f"custom-{uuid.uuid4().hex[:12]}"
        self.hparams = hparams
        self.seed = seed

    def to_json(self) -> Dict[str, Any]:
        return {"type": "Create", "request_id": self.request_id,
                "hparams": self.hparams, "seed": self.seed}


class ValidateAfter(Operation):
    """Train the trial to `length` cumulative units, then validate."""

    def __init__(self, request_id: str, length: int):
        self.request_id = request_id
        self.length = int(length)

    def to_json(self) -> Dict[str, Any]:
        return {"type": "ValidateAfter", "request_id": self.request_id,
                "length": self.length}


class Close(Operation):
    def __init__(self, request_id: str):
        self.request_id = request_id

    def to_json(self) -> Dict[str, Any]:
        return {"type": "Close", "request_id": self.request_id}


class Shutdown(Operation):
    def __init__(self, cancel: bool = False, failure: bool = False):
        self.cancel = cancel
        self.failure = failure

    def to_json(self) -> Dict[str, Any]:
        return {"type": "Shutdown", "cancel": self.cancel,
                "failure": self.failure}


class Progress:
    """Wrapper for progress updates (reference _search_method Progress)."""

    def __init__(self, progress: float):
        self.progress = float(progress)


class SearchMethod(abc.ABC):
    """User-defined search logic; event handlers return operations.

    State the method keeps between events must be picklable if you want to
    resume a crashed runner (reference: searcher_state checkpointing); the
    master itself snapshots the pending event queue.
    """

    @abc.abstractmethod
    def initial_operations(self) -> List[Operation]:
        ...

    @abc.abstractmethod
    def on_validation_completed(self, request_id: str, metric: float,
                                train_length: int) -> List[Operation]:
        ...

    def on_trial_closed(self, request_id: str) -> List[Operation]:
        return []

    def on_trial_exited_early(self, request_id: str,
                              reason: str) -> List[Operation]:
        return []

    def progress(self) -> float:
        return 0.0
