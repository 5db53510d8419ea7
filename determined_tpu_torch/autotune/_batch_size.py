"""Batch-size autotune search method, the port's copy of
determined_tpu/autotune/_batch_size.py (reference dsat
_dsat_search_method.py: DSATTrialTracker :169, BinarySearchDSATSearchMethod
:965 — re-derived for the batch-size knob)."""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from determined_tpu_torch.searcher import (
    Close,
    Create,
    Operation,
    SearchMethod,
    Shutdown,
    ValidateAfter,
)

logger = logging.getLogger("determined_tpu_torch.autotune")


class BatchSizeSearchMethod(SearchMethod):
    """Find the highest-throughput global batch size.

    Phase 1 (cliff hunt): trials at start_size, 2x, 4x, ... run
    `profile_steps` batches each and report samples_per_second; the first
    failure (OOM kills the trial -> exited_early) bounds the search.
    Phase 2 (binary search): midpoints between the last good and first bad
    size until the window is tight.

    The winner is the size with the best throughput; `best()` returns
    (batch_size, samples_per_second). Extra hparams (e.g. {"remat": True})
    pass through to every trial.
    """

    def __init__(
        self,
        start_size: int = 8,
        max_size: int = 4096,
        profile_steps: int = 20,
        base_hparams: Optional[Dict[str, Any]] = None,
        window_factor: float = 1.25,
    ):
        self.start_size = start_size
        self.max_size = max_size
        self.profile_steps = profile_steps
        self.base_hparams = dict(base_hparams or {})
        self.window_factor = window_factor

        self.results: Dict[int, float] = {}  # size -> samples/sec
        self.failed_sizes: List[int] = []
        self._inflight: Dict[str, int] = {}  # request_id -> size
        self._good_bound = 0
        self._bad_bound: Optional[int] = None
        self._retried: set = set()  # sizes given a second chance
        self._done = False

    # -- the search ----------------------------------------------------

    def _launch(self, size: int) -> List[Operation]:
        hp = dict(self.base_hparams)
        hp["global_batch_size"] = size
        create = Create(hparams=hp)
        self._inflight[create.request_id] = size
        logger.info("autotune: trying global_batch_size=%d", size)
        return [create, ValidateAfter(create.request_id, self.profile_steps)]

    def _next_size(self) -> Optional[int]:
        if self._bad_bound is None:
            # cliff hunt: keep doubling
            nxt = self._good_bound * 2 if self._good_bound else self.start_size
            return nxt if nxt <= self.max_size else None
        # binary search inside (good, bad)
        lo, hi = self._good_bound, self._bad_bound
        if lo == 0:  # even start_size failed
            return None
        mid = (lo + hi) // 2
        if mid <= lo or hi <= lo * self.window_factor:
            return None  # window tight enough
        return mid

    def _advance(self) -> List[Operation]:
        if self._inflight:
            return []
        nxt = self._next_size()
        if nxt is None:
            self._done = True
            if self.results:
                size, sps = self.best()
                logger.info(
                    "autotune: best global_batch_size=%d (%.1f samples/s)",
                    size, sps)
            return [Shutdown()]
        return self._launch(nxt)

    # -- SearchMethod interface ---------------------------------------

    def initial_operations(self) -> List[Operation]:
        return self._launch(self.start_size)

    def on_validation_completed(self, request_id: str, metric: float,
                                train_length: int) -> List[Operation]:
        size = self._inflight.get(request_id)
        if size is None:
            return []
        # metric = samples_per_second (larger is better; the experiment
        # config must set searcher.smaller_is_better: false)
        self.results[size] = metric
        self._good_bound = max(self._good_bound, size)
        return [Close(request_id)]

    def on_trial_closed(self, request_id: str) -> List[Operation]:
        self._inflight.pop(request_id, None)
        return self._advance()

    def on_trial_exited_early(self, request_id: str,
                              reason: str) -> List[Operation]:
        size = self._inflight.pop(request_id, None)
        if size is None:
            return self._advance()
        if reason == "user_canceled":
            # Not a memory signal — stop the search cleanly.
            self._done = True
            return [Shutdown(cancel=True)]
        logger.info("autotune: global_batch_size=%d failed (%s)",
                    size, reason)
        # A crash is not necessarily OOM (flaky node, preemption): give
        # each size ONE retry before treating it as the memory cliff —
        # a mis-set bad bound would converge on a far-too-small batch.
        if size not in self._retried:
            self._retried.add(size)
            return self._launch(size)
        self.failed_sizes.append(size)
        if self._bad_bound is None or size < self._bad_bound:
            self._bad_bound = size
        return self._advance()

    def progress(self) -> float:
        if self._done:
            return 1.0
        if self._bad_bound is None:
            return min(0.5, 0.1 * len(self.results))
        return 0.5 + 0.5 * min(1.0, len(self.results) / 6.0)

    def best(self) -> tuple:
        size = max(self.results, key=lambda s: self.results[s])
        return size, self.results[size]
