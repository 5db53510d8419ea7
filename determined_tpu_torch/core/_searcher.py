"""SearcherContext — the trial side of HP search.

Counterpart of determined_tpu/core/_searcher.py. `operations()` yields
`SearcherOperation`s: "train until `length`, then report the searcher
metric". In managed mode the trial long-polls
`GET /api/v1/trials/{id}/searcher/operation?last=&timeout_seconds=` for the
next op and completes each with an idempotent
`POST .../searcher/completed_operation`. A trial whose searcher has no op
for it within the idle grace (an ASHA trial paused in its rung) stops
cleanly and frees its device; the master reschedules it if a promotion
comes. Without a master, one op of `local_max_length` is yielded and a
completed op's metric is kept in `completed_metrics`. In a run of several
processes only the chief talks to the master; the op lengths are
broadcast, so every rank trains the same steps (a rank that ran ahead
would hang the collectives).
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Tuple


class SearcherOperation:
    def __init__(self, context: "SearcherContext", length: int,
                 completed: bool = False):
        self._context = context
        self.length = length  # cumulative units (batches) to train to
        self._completed = completed

    @property
    def completed(self) -> bool:
        return self._completed

    def report_completed(self, searcher_metric: float) -> None:
        if self._completed:
            raise RuntimeError("operation already completed")
        self._completed = True
        self._context._complete_operation(self, searcher_metric)


class SearcherContext:
    def __init__(self, session=None, trial_id: int = 0,
                 local_max_length: Optional[int] = None,
                 poll_interval: float = 2.0, distributed=None):
        self._session = session
        self._trial_id = trial_id
        self._dist = distributed
        self._local_max_length = local_max_length
        self._poll_interval = poll_interval
        self._idle_grace = 15.0  # seconds to wait for an op before exiting
        self.completed_metrics: List[Tuple[int, float]] = []

    def _get_next_op(self, last_length: int) -> dict:
        """Long-poll the master for the op after `last_length`:
        {"op": {"length": N}}, {"done": true}, or {"idle": true} once the
        idle grace has passed with neither."""
        deadline = time.time() + self._idle_grace
        while True:
            resp = self._session.get(
                f"/api/v1/trials/{self._trial_id}/searcher/operation",
                params={"last": last_length, "timeout_seconds": 10},
                timeout=40.0)
            if resp and (resp.get("done") or resp.get("op")):
                return resp
            if time.time() >= deadline:
                return {"idle": True}
            time.sleep(self._poll_interval)

    def _complete_operation(self, op: SearcherOperation,
                            metric: float) -> None:
        if self._session is None:
            self.completed_metrics.append((op.length, float(metric)))
            return
        if self._dist is not None and not self._dist.is_chief:
            return
        # Idempotent: a replayed report would pop the next op and advance
        # the searcher twice.
        self._session.post(
            f"/api/v1/trials/{self._trial_id}/searcher/completed_operation",
            body={"length": op.length, "searcher_metric": float(metric)},
            idempotent=True)

    def operations(self, auto_ack: bool = True, after: int = 0
                   ) -> Iterator[SearcherOperation]:
        """Yield ops until the searcher closes the trial (`done`) or has
        none for it (`idle`). Several processes: the chief asks the master
        and broadcasts each length (-1: stop) to the others. `after`: the
        length of an op the caller already holds (a rank an elastic
        resize takes in mid-op, handed the op by the chief): only the ops
        after it."""
        if self._session is None:
            length = self._local_max_length
            if length is None:
                raise RuntimeError(
                    "local mode needs local_max_length (pass max_length to "
                    "init())")
            if length > after:
                yield SearcherOperation(self, length)
            return
        last_length = after
        while True:
            length = -1
            if self._dist is None or self._dist.is_chief:
                resp = self._get_next_op(last_length)
                if not (resp.get("done") or resp.get("idle")):
                    length = int(resp["op"]["length"])
            if self._dist is not None and self._dist.size > 1:
                length = int(self._dist.broadcast(length))
            if length < 0:
                return
            yield SearcherOperation(self, length)
            last_length = length
