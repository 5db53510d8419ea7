"""SearcherContext — the trial side of HP search, local mode.

Counterpart of determined_tpu/core/_searcher.py without a master:
`operations()` yields one op, "train until `local_max_length`", and a
completed op's searcher metric is kept in `completed_metrics`.
"""

from __future__ import annotations

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
        self._context.completed_metrics.append(
            (self.length, float(searcher_metric)))


class SearcherContext:
    def __init__(self, local_max_length: Optional[int] = None):
        self._local_max_length = local_max_length
        self.completed_metrics: List[Tuple[int, float]] = []

    def operations(self) -> Iterator[SearcherOperation]:
        length = self._local_max_length
        if length is None:
            raise RuntimeError(
                "local mode needs local_max_length (pass max_length to init())"
            )
        yield SearcherOperation(self, length)
