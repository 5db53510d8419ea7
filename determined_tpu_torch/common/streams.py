"""Streaming updates client, the port's copy of
determined_tpu/common/streams.py (reference
harness/determined/common/streams/_client.py over the master's websocket
publisher; here a long-poll generator over GET /api/v1/stream)."""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

from determined_tpu_torch.common.api import Session


class StreamClient:
    """Iterate entity-change events from the master.

        for event in StreamClient(session).subscribe(["experiments"]):
            ...  # {"seq": N, "entity": "experiments", "payload": {...}}

    `dropped=True` responses mean the server's ring overflowed past our
    cursor — the caller should re-list the entities it mirrors, then keep
    streaming (reference subscribers resync from the DB on overflow).
    """

    def __init__(self, session: Session, since: int = 0):
        self._session = session
        self.since = since
        self.dropped = False

    def poll(self, entities: Optional[Sequence[str]] = None,
             timeout_seconds: float = 30.0) -> list:
        params = {
            "since": str(self.since),
            "timeout_seconds": str(timeout_seconds),
        }
        if entities:
            params["entities"] = ",".join(entities)
        out = self._session.get("/api/v1/stream", params=params)
        events = out.get("events", [])
        # Overflow surfaces twice: the response-level `dropped` flag and a
        # synthetic `resync` event at the head of the batch — a consumer
        # that only walks events still learns it must re-list.
        self.dropped = (self.dropped or bool(out.get("dropped"))
                        or any(e.get("entity") == "resync" for e in events))
        if events:
            self.since = events[-1]["seq"]
        return events

    def subscribe(self, entities: Optional[Sequence[str]] = None,
                  timeout_seconds: float = 30.0) -> Iterator[dict]:
        """Infinite generator; blocks in long-polls between event batches."""
        while True:
            for event in self.poll(entities, timeout_seconds):
                yield event
