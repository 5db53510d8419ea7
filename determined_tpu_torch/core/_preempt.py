"""PreemptContext — local mode.

Counterpart of determined_tpu/core/_preempt.py without a master: nothing
sends a preemption signal, so `should_preempt()` is False and there is no
deadline. The Trainer's preemption path stays (tests reach it by
replacing `should_preempt`); the master's signal watcher is not ported
(ROADMAP.md: managed mode).
"""

from __future__ import annotations

from typing import Optional


class PreemptContext:
    def should_preempt(self, auto_ack: bool = True) -> bool:
        return False

    def preemption_deadline(self) -> Optional[float]:
        """Seconds left in a termination grace window; None: unbounded."""
        return None

    def close(self) -> None:
        return None
