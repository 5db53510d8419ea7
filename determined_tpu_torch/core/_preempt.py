"""PreemptContext — cooperative and deadline preemption.

Counterpart of determined_tpu/core/_preempt.py. In managed mode a daemon
thread long-polls `GET /api/v1/allocations/{aid}/signals/preemption`; the
training loop polls `should_preempt()` at step boundaries, acknowledges
the signal (`POST .../signals/ack_preemption`), checkpoints and exits.
Two kinds of preemption ride the same signal:

  - cooperative (the scheduler's: a pause, a job of higher priority): no
    deadline; the trial checkpoints and exits whenever it gets there;
  - deadline (the infrastructure's: a spot reclaim, maintenance): the
    signal carries `deadline_seconds`, and `preemption_deadline()` counts
    the grace left down, so the Trainer can budget its emergency
    checkpoint.

A signal may also carry an elastic resize offer (`resize`,
`target_slots`), read by `resize_target()`. Without a master nothing
signals; `force()` and `force_resize()` act as if the master had. In a
run of several processes only the chief watches and acknowledges; the
flag, the deadline and the resize target are broadcast from it, so every
rank takes the same decision (a checkpoint is a collective).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

logger = logging.getLogger("determined_tpu_torch.core")


class _PreemptionWatcher(threading.Thread):
    """Daemon thread long-polling the master for the preemption signal."""

    def __init__(self, session, allocation_id: str, poll_timeout: int = 60,
                 backoff_base: float = 0.5, backoff_cap: float = 10.0):
        super().__init__(daemon=True, name="preemption-watcher")
        self._session = session
        self._allocation_id = allocation_id
        self._poll_timeout = poll_timeout
        self._backoff_base = backoff_base
        self._backoff_cap = backoff_cap
        self._preempted = threading.Event()
        self._stop_evt = threading.Event()
        self._deadline: Optional[float] = None  # time.monotonic() absolute
        self._reason: Optional[str] = None
        self._resize_target: Optional[int] = None

    def _backoff(self, backoff: float) -> float:
        backoff = min(self._backoff_cap, max(self._backoff_base, backoff * 2))
        self._stop_evt.wait(backoff)
        return backoff

    def run(self) -> None:
        backoff = 0.0
        while not self._stop_evt.is_set():
            try:
                resp = self._session.get(
                    f"/api/v1/allocations/{self._allocation_id}/signals/"
                    "preemption",
                    params={"timeout_seconds": self._poll_timeout},
                    timeout=self._poll_timeout + 30)
            except Exception:
                if self._stop_evt.is_set():
                    return
                logger.debug("preemption poll failed; retrying",
                             exc_info=True)
                backoff = self._backoff(backoff)
                continue
            if not isinstance(resp, dict):
                # A successful but empty or malformed answer (a master
                # restarting behind a proxy): back off instead of spinning.
                backoff = self._backoff(backoff)
                continue
            backoff = 0.0
            if not resp.get("preempt"):
                # The master's wait ran out without a signal: poll again at
                # once; that is the long-poll protocol.
                continue
            self._take_signal(resp)
            self._preempted.set()
            return

    def _take_signal(self, resp: dict) -> None:
        deadline = resp.get("deadline_seconds")
        if deadline is not None:
            try:
                self._deadline = time.monotonic() + max(0.0, float(deadline))
            except (TypeError, ValueError):
                logger.warning("unparseable preemption deadline %r; "
                               "treating as unbounded", deadline)
        self._reason = resp.get("reason") or None
        if resp.get("resize"):
            try:
                target = int(resp.get("target_slots"))
            except (TypeError, ValueError):
                target = 0
            if target > 0:
                self._resize_target = target
            else:
                logger.warning("resize signal with unusable target_slots %r;"
                               " treating as a plain preemption",
                               resp.get("target_slots"))

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    @property
    def deadline(self) -> Optional[float]:
        """Absolute time.monotonic() deadline, set before `preempted`."""
        return self._deadline

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    @property
    def resize_target(self) -> Optional[int]:
        return self._resize_target

    def close(self, timeout: float = 5.0) -> None:
        """Stop and join, bounded: a watcher inside a live long-poll
        returns at the poll's timeout, and the bound keeps close() from
        waiting for it (the daemon thread lingers until then)."""
        self._stop_evt.set()
        if self.ident is not None:
            self.join(timeout=timeout)


class PreemptContext:
    def __init__(self, session=None, allocation_id: Optional[str] = None,
                 distributed=None):
        self._session = session
        self._allocation_id = allocation_id
        self._dist = distributed
        self._watcher: Optional[_PreemptionWatcher] = None
        self._forced = False
        self._forced_deadline: Optional[float] = None  # monotonic absolute
        self._forced_resize: Optional[int] = None
        self._start_watcher()

    def _watches(self) -> bool:
        return self._session is not None and bool(self._allocation_id) \
            and (self._dist is None or self._dist.is_chief)

    def _shared(self) -> bool:
        return self._dist is not None and self._dist.size > 1

    def _start_watcher(self) -> None:
        if self._watches():
            self._watcher = _PreemptionWatcher(self._session,
                                               self._allocation_id)
            self._watcher.start()

    def should_preempt(self, auto_ack: bool = True) -> bool:
        flag = self._forced or (self._watcher is not None
                                and self._watcher.preempted)
        if self._shared():
            flag = bool(self._dist.broadcast(int(flag)))
        if flag and auto_ack:
            self.acknowledge_preemption_signal()
        return flag

    def preemption_deadline(self) -> Optional[float]:
        """Seconds left in the termination grace window; None for an
        unbounded preemption or none at all. Counts down between calls.
        Broadcast from the chief."""
        remaining: Optional[float] = None
        if self._forced_deadline is not None:
            remaining = max(0.0, self._forced_deadline - time.monotonic())
        elif self._watcher is not None and self._watcher.deadline is not None:
            remaining = max(0.0, self._watcher.deadline - time.monotonic())
        if self._shared():
            value = float(self._dist.broadcast(
                -1.0 if remaining is None else float(remaining)))
            remaining = None if value < 0 else value
        return remaining

    def resize_target(self) -> Optional[int]:
        """The slot count of an elastic resize offer, or None when the
        preemption (if any) is an ordinary one. Broadcast from the chief."""
        target: Optional[int] = None
        if self._forced_resize is not None:
            target = self._forced_resize
        elif self._watcher is not None:
            target = self._watcher.resize_target
        if self._shared():
            value = int(self._dist.broadcast(-1 if target is None
                                             else int(target)))
            target = None if value <= 0 else value
        return target

    def preemption_reason(self) -> Optional[str]:
        """Why ("spot_preemption", "host_maintenance", ...); None when
        unknown or not preempted."""
        if self._watcher is not None and self._watcher.reason:
            return self._watcher.reason
        return "forced" if self._forced else None

    def acknowledge_preemption_signal(self) -> None:
        """Tell the master the signal was seen: the trial checkpoints and
        exits."""
        if not self._watches():
            return
        try:
            self._session.post(f"/api/v1/allocations/{self._allocation_id}/"
                               "signals/ack_preemption")
        except Exception:
            logger.debug("ack_preemption failed", exc_info=True)

    def force(self, deadline: Optional[float] = None) -> None:
        """Behave as if preempted, with a termination deadline `deadline`
        seconds out when given."""
        self._forced = True
        if deadline is not None:
            self._forced_deadline = time.monotonic() + deadline

    def force_resize(self, target_slots: int,
                     deadline: Optional[float] = None) -> None:
        """Behave as if the scheduler offered a resize to `target_slots`."""
        self._forced_resize = int(target_slots)
        self.force(deadline=deadline)

    def reset(self) -> None:
        """Re-arm after a consumed signal: clear the flags and watch for
        the next one."""
        self._forced = False
        self._forced_deadline = None
        self._forced_resize = None
        if self._watcher is not None:
            self._watcher.close()
            self._watcher = None
        self._start_watcher()

    def close(self) -> None:
        if self._watcher is not None:
            self._watcher.close()
