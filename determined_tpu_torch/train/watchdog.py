"""Step watchdog — detects a trial that is alive but stuck.

The port's copy of determined_tpu/train/watchdog.py; the device snapshot
reports `torch.cuda` memory.

A hung collective, a wedged host thread, or a deadlocked data loader leaves
the trial process running forever: the scheduler sees a healthy task, the
master sees heartbeats, and nothing restarts it. The watchdog closes that
gap: the Trainer beats it at every metrics flush (a flush is a real host
sync — the device has provably produced new step results), and a monitor
thread fires when no beat lands within ``health.step_timeout_sec``.

On fire it is deliberately LOUD, then fatal:

  1. every thread's stack is dumped via :mod:`faulthandler` to stderr (the
     task log) — the one artifact that makes a hang debuggable post-mortem;
  2. live device / allocation state is logged (device list, allocated and
     reserved CUDA memory) — distinguishes "device wedged" from "host
     wedged";
  3. the process exits with :data:`WATCHDOG_EXIT_CODE` (nonzero), for
     whatever restarts it to restart from a checkpoint that integrity
     verification guarantees is good. (The JAX package also posts the exit
     reason to the master; the port runs in local mode only.)

Chaos: the ``step.hang`` fault point in the Trainer's hot loop
(``DET_FAULTS=step.hang:delay-30000``) simulates the wedge deterministically
(docs/chaos.md).
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger("determined_tpu_torch.train")

# Distinct from 137 (SIGKILL / chaos crash) and ordinary tracebacks (1):
# greppable in task logs and agent exit reports.
WATCHDOG_EXIT_CODE = 87


def _dump_device_state(stream) -> None:
    """Best-effort live device/allocation snapshot for the task log."""
    try:
        import torch

        if not torch.cuda.is_available():
            print("watchdog: devices: no CUDA device", file=stream,
                  flush=True)
            return
        n = torch.cuda.device_count()
        print(f"watchdog: devices: "
              f"{[torch.cuda.get_device_name(i) for i in range(n)]}",
              file=stream, flush=True)
        for i in range(n):
            print(f"watchdog: cuda:{i}: "
                  f"{torch.cuda.memory_allocated(i) / (1 << 20):.1f} MiB "
                  f"allocated, "
                  f"{torch.cuda.memory_reserved(i) / (1 << 20):.1f} MiB "
                  "reserved", file=stream, flush=True)
    except Exception as e:  # the process is already doomed — never mask why
        print(f"watchdog: device state unavailable: {e}", file=stream,
              flush=True)


class StepWatchdog:
    """Monitor thread armed with a per-flush heartbeat.

    `timeout_sec` <= 0 disables the watchdog entirely (start() is a no-op).
    Tests inject `exit_fn` / `stream` to observe the firing without dying.
    """

    def __init__(
        self,
        timeout_sec: float,
        exit_fn: Callable[[int], None] = os._exit,
        stream=None,
    ):
        self.timeout_sec = float(timeout_sec)
        self._exit_fn = exit_fn
        self._stream = stream if stream is not None else sys.stderr
        self._beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    @property
    def enabled(self) -> bool:
        return self.timeout_sec > 0

    def beat(self) -> None:
        """Record progress. Called from the Trainer at every metrics flush
        (and after compile/restore/validation — any long legitimate gap)."""
        self._beat = time.monotonic()

    def start(self) -> "StepWatchdog":
        if not self.enabled or self._thread is not None:
            return self
        self.beat()
        self._thread = threading.Thread(
            target=self._run, name="det-step-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- internals -----------------------------------------------------

    def _run(self) -> None:
        # Poll at a fraction of the timeout: cheap, and a beat always has
        # a full window before the next check can fire.
        interval = max(0.05, min(self.timeout_sec / 4.0, 10.0))
        while not self._stop.wait(interval):
            idle = time.monotonic() - self._beat
            if idle >= self.timeout_sec:
                self._fire(idle)
                return

    def _fire(self, idle: float) -> None:
        self.fired = True
        print(
            f"watchdog: no training progress for {idle:.1f}s "
            f"(step_timeout_sec={self.timeout_sec:.1f}) — dumping all "
            "thread stacks and exiting for a scheduler restart",
            file=self._stream, flush=True)
        try:
            faulthandler.dump_traceback(file=self._stream, all_threads=True)
        except Exception as e:
            print(f"watchdog: stack dump failed: {e}", file=self._stream,
                  flush=True)
        _dump_device_state(self._stream)
        self._exit_fn(WATCHDOG_EXIT_CODE)
