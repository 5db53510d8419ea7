"""Python-side fault points — the harness mirror of native/common/faultpoint.

The port's own copy of determined_tpu/common/faultpoint.py (the port
imports nothing of the JAX package), with the same grammar and behaviour.

The native master/agent compile in named fault points armed via
``DET_FAULTS`` (docs/chaos.md). Training-side Python subsystems (the async
input pipeline, checkpointing) need the same lever so chaos runs can
exercise *harness* recovery paths — an iterator dying mid-epoch, a stalled
H2D queue — with the exact same grammar and determinism guarantees:

    DET_FAULTS=point:mode[:param][,point:mode[:param]...]

Modes: ``error`` (raise FaultInjected at the call site), ``drop`` (swallow
the operation — e.g. skip queuing a batch), ``delay-<ms>`` (sleep, then
proceed), ``crash`` (``os._exit(137)``). The optional param is an integer
count (fire N times then auto-disarm) or a probability (``0.3`` / ``30%``)
drawn from a PRNG seeded by ``DET_FAULTS_SEED`` so runs are reproducible.

Unarmed points cost one module-global check. Call sites use::

    action = faultpoint.fire("data.prefetch.queue")
    if action is Action.ERROR:
        raise FaultInjected("data.prefetch.queue")
    if action is Action.DROP:
        continue
"""

from __future__ import annotations

import enum
import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger("determined_tpu_torch.common")


class Action(enum.Enum):
    NONE = "none"    # not armed / did not fire — proceed normally
    ERROR = "error"  # the call site must fail the operation
    DROP = "drop"    # the call site must swallow the operation


class FaultInjected(RuntimeError):
    """Raised by call sites honoring an `error`-mode fault point."""

    def __init__(self, point: str):
        super().__init__(f"fault injected at {point!r} (DET_FAULTS)")
        self.point = point


class _Arm:
    def __init__(self, mode: str, count: int, probability: float):
        self.mode = mode            # error | drop | crash | delay-<ms>
        self.count = count          # >0: fire N times then disarm; else ∞
        self.probability = probability  # (0,1] gates each hit; 0 = always
        self.fired = 0


_lock = threading.Lock()
_arms: Dict[str, _Arm] = {}
_n_armed = 0  # fast-path check without the lock
_rng: Optional[random.Random] = None
_env_loaded = False


def _get_rng() -> random.Random:
    global _rng
    if _rng is None:
        _rng = random.Random(int(os.environ.get("DET_FAULTS_SEED", "1337")))
    return _rng


def arm(point: str, mode: str, count: int = 0,
        probability: float = 0.0) -> None:
    """Arm `point`. See module docstring for mode/param semantics."""
    global _n_armed
    if mode not in ("error", "drop", "crash") and \
            not mode.startswith("delay-"):
        raise ValueError(f"faultpoint: unknown mode {mode!r}")
    if mode.startswith("delay-"):
        int(mode[len("delay-"):])  # validate now, not at fire time
    with _lock:
        _arms[point] = _Arm(mode, count, probability)
        _n_armed = len(_arms)


def disarm(point: str) -> None:
    global _n_armed
    with _lock:
        _arms.pop(point, None)
        _n_armed = len(_arms)


def disarm_all() -> None:
    global _n_armed, _env_loaded
    with _lock:
        _arms.clear()
        _n_armed = 0
        _env_loaded = True  # explicit reset wins over the env spec


def armed() -> List[str]:
    with _lock:
        return sorted(_arms)


def arm_from_spec(spec: str) -> None:
    """DET_FAULTS grammar: point:mode[:param][,point:mode[:param]...]."""
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(f"faultpoint: bad entry {entry!r}")
        point, mode = parts[0], parts[1]
        count, probability = 0, 0.0
        if len(parts) >= 3 and parts[2]:
            param = parts[2]
            if param.endswith("%"):
                probability = float(param[:-1]) / 100.0
            elif "." in param:
                probability = float(param)
            else:
                count = int(param)
        arm(point, mode, count=count, probability=probability)


def reload_env() -> None:
    """Drop all arms and re-read DET_FAULTS (test hook; the native services
    only read the env at process start)."""
    global _env_loaded
    disarm_all()
    _env_loaded = False
    _load_env_once()


def _load_env_once() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get("DET_FAULTS", "")
    if not spec:
        return
    try:
        arm_from_spec(spec)
        logger.warning("faultpoint: armed from DET_FAULTS=%s", spec)
    except (ValueError, TypeError) as e:
        logger.error("faultpoint: DET_FAULTS rejected: %s", e)


def fire(point: str) -> Action:
    """Hot-path hook: applies delay/crash internally, returns the action
    the call site must honor. Decrements counted arms."""
    global _n_armed
    _load_env_once()
    if not _n_armed:
        return Action.NONE
    with _lock:
        a = _arms.get(point)
        if a is None:
            return Action.NONE
        if a.probability and _get_rng().random() >= a.probability:
            return Action.NONE
        a.fired += 1
        if a.count > 0 and a.fired >= a.count:
            del _arms[point]
            _n_armed = len(_arms)
        mode = a.mode
    if mode == "crash":
        logger.error("faultpoint: %s crash — _exit(137)", point)
        os._exit(137)
    if mode.startswith("delay-"):
        time.sleep(int(mode[len("delay-"):]) / 1000.0)
        return Action.NONE
    return Action.ERROR if mode == "error" else Action.DROP
