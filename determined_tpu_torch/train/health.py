"""Trial health — divergence sentinel + watchdog configuration.

The port's copy of determined_tpu/train/health.py (pure Python). The
self-healing loop's policy knobs (docs/checkpointing.md). The train step
folds an all-finite reduction over (loss, grad-norm) into its metrics — one
logical-and on the device, fetched with the regular per-flush metrics
batch, so detection costs no extra host sync. What happens when it trips
is configured here:

    health:
      on_nan: warn | rollback | fail   # default warn
      rollback_window: 8               # batches skipped past the NaN
      max_rollbacks: 3                 # rollback->fail escalation
      step_timeout_sec: 0              # step watchdog; 0 = disabled

A trial can override the experiment config with a `health` attribute
(a trial attribute wins over the experiment config).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

ON_NAN_POLICIES = ("warn", "rollback", "fail")


class DivergenceError(RuntimeError):
    """Raised when training diverges (non-finite loss/grads) under
    `on_nan: fail`, or when `on_nan: rollback` exhausts `max_rollbacks`."""

    def __init__(self, step: int, detail: str = ""):
        msg = f"training diverged at step {step} (non-finite loss/gradients)"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.step = step


@dataclasses.dataclass
class HealthConfig:
    """Resolved `health:` knobs (trial attribute over expconf block)."""

    on_nan: str = "warn"
    rollback_window: int = 8
    max_rollbacks: int = 3
    step_timeout_sec: float = 0.0  # 0 = watchdog disabled

    @classmethod
    def from_block(cls, block: Any) -> "HealthConfig":
        if block is None:
            return cls()
        if not isinstance(block, dict):
            raise TypeError(
                f"health config must be a mapping, got {type(block).__name__}")
        on_nan = str(block.get("on_nan", "warn"))
        if on_nan not in ON_NAN_POLICIES:
            raise ValueError(
                f"health.on_nan must be one of {ON_NAN_POLICIES}, "
                f"got {on_nan!r}")
        return cls(
            on_nan=on_nan,
            rollback_window=max(0, int(block.get("rollback_window", 8))),
            max_rollbacks=max(1, int(block.get("max_rollbacks", 3))),
            step_timeout_sec=float(block.get("step_timeout_sec", 0.0)),
        )

    @classmethod
    def resolve(cls, trial: Any = None,
                expconf: Optional[Dict[str, Any]] = None) -> "HealthConfig":
        trial_attr = getattr(trial, "health", None)
        if trial_attr is not None:
            return cls.from_block(trial_attr)
        if isinstance(expconf, dict) and expconf.get("health") is not None:
            return cls.from_block(expconf.get("health"))
        return cls()


@dataclasses.dataclass
class PreemptionConfig:
    """Resolved `preemption:` knobs — the spot-survival emergency
    checkpoint and its deadline budget (docs/checkpointing.md):

        preemption:
          emergency_checkpoint: true   # save out-of-band on a deadline
          budget_safety_factor: 1.5    # estimate multiplier before skipping
          budget_margin_sec: 2.0       # reserved for clean exit + reports

    Trial attribute `preemption` overrides the expconf block (same
    precedence contract as `TorchTrial.health`).
    """

    emergency_checkpoint: bool = True
    budget_safety_factor: float = 1.5
    budget_margin_sec: float = 2.0

    @classmethod
    def from_block(cls, block: Any) -> "PreemptionConfig":
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(emergency_checkpoint=block)
        if not isinstance(block, dict):
            raise TypeError(
                "preemption config must be a mapping or bool, got "
                f"{type(block).__name__}")
        return cls(
            emergency_checkpoint=bool(block.get("emergency_checkpoint", True)),
            budget_safety_factor=max(
                1.0, float(block.get("budget_safety_factor", 1.5))),
            budget_margin_sec=max(
                0.0, float(block.get("budget_margin_sec", 2.0))),
        )

    @classmethod
    def resolve(cls, trial: Any = None,
                expconf: Optional[Dict[str, Any]] = None) -> "PreemptionConfig":
        trial_attr = getattr(trial, "preemption", None)
        if trial_attr is not None:
            return cls.from_block(trial_attr)
        if isinstance(expconf, dict) and expconf.get("preemption") is not None:
            return cls.from_block(expconf.get("preemption"))
        return cls()

    def should_attempt_save(self, remaining_sec: Optional[float],
                            last_save_ms: Optional[float]) -> bool:
        """The deadline-budget decision: is an emergency checkpoint worth
        starting, or would it produce an uncommitted torso?

        `remaining_sec` is the grace left (None = unbounded — always
        save); `last_save_ms` the observed durable-save cost (None = no
        estimate yet — attempt optimistically: a blown budget still can't
        corrupt restore, the two-phase commit just leaves a PARTIAL that
        lineage fallback skips)."""
        if not self.emergency_checkpoint:
            return False
        if remaining_sec is None:
            return True
        budget_ms = (remaining_sec - self.budget_margin_sec) * 1000.0
        if budget_ms <= 0:
            return False
        if last_save_ms is None:
            return True
        return last_save_ms * self.budget_safety_factor <= budget_ms
