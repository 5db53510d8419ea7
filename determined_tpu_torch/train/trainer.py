"""Trainer — owns the loop, on one CUDA device.

Counterpart of determined_tpu/train/trainer.py. `fit()` runs the searcher
operations: train to each op's length, flush metrics every `report_period`
steps (one device-to-host copy per flush, with `steps_per_second`),
validate with the per-batch sums kept on the device, checkpoint at op
boundaries and every `checkpoint_period` steps, and report the op
completed. Around the loop: the `step.hang` fault point, the step watchdog,
the divergence sentinel (`health.on_nan` fail / warn / rollback through
`core.checkpoint.lineage()`), `resume_from` restore with fallback through
the lineage, and the preemption checkpoint.

Not ported (ROADMAP.md): the compile farm and batch-size bucketing
(`_timed_first_call`, `FarmClient`; PyTorch runs eagerly and compiles
nothing here), elastic resize, meshes (data, fsdp, tensor, pipeline and
expert axes) and the device prefetcher. Batches reach the device with a
plain copy at the step that uses them, so no `input_wait_ms`, `h2d_ms` or
`prefetch_queue_depth` is reported. A trial whose `mesh_config()` asks for
more than one device raises.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from determined_tpu_torch import core as core_mod
from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.common import faultpoint
from determined_tpu_torch.train.health import (
    DivergenceError,
    HealthConfig,
    PreemptionConfig,
)
from determined_tpu_torch.train.state import TrainState, create_train_state
from determined_tpu_torch.train.step import make_eval_step, make_train_step
from determined_tpu_torch.train.trial import TorchTrial
from determined_tpu_torch.train.watchdog import StepWatchdog

logger = logging.getLogger("determined_tpu_torch.train")


def _repeat(iterable_factory) -> Iterator[Any]:
    while True:
        empty = True
        for batch in iterable_factory():
            empty = False
            yield batch
        if empty:
            raise RuntimeError("training data iterable is empty")


def _to_device(batch: Any, device: torch.device) -> Any:
    """A host batch (numpy arrays or tensors, nested in dicts, lists or
    tuples) on `device`."""
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(v, device) for v in batch)
    return batch


def _to_host(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Device scalars -> python floats with one device-to-host copy."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    host = {k: v for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].detach().float().reshape(())
                            for k in keys]).cpu().tolist()
        host.update(zip(keys, vals))
    return host


class Trainer:
    def __init__(self, trial: TorchTrial,
                 core_context: Optional[core_mod.Context] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.trial = trial
        self.core = core_context
        self.device = resolve_device(device)
        self._check_mesh_support()
        self.state: Optional[TrainState] = None
        self._tx = None
        self._train_step = None
        self._eval_step = None
        self._health_cfg: Optional[HealthConfig] = None
        self._preempt_cfg: Optional[PreemptionConfig] = None
        self._preempt_period = 0
        self._watchdog: Optional[StepWatchdog] = None
        self._rollbacks = 0

    # -- setup ---------------------------------------------------------

    def _check_mesh_support(self) -> None:
        """Config checks before any state exists: the port trains on one
        device, so any mesh axis above 1 is refused, not run replicated."""
        wide = {k: v for k, v in self.trial.mesh_config().items()
                if isinstance(v, int) and v > 1}
        if wide:
            raise ValueError(
                f"{type(self.trial).__name__} asks for the mesh {wide}; the "
                "PyTorch port trains on one device (data, fsdp, tensor, "
                "pipeline and expert axes are not ported yet: ROADMAP.md)")

    def _ensure_core(self, max_length: Optional[int]) -> core_mod.Context:
        if self.core is None:
            self.core = core_mod.init(max_length=max_length)
        elif max_length is not None and \
                self.core.searcher._local_max_length is None:
            self.core.searcher._local_max_length = max_length
        return self.core

    def _build(self, seed: int) -> None:
        trial = self.trial
        tx = self._tx = trial.optimizer()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = create_train_state(trial.init_params, tx, gen,
                                        device=self.device,
                                        extra=trial.init_extra())
        self._train_step = make_train_step(trial.loss, tx,
                                           stateful=trial.stateful)
        has_eval = type(trial).evaluate is not TorchTrial.evaluate
        self._eval_step = (make_eval_step(trial.evaluate,
                                          stateful=trial.stateful)
                           if has_eval else None)

    # -- the loop --------------------------------------------------------

    def fit(
        self,
        max_length: Optional[int] = None,
        validation_period: int = 0,
        checkpoint_period: int = 0,
        report_period: int = 10,
        preempt_period: int = 10,
        seed: int = 0,
        profile: bool = False,
        resume_from: Optional[str] = None,
    ) -> TrainState:
        """Train through all searcher operations; returns the final state.

        Lengths are in steps (batches). validation/checkpoint_period of 0 =
        only at op boundaries. `preempt_period` is the preemption-poll
        cadence in steps. `resume_from` is a checkpoint id to restore
        first (falling back through the lineage when it is missing or
        corrupt).
        """
        core = self._ensure_core(max_length)
        seed = core.trial_seed or seed
        self._build(seed)
        assert self.state is not None

        resume_from = resume_from or core.latest_checkpoint
        if resume_from:
            self._restore(resume_from)
        if profile:
            core.profiler.set_flops_per_step(self.trial.flops_per_step(),
                                             n_devices=1)
            core.profiler.on()

        health = self._health_cfg = HealthConfig.resolve(self.trial)
        self._preempt_cfg = PreemptionConfig.resolve(self.trial)
        self._rollbacks = 0
        data_iter: Iterator[Any] = _repeat(self.trial.build_training_data)
        rng = torch.Generator(device=self.device).manual_seed(seed + 1)
        step = self.state.step
        preempt_period = self._preempt_period = max(1, preempt_period)
        preempted = False
        last = None  # (step, device metrics) of the newest step
        last_validated = last_checkpointed = step
        last_val: Dict[str, Any] = {}
        t_report = time.time()
        n_report = 0

        # Beaten at every metrics flush (a device-to-host copy proves the
        # device made progress); fires when nothing lands within
        # health.step_timeout_sec. 0 disables it.
        watchdog = self._watchdog = StepWatchdog(health.step_timeout_sec)

        def flush() -> Optional[Dict[str, Any]]:
            nonlocal last, t_report, n_report
            host = None
            if last is not None:
                host = self._flush_metrics(core, last, t_report, n_report)
            last, t_report, n_report = None, time.time(), 0
            watchdog.beat()
            return host

        def diverged(host: Optional[Dict[str, Any]]) -> bool:
            return host is not None and \
                float(host.get("all_finite", 1.0)) < 1.0

        def handle_divergence() -> bool:
            """Apply health.on_nan; True = state was rolled back (`step`
            has been rewound and the data stream advanced)."""
            nonlocal step, last_validated, last_checkpointed
            failed_step = step
            if health.on_nan == "fail":
                raise DivergenceError(failed_step)
            if health.on_nan == "warn":
                logger.warning(
                    "divergence at step %d (non-finite loss/gradients); "
                    "health.on_nan=warn — continuing", failed_step)
                return False
            # rollback: restore the last COMPLETED checkpoint, advance the
            # data stream past the offending window, reseed the step rng.
            if self._rollbacks >= health.max_rollbacks:
                raise DivergenceError(
                    failed_step,
                    f"diverged again after {health.max_rollbacks} rollbacks")
            self._rollbacks += 1
            restored = self._restore_chain(core.checkpoint.lineage())
            if restored is None:
                raise DivergenceError(
                    failed_step, "health.on_nan=rollback but no COMPLETED "
                    "checkpoint exists to roll back to")
            step = self.state.step
            for _ in range(health.rollback_window):
                next(data_iter)
            rng.manual_seed(seed + 1 + 1_000_003 * self._rollbacks)
            last_validated = last_checkpointed = step
            logger.warning(
                "divergence at step %d: rolled back to checkpoint %s "
                "(step %d), skipped %d batches (rollback %d/%d)",
                failed_step, restored, step, health.rollback_window,
                self._rollbacks, health.max_rollbacks)
            watchdog.beat()
            return True

        try:
            watchdog.start()
            for op in core.searcher.operations():
                while True:
                    while step < op.length and not preempted:
                        # Chaos (docs/chaos.md): a delay-mode arm here
                        # models a wedged host — what the watchdog exists
                        # to catch.
                        faultpoint.fire("step.hang")
                        batch = _to_device(next(data_iter), self.device)
                        self.state, metrics = self._train_step(
                            self.state, batch, rng)
                        step += 1
                        n_report += 1
                        last = (step, metrics)

                        if report_period and step % report_period == 0:
                            host = flush()
                            core.profiler.set_step(step)
                            if diverged(host) and handle_divergence():
                                continue  # rolled back: step rewound
                        if validation_period and \
                                step % validation_period == 0:
                            last_val = self._validate(core, step)
                            last_validated = step
                            watchdog.beat()
                        if checkpoint_period and \
                                step % checkpoint_period == 0:
                            self._checkpoint(core, step)
                            last_checkpointed = step
                            watchdog.beat()
                        if step % preempt_period == 0 and \
                                core.preempt.should_preempt():
                            preempted = True

                    host = flush()
                    if diverged(host) and not preempted \
                            and handle_divergence():
                        continue  # step rewound below op.length
                    break

                if preempted:
                    self._preempt_checkpoint(core, step, last_checkpointed)
                    break

                val = last_val if last_validated == step else \
                    self._validate(core, step)
                watchdog.beat()
                if last_checkpointed != step:
                    self._checkpoint(core, step)
                    last_checkpointed = step
                if not op.completed:
                    metric = (self.trial.searcher_metric(val) if val
                              else float(self.state.step))
                    op.report_completed(metric)
        finally:
            watchdog.stop()

        if profile:
            core.profiler.off()
        return self.state

    # -- helpers ---------------------------------------------------------

    def _flush_metrics(self, core, last, t_start, n_steps) -> Dict[str, Any]:
        last_step, last_metrics = last
        host = _to_host(last_metrics)
        dt = time.time() - t_start
        if n_steps and dt > 0:
            host["steps_per_second"] = n_steps / dt
            core.profiler.observe_steps(n_steps, dt)
        # The divergence sentinel's event channel: a non-finite step marks
        # this flush's report (train/health.py).
        if float(host.get("all_finite", 1.0)) < 1.0:
            host["divergence"] = 1.0
        core.train.report_training_metrics(last_step, host)
        core.tracer.flush()
        return host

    def _validate(self, core, step: int) -> Dict[str, Any]:
        if self._eval_step is None:
            return {}
        with core.tracer.span("harness.validate", step=step):
            return self._validate_inner(core, step)

    def _validate_inner(self, core, step: int) -> Dict[str, Any]:
        # Sum the per-batch metrics on the device and copy them to the host
        # once at the end: a copy per batch would make every eval batch
        # wait for the one before.
        sums: Dict[str, Any] = {}
        count = 0
        for batch in self.trial.build_validation_data():
            m = self._eval_step(self.state, _to_device(batch, self.device))
            for k, v in m.items():
                sums[k] = sums[k] + v if k in sums else v
            count += 1
        if count == 0:
            return {}
        sums = _to_host(sums)
        avg = {k if k.startswith("validation_") else f"validation_{k}":
               float(v) / count for k, v in sums.items()}
        core.train.report_validation_metrics(step, avg)
        return avg

    def _checkpoint(self, core, step: int) -> None:
        core.checkpoint.save_state(self.state, step)

    def _preempt_checkpoint(self, core, step: int,
                            last_checkpointed: int) -> None:
        """Preemption exit path. Unbounded preemption: save (and commit) at
        the current step. With a termination deadline: save only if the
        last observed save cost fits the grace left, else leave the
        previous COMPLETED checkpoint to restore from."""
        deadline = core.preempt.preemption_deadline()
        if deadline is None:
            if last_checkpointed != step:
                self._checkpoint(core, step)
            logger.info("preempted at step %d; checkpoint saved", step)
            return
        cfg = self._preempt_cfg or PreemptionConfig()
        t0 = time.monotonic()
        attempt = last_checkpointed != step and cfg.should_attempt_save(
            deadline, core.checkpoint.last_save_ms)
        with core.tracer.span("harness.checkpoint.emergency",
                              deadline_s=deadline, attempted=attempt,
                              step=step):
            if attempt:
                self._checkpoint(core, step)
        core.tracer.flush()
        grace_used_ms = (time.monotonic() - t0) * 1000.0
        logger.info(
            "deadline preemption at step %d: %s, grace used %.0fms of %.1fs",
            step, "emergency checkpoint committed" if attempt
            else "emergency checkpoint skipped", grace_used_ms, deadline)
        core.train.report_training_metrics(step, {
            "preemption_grace_used_ms": grace_used_ms,
            "preemption_emergency_checkpoint": 1.0 if attempt else 0.0,
        })

    def _restore(self, storage_id: str) -> Optional[str]:
        """Restore `storage_id`, falling back through the COMPLETED lineage
        when it is missing or fails integrity verification. Returns the
        storage id actually restored, or None (fresh start)."""
        restored = self._restore_chain([storage_id])
        if restored is None:
            logger.warning(
                "no restorable checkpoint in the lineage of %s; "
                "starting fresh", storage_id)
        return restored

    def _restore_chain(self, candidates) -> Optional[str]:
        """Try each candidate in order, extending with the lineage after the
        first failure. Missing (FileNotFoundError) and corrupt
        (CorruptCheckpoint) checkpoints fall through to the next
        candidate; anything else re-raises."""
        assert self.state is not None
        with self.core.tracer.span(
                "harness.restore",
                requested=candidates[0] if candidates else "") as sp:
            restored = self._restore_chain_inner(candidates)
            if sp is not None:
                sp.attrs["restored"] = restored or ""
            return restored

    def _restore_chain_inner(self, candidates) -> Optional[str]:
        queue = list(candidates)
        tried = set()
        extended = not queue
        while queue:
            sid = queue.pop(0)
            if sid in tried:
                continue
            tried.add(sid)
            try:
                self.state = self.core.checkpoint.restore_state(
                    sid, self.state)
                logger.info("restored from checkpoint %s at step %d", sid,
                            self.state.step)
                return sid
            except FileNotFoundError:
                logger.warning(
                    "checkpoint %s missing; walking lineage back", sid)
            except core_mod.CorruptCheckpoint as e:
                logger.warning(
                    "checkpoint %s failed integrity verification (%s); "
                    "walking lineage back", sid, e.reason)
            if not extended:
                extended = True
                # Fallback only walks BACKWARD: a checkpoint newer than the
                # one requested is never a substitute for it.
                limit = core_mod.state_id_step(sid)
                for cand in self.core.checkpoint.lineage():
                    cstep = core_mod.state_id_step(cand)
                    if limit is not None and cstep is not None \
                            and cstep > limit:
                        continue
                    queue.append(cand)
        return None
