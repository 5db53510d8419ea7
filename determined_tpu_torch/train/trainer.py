"""Trainer — owns the loop, on one CUDA device or one per process.

Counterpart of determined_tpu/train/trainer.py. `fit()` runs the searcher
operations: train to each op's length, flush metrics every `report_period`
steps (one device-to-host copy per flush, with `steps_per_second` and the
prefetcher's `input_wait_ms`, `h2d_ms` and `prefetch_queue_depth`),
validate with the per-batch sums kept on the device, checkpoint at op
boundaries and every `checkpoint_period` steps, and report the op
completed. Batches reach the device through the `DevicePrefetcher`
(data/prefetch.py) unless the trial or the experiment config turns it off.
Around the loop: the `step.hang` fault point, the step watchdog, the
divergence sentinel (`health.on_nan` fail / warn / rollback through
`core.checkpoint.lineage()`), `resume_from` (or the cluster's
`DET_LATEST_CHECKPOINT`) restore with fallback through the lineage, and
the preemption checkpoint, whose COMMIT lands inside the signal's
deadline. Checkpoints are written in the background and committed at the
next `core.checkpoint.wait()`: before a rollback reads the lineage, at a
preemption and at the end of `fit`.

Mesh bring-up: the trial's `mesh_config()` resolves over the world size
(one process per device, `core.init()` forms the process group), and a
run with a process group trains over a `DeviceMesh` of the world
(parallel/mesh.py). The `data`, `fsdp`, `expert`, `context` and `tensor`
axes may be above 1: each rank's loader yields its own block of the
global batch (`parallel.mesh.batch_shard`: the batch is split over the
batch rule's axes, `("data", "fsdp")`, so the ranks of an expert,
context or tensor group hold the same rows; the model splits a row's
sequence over `context` and its heads, FFN and vocab over `tensor`,
models/gpt2.py), the params are sharded by their logical axes
(train/state.py; an MoE model's experts over `expert`, ops/moe.py), the
step's metrics are the global means, and a checkpoint holds the full
state (the chief gathers it) in the one-process format, so a run of any
width restores it. `expert` above 1 is refused for a trial that does not
declare `supports_expert_parallel()` (it would replicate the FFN's work
across the group). `pipeline` above 1 selects the trial's
`loss_pipelined` (GPipe, parallel/pipeline.py: the ranks of a pipeline
group hold the same rows, each stage its layers) and its
`evaluate_pipelined` when it has one; a trial without `loss_pipelined`,
or a stateful one, is refused under it. A world of more than one process
without a process group raises: it never trains alone in silence.

The first step call of a `fit` lands a `harness.compile` span, the JAX
Trainer's "first executable acquisition": here, the hand-written kernels
built with nvcc at their first launch (or loaded from build/kernels) and
the step's first eager run on the host.

Not ported (ROADMAP.md): the compile farm and batch-size bucketing
(`_timed_first_call`, `FarmClient`; PyTorch runs eagerly and compiles
nothing here) and elastic resize in process (item 8): a resize signal
takes the preemption checkpoint path, as the JAX Trainer does in cluster
mode.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from determined_tpu_torch import core as core_mod
from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.common import faultpoint, trace
from determined_tpu_torch.data.prefetch import DevicePrefetcher, PrefetchConfig
from determined_tpu_torch.parallel.mesh import MeshConfig, create_mesh
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train.health import (
    DivergenceError,
    HealthConfig,
    PreemptionConfig,
)
from determined_tpu_torch.train.state import TrainState, create_train_state
from determined_tpu_torch.train.step import (
    global_mean,
    make_eval_step,
    make_train_step,
)
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
    tuples) on `device`: the copy at the step, with the prefetcher off."""
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(v, device) for v in batch)
    return batch


def _expconf(core) -> Optional[Dict[str, Any]]:
    """The experiment config of a managed trial (None in local mode)."""
    if core is not None and core.info is not None and core.info.trial:
        return core.info.trial.config
    return None


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
        self.mesh_config = self._check_mesh_support()
        self.mesh = None  # the DeviceMesh, built with the state (_build)
        self.state: Optional[TrainState] = None
        self._tx = None
        self._train_step = None
        self._eval_step = None
        self._pf_cfg: Optional[PrefetchConfig] = None
        self._health_cfg: Optional[HealthConfig] = None
        self._preempt_cfg: Optional[PreemptionConfig] = None
        self._preempt_period = 0
        self._watchdog: Optional[StepWatchdog] = None
        self._rollbacks = 0

    # -- setup ---------------------------------------------------------

    def _world_size(self) -> int:
        """The processes of the run: the process group's size, which must
        be there when the core context counts more than one. Before a core
        context exists (`fit` makes one), the launcher's WORLD_SIZE: the
        group `core.init()` will form."""
        import torch.distributed as dist

        if dist.is_initialized():
            return dist.get_world_size()
        if self.core is None:
            return int(os.environ.get("WORLD_SIZE", "1"))
        size = self.core.distributed.size
        if size > 1:
            raise RuntimeError(
                f"the core context counts {size} processes but no "
                "torch.distributed process group exists: each would train "
                "alone (core.init() forms the group from the launcher's "
                "environment; DistributedContext.for_test has none)")
        return 1

    def _check_mesh_support(self) -> MeshConfig:
        """Config checks before any state exists (a misconfigured mesh
        fails in milliseconds, not after sharding a large model): the mesh
        must resolve over the world size; `pipeline` above 1 only for a
        stateless trial with `loss_pipelined` (the JAX Trainer's checks);
        `expert` only for a trial whose model routes over it (the others
        are refused, not run replicated); and none of `tensor`, `context`
        and `expert` for a trial whose model computes over the batch axes
        only (`supports_model_parallel()` False; refused as asked, before
        the mesh resolves, and again after)."""
        cfg = self.trial.mesh_config()
        if not self.trial.supports_model_parallel():
            self._refuse_model_axes(cfg)
        world = self._world_size()
        try:
            cfg = cfg.resolve(world)
        except ValueError as e:
            where = "one device (one process)" if world == 1 else \
                f"{world} processes, one device each"
            raise ValueError(
                f"{type(self.trial).__name__}: {e}; this run has {where}; "
                "the launcher starts one process per device "
                "(python -m determined_tpu_torch.launch.torch_distributed)"
            ) from None
        if not self.trial.supports_model_parallel():
            self._refuse_model_axes(cfg)
        if cfg.pipeline > 1:
            # A pipeline axis without a pipelined loss would run the plain
            # step with every stage's layers gathered: refused instead.
            if not self.trial.supports_pipeline():
                raise ValueError(
                    f"mesh requests pipeline={cfg.pipeline} but "
                    f"{type(self.trial).__name__} does not implement "
                    "loss_pipelined(); implement it (see models/gpt2."
                    "loss_fn_pipelined) or drop the pipeline axis")
            if self.trial.stateful:
                raise ValueError(
                    "pipeline parallelism does not support stateful trials "
                    "(non-gradient extra state crossing stage boundaries)")
        if cfg.expert > 1 and not self.trial.supports_expert_parallel():
            # An expert axis the model does not route over would replicate
            # the FFN's work across the group (the JAX Trainer's guard).
            raise ValueError(
                f"mesh requests expert={cfg.expert} but "
                f"{type(self.trial).__name__} does not declare "
                "expert-parallel support; use a MoE model (ops/moe.py, "
                "gpt2.Config(num_experts=...)) and override "
                "supports_expert_parallel(), or drop the expert axis")
        return cfg

    def _refuse_model_axes(self, cfg: MeshConfig) -> None:
        split = {a: getattr(cfg, a) for a in ("tensor", "context", "expert")
                 if getattr(cfg, a) > 1}
        if split:
            raise ValueError(
                f"{type(self.trial).__name__} asks for the mesh axes {split}; "
                "its model splits no work over tensor, context or expert "
                "(supports_model_parallel() is False), so the port trains it "
                "over data and fsdp only (ROADMAP.md Queue 1 item 14)")

    def _ensure_core(self, max_length: Optional[int]) -> core_mod.Context:
        if self.core is None:
            self.core = core_mod.init(max_length=max_length)
        elif max_length is not None and \
                self.core.searcher._local_max_length is None:
            self.core.searcher._local_max_length = max_length
        return self.core

    def _build(self, seed: int) -> None:
        import torch.distributed as dist

        trial = self.trial
        # Again: `fit`'s core.init() may have formed the process group
        # since __init__ checked.
        self.mesh_config = self._check_mesh_support()
        if dist.is_initialized() and self.mesh is None:
            self.mesh = create_mesh(self.mesh_config, self.device.type)
        tx = self._tx = trial.optimizer()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = create_train_state(
            trial.init_params, tx, gen, device=self.device,
            extra=trial.init_extra(), mesh=self.mesh,
            param_logical_axes=trial.param_logical_axes(),
            rules=trial.sharding_rules())
        loss, evaluate = trial.loss, trial.evaluate
        has_eval = type(trial).evaluate is not TorchTrial.evaluate
        if self.mesh_config.pipeline > 1:
            mesh = self.mesh

            def loss(params, batch, rng):  # noqa: F811: the pipelined one
                return trial.loss_pipelined(params, batch, rng, mesh)

            if trial.supports_pipelined_eval():
                has_eval = True

                def evaluate(params, batch):  # noqa: F811
                    return trial.evaluate_pipelined(params, batch, mesh)
            elif has_eval:
                logger.warning(
                    "%s has no evaluate_pipelined(); validation will gather "
                    "pipeline-sharded params every eval step (slow but "
                    "correct) — implement evaluate_pipelined() to fix",
                    type(trial).__name__)

                def evaluate(params, batch):  # noqa: F811
                    return trial.evaluate(state_mod.gathered(params), batch)
        self._train_step = make_train_step(loss, tx, stateful=trial.stateful,
                                           mesh=self.mesh)
        self._eval_step = (make_eval_step(evaluate, stateful=trial.stateful)
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
            core.profiler.set_flops_per_step(
                self.trial.flops_per_step(),
                n_devices=self.mesh.size() if self.mesh is not None else 1)
            core.profiler.on()

        expconf = _expconf(core)
        self._pf_cfg = PrefetchConfig.resolve(self.trial, expconf)
        health = self._health_cfg = HealthConfig.resolve(self.trial, expconf)
        self._preempt_cfg = PreemptionConfig.resolve(self.trial, expconf)
        self._rollbacks = 0
        data_iter: Iterator[Any] = _repeat(self.trial.build_training_data)
        prefetcher: Optional[DevicePrefetcher] = None
        if self._pf_cfg.enabled:
            prefetcher = DevicePrefetcher(data_iter, self.device,
                                          depth=self._pf_cfg.depth,
                                          name="train")
            data_iter = prefetcher
        else:
            data_iter = (_to_device(b, self.device) for b in data_iter)
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
        watchdog = self._watchdog = StepWatchdog(
            health.step_timeout_sec, session=core.checkpoint._session,
            allocation_id=core.checkpoint._allocation_id)

        def flush() -> Optional[Dict[str, Any]]:
            nonlocal last, t_report, n_report
            host = None
            if last is not None:
                host = self._flush_metrics(core, last, t_report, n_report,
                                           prefetcher)
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
            core.checkpoint.wait()  # commit the pending save: a current lineage
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

        first_call = True
        try:
            watchdog.start()
            for op in core.searcher.operations():
                while True:
                    while step < op.length and not preempted:
                        # Chaos (docs/chaos.md): a delay-mode arm here
                        # models a wedged host — what the watchdog exists
                        # to catch.
                        faultpoint.fire("step.hang")
                        batch = next(data_iter)
                        t0_us = trace.now_us() if first_call else 0
                        self.state, metrics = self._train_step(
                            self.state, batch, rng)
                        if first_call:
                            first_call = False
                            core.tracer.emit(
                                "harness.compile", t0_us, trace.now_us(),
                                {"step": step})
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
                            # The pass polls and cuts itself short on a
                            # preemption; pick the flag up here.
                            if core.preempt.should_preempt():
                                preempted = True
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
                if core.preempt.should_preempt():
                    # A preemption during the op-end validation: checkpoint
                    # and exit without completing the op; the restart
                    # finishes it.
                    self._preempt_checkpoint(core, step, last_checkpointed)
                    break
                if last_checkpointed != step:
                    self._checkpoint(core, step)
                    last_checkpointed = step
                if not op.completed:
                    metric = (self.trial.searcher_metric(val) if val
                              else float(self.state.step))
                    op.report_completed(metric)
        finally:
            # Preemption, op ends and errors all pass here: the watchdog
            # and the prefetch thread are joined, not orphaned.
            watchdog.stop()
            if prefetcher is not None:
                prefetcher.close()

        core.checkpoint.wait()
        if profile:
            core.profiler.off()
        return self.state

    # -- helpers ---------------------------------------------------------

    def _flush_metrics(self, core, last, t_start, n_steps,
                       prefetcher: Optional[DevicePrefetcher] = None
                       ) -> Dict[str, Any]:
        last_step, last_metrics = last
        host = _to_host(last_metrics)
        dt = time.time() - t_start
        if n_steps and dt > 0:
            host["steps_per_second"] = n_steps / dt
            core.profiler.observe_steps(n_steps, dt)
        if prefetcher is not None:
            wait, h2d, depth, n = prefetcher.window_sums()
            if n:
                host["input_wait_ms"] = wait / n
                host["h2d_ms"] = h2d / n
                host["prefetch_queue_depth"] = depth / n
                core.profiler.observe_input(wait, h2d, depth, n)
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
        pf_cfg = self._pf_cfg or PrefetchConfig.resolve(self.trial,
                                                        _expconf(core))
        data: Iterator[Any] = iter(self.trial.build_validation_data())
        prefetcher: Optional[DevicePrefetcher] = None
        if pf_cfg.enabled:
            prefetcher = DevicePrefetcher(data, self.device,
                                          depth=pf_cfg.depth, name="val")
            data = prefetcher
        else:
            data = (_to_device(b, self.device) for b in data)
        preempt_period = max(1, self._preempt_period)
        try:
            for batch in data:
                m = self._eval_step(self.state, batch)
                for k, v in m.items():
                    sums[k] = sums[k] + v if k in sums else v
                count += 1
                # A long pass must not outlive a drain deadline: poll at
                # the loop's cadence and cut it short (the partial averages
                # are still reported).
                if count % preempt_period == 0 and \
                        core.preempt.should_preempt():
                    logger.info("preemption during validation after %d "
                                "batches; cutting the pass short", count)
                    break
        finally:
            if prefetcher is not None:
                prefetcher.close()
        if count == 0:
            return {}
        if self._multi_process():
            # Each rank summed the metrics of its own rows: the global
            # mean of those sums (every rank ran `count` batches).
            keys = [k for k, v in sums.items() if isinstance(v, torch.Tensor)]
            sums.update(zip(keys, global_mean([sums[k] for k in keys])))
        sums = _to_host(sums)
        avg = {k if k.startswith("validation_") else f"validation_{k}":
               float(v) / count for k, v in sums.items()}
        core.train.report_validation_metrics(step, avg)
        return avg

    def _multi_process(self) -> bool:
        return self.mesh is not None and self.mesh.size() > 1

    def _checkpoint(self, core, step: int) -> None:
        state = self.state
        if state_mod.is_sharded(state):
            # The full state, gathered on every rank (a collective), in the
            # one-process format; the chief writes it.
            state = state_mod.unshard_state(state)
        core.checkpoint.save_state(state, step)

    def _preempt_checkpoint(self, core, step: int,
                            last_checkpointed: int) -> None:
        """Preemption exit path. Unbounded preemption: save at the current
        step (fit's epilogue commits it). With a termination deadline: save
        and commit inside the window only if the last observed save cost
        fits the grace left, else commit what is pending and leave the
        previous COMPLETED checkpoint to restore from. A resize offer takes
        this path too: the port cannot reshard in process, so the master
        re-places the trial at its new size from this checkpoint."""
        deadline = core.preempt.preemption_deadline()
        resize_target = core.preempt.resize_target()
        if deadline is None:
            if last_checkpointed != step:
                self._checkpoint(core, step)
            logger.info("preempted at step %d (resize target %s); checkpoint "
                        "saved", step, resize_target)
            return
        cfg = self._preempt_cfg or PreemptionConfig()
        t0 = time.monotonic()
        estimate_ms = core.checkpoint.last_save_ms
        attempt = last_checkpointed != step and cfg.should_attempt_save(
            deadline, estimate_ms)
        # The save is a collective, and only the chief timed the last one:
        # its decision is every rank's.
        attempt = bool(core.distributed.broadcast(attempt))
        with core.tracer.span("harness.checkpoint.emergency",
                              deadline_s=deadline, attempted=attempt,
                              step=step):
            if attempt:
                self._checkpoint(core, step)
            elif last_checkpointed != step:
                logger.warning(
                    "preemption deadline %.1fs cannot cover a durable save "
                    "(last save %.0fms x%.1f safety + %.1fs margin); "
                    "skipping the emergency checkpoint", deadline,
                    estimate_ms or 0.0, cfg.budget_safety_factor,
                    cfg.budget_margin_sec)
            # The COMMIT must land inside the window: the new save, or the
            # periodic one still pending, which the restart lands on.
            core.checkpoint.wait()
        core.tracer.flush()  # the process exits right after
        grace_used_ms = (time.monotonic() - t0) * 1000.0
        logger.info(
            "%s preemption (%s) at step %d: %s, grace used %.0fms of %.1fs",
            "resize" if resize_target is not None else "deadline",
            core.preempt.preemption_reason() or "unknown", step,
            "emergency checkpoint committed" if attempt
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

    def _read_checkpoint(self, storage_id: str) -> TrainState:
        """Checkpoint `storage_id` as the current state's layout: a sharded
        state reads the full state and keeps its shards (no collective)."""
        if not state_mod.is_sharded(self.state):
            return self.core.checkpoint.restore_state(storage_id, self.state)
        full = self.core.checkpoint.restore_state(
            storage_id, state_mod.full_template(self.state))
        return state_mod.reshard_state(full, self.state)

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
                self.state = self._read_checkpoint(sid)
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
