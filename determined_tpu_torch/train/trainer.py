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
step's metrics are the global means over the mesh, and each rank writes
its own pieces of a checkpoint (core/_checkpoint.py), which a run of any
width restores, reading only the pieces its own overlap. `expert` above 1 is refused for a trial that does not
declare `supports_expert_parallel()` (it would replicate the FFN's work
across the group). `pipeline` above 1 selects the trial's
`loss_pipelined` (GPipe, parallel/pipeline.py: the ranks of a pipeline
group hold the same rows, each stage its layers) and its
`evaluate_pipelined` when it has one; a trial without `loss_pipelined`,
or a stateful one, is refused under it. A world of more than one process
without a process group raises: it never trains alone in silence.

The first call of the train step (and of the eval step) lands a
`harness.compile` span, the JAX Trainer's "first executable acquisition"
(`_timed_first_call`): here, the hand-written kernel libraries resolved at
their first launch, from the kernel directory, the compile farm or nvcc
(ops/_build.py; docs/compile-farm-torch.md), and the step's first eager
run on the host. A `FarmClient` from core's session and
`DET_COMPILE_SIGNATURE` is the farm; a library nvcc builds is uploaded in
the background, and `fit` joins the uploads at its end. The span carries
`executable`, `cache_hit` (no library was built by nvcc in this process;
0 on the CPU, where nothing is built), `signature` and `attention_impl`,
and the next metrics flush reports `compile_ms`, `compile_cache_hit` and
`attention_impl`. With `compile: {bucket_batch_sizes: true}` (the trial's
`compile` attribute, else the config's block) every training and
validation batch is padded up to its bucket on the host, before the
prefetcher (compile/bucketing.py).

Elastic resize (docs/elasticity-torch.md): `slots` is the counterpart
of the JAX Trainer's `devices`, the number of the world's ranks the mesh
starts over. The others stand by inside `fit`, outside the mesh, until a
resize takes them in or the run ends (`fit` then returns None on them).
A preemption that carries a resize target this world can serve
(`_can_resize_in_process`: local mode, another size, within the world,
a size the mesh config resolves over) is served in process: a
deadline-budgeted COMPLETED checkpoint (or the newest in the lineage),
then on every rank of the world the distributed context and the mesh
narrowed or widened to the first `target` ranks, the steps rebuilt, the
state restored into a template built from the checkpoint (no
`init_params`), the training stream rebuilt from the trial for the new
width and advanced past the batches already consumed, the preemption
watcher re-armed; `harness.resize.downtime` wraps it all,
`harness.reshard` the re-mesh and restore (`harness.restore` nests in
it), and the chief reports `resize_from_slots`, `resize_target_slots`
and `resize_downtime_ms`. A resize it cannot serve takes the
preemption checkpoint path and exits, as in cluster mode.
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from determined_tpu_torch import core as core_mod
from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.common import faultpoint, trace
from determined_tpu_torch.compile.bucketing import CompileConfig, bucketed_iter
from determined_tpu_torch.compile.runtime import FarmClient
from determined_tpu_torch.data.prefetch import DevicePrefetcher, PrefetchConfig
from determined_tpu_torch.core._searcher import SearcherOperation
from determined_tpu_torch.ops import _build
from determined_tpu_torch.ops.flash_attention import resolve_attention_impl
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


# Each rank counts its fits: the ranks of a world call `fit` alike, so a
# count names one fit's elastic generations on the shared store.
_FITS = itertools.count()


class Trainer:
    def __init__(self, trial: TorchTrial,
                 core_context: Optional[core_mod.Context] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 slots: Optional[int] = None):
        self.trial = trial
        self.core = core_context
        self.device = resolve_device(device)
        # The counterpart of the JAX Trainer's `devices`: how many of the
        # world's ranks the mesh starts over (all of them by default). The
        # others stand by inside `fit` until a resize takes them in.
        self._slots = slots
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
        self._seed = 0
        self._profile = False
        # Batches the loop has taken from the training stream, rollback
        # skips included: where a stream rebuilt at a resize resumes.
        self._consumed = 0
        self._fit_id = 0
        self._generation = 0
        # What each resize cost this rank, by part, in ms (checkpoint,
        # groups, template, restore, stream, and first_step: to the first
        # metrics flush after it), with the bytes its restore read: the
        # measurement of `resize_downtime_ms`'s parts. `_parts` is the
        # newest one's while it is being filled.
        self.resize_parts: List[Dict[str, float]] = []
        self._parts: Optional[Dict[str, float]] = None
        # Compile farm (docs/compile-farm-torch.md): the artifact client of
        # this trial's signature, the resolved `compile:` block, and the
        # (executable, compile_ms, cache_hit) events the first calls feed
        # into the next metrics flush, with the resolved attention_impl.
        self._farm: Optional[FarmClient] = None
        self._compile_cfg: Optional[CompileConfig] = None
        self._compile_events: List[Dict[str, Any]] = []
        self._attention_impl: Optional[str] = None

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

    def _check_mesh_support(self, size: Optional[int] = None) -> MeshConfig:
        """Config checks before any state exists (a misconfigured mesh
        fails in milliseconds, not after sharding a large model): the mesh
        must resolve over `size` ranks (the slots asked for, by default
        the world); `pipeline` above 1 only for a stateless trial with
        `loss_pipelined` (the JAX Trainer's checks); `expert` only for a
        trial whose model routes over it (the others are refused, not run
        replicated); and none of `tensor`, `context` and `expert` for a
        trial whose model computes over the batch axes only
        (`supports_model_parallel()` False; refused as asked, before the
        mesh resolves, and again after)."""
        cfg = self.trial.mesh_config()
        if not self.trial.supports_model_parallel():
            self._refuse_model_axes(cfg)
        world = self._world_size()
        if size is None:
            size = world if self._slots is None else int(self._slots)
        if not 1 <= size <= world:
            raise ValueError(f"slots={size} in a world of {world} processes")
        try:
            cfg = cfg.resolve(size)
        except ValueError as e:
            where = "one device (one process)" if size == 1 else \
                f"{size} processes, one device each"
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
                "over data and fsdp only; split the model's work over those "
                "axes (as models/mnist.py, resnet.py and diffusion.py do) "
                "and drop the override")

    def _ensure_core(self, max_length: Optional[int]) -> core_mod.Context:
        if self.core is None:
            self.core = core_mod.init(max_length=max_length)
        elif max_length is not None and \
                self.core.searcher._local_max_length is None:
            self.core.searcher._local_max_length = max_length
        return self.core

    def _active(self) -> bool:
        """False on a rank standing by outside the mesh."""
        return self.core is None or self.core.distributed.active

    def _build(self, seed: int) -> None:
        import torch.distributed as dist

        trial = self.trial
        # Again: `fit`'s core.init() may have formed the process group
        # since __init__ checked.
        self.mesh_config = self._check_mesh_support()
        if dist.is_initialized() and self.mesh is None:
            size = math.prod(self.mesh_config.sizes())
            if size != self.core.distributed.size:
                # Every rank of the world, standing by or not.
                self.core.distributed.resize(size)
            self.mesh = create_mesh(self.mesh_config, self.device.type,
                                    ranks=size)
        self._tx = trial.optimizer()
        if not self._active():
            return
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = create_train_state(
            trial.init_params, self._tx, gen, device=self.device,
            extra=trial.init_extra(), mesh=self.mesh,
            param_logical_axes=trial.param_logical_axes(),
            rules=trial.sharding_rules())
        self._build_steps()

    def _build_steps(self) -> None:
        """The train and eval steps over the current mesh (the pipelined
        loss and eval close over it): built again at a resize."""
        trial, tx = self.trial, self._tx
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
        self._train_step = self._timed_first_call(
            make_train_step(loss, tx, stateful=trial.stateful,
                            mesh=self.mesh), "train_step")
        self._eval_step = (self._timed_first_call(
            make_eval_step(evaluate, stateful=trial.stateful), "eval_step")
            if has_eval else None)

    def _timed_first_call(self, fn, executable: str):
        """`fn` wrapped so that its first call is the compile-farm
        integration point (the JAX Trainer's `_timed_first_call`): the
        kernel libraries it launches resolve through the farm, a
        `harness.compile` span lands with `cache_hit` (on CUDA: no library
        was built by nvcc in this process) and the signature, and the next
        metrics flush reports `compile_ms` and `compile_cache_hit`. The
        wrapper then puts the bare step back in its place."""
        cfg = self._compile_cfg or CompileConfig()
        farm = self._farm if cfg.enabled else None

        def wrapped(*args, **kwargs):
            t0 = time.monotonic()
            t0_us = trace.now_us()
            previous = _build.set_farm(farm, upload=cfg.upload)
            try:
                out = fn(*args, **kwargs)
            finally:
                _build.set_farm(previous)
            setattr(self, f"_{executable}", fn)
            cache_hit = self.device.type == "cuda" and not _build.nvcc_built()
            compile_ms = (time.monotonic() - t0) * 1000.0
            attrs: Dict[str, Any] = {
                "executable": executable, "cache_hit": cache_hit,
                "attention_impl": self._attention_impl}
            if self._farm is not None and self._farm.signature:
                attrs["signature"] = self._farm.signature
            if self.core is not None:
                self.core.tracer.emit("harness.compile", t0_us,
                                      trace.now_us(), attrs)
            self._compile_events.append(
                {"executable": executable, "compile_ms": compile_ms,
                 "cache_hit": cache_hit})
            return out

        return wrapped

    def _stream(self):
        """(batches on the device, the prefetcher or None): the trial's
        training data from its start, advanced past the batches the loop
        has consumed (the loader must be deterministic from its start), so
        a stream rebuilt at a resize, for a width whose rows differ, goes
        on at the same global batch."""
        data_iter: Iterator[Any] = _repeat(self.trial.build_training_data)
        for _ in range(self._consumed):
            next(data_iter)
        cfg = self._compile_cfg
        if cfg is not None and cfg.bucket_batch_sizes:
            # Pad each host batch up to its bucket before the device copy:
            # a rebuilt stream pads as the first one did.
            data_iter = bucketed_iter(data_iter, cfg)
        if not self._pf_cfg.enabled:
            return (_to_device(b, self.device) for b in data_iter), None
        prefetcher = DevicePrefetcher(data_iter, self.device,
                                      depth=self._pf_cfg.depth, name="train")
        return prefetcher, prefetcher

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
    ) -> Optional[TrainState]:
        """Train through all searcher operations; returns the final state,
        or None on a rank that ends the run standing by (`slots`, or a
        shrink: it holds no state).

        Lengths are in steps (batches). validation/checkpoint_period of 0 =
        only at op boundaries. `preempt_period` is the preemption-poll
        cadence in steps. `resume_from` is a checkpoint id to restore
        first (falling back through the lineage when it is missing or
        corrupt).
        """
        import torch.distributed as dist

        core = self._ensure_core(max_length)
        seed = self._seed = core.trial_seed or seed
        self._fit_id, self._generation, self._consumed = next(_FITS), 0, 0
        self._profile = profile
        expconf = _expconf(core)
        self._compile_cfg = CompileConfig.resolve(self.trial, expconf)
        if self._farm is None:
            self._farm = FarmClient(core.checkpoint._session)
        opt = (expconf or {}).get("optimizations")
        self._attention_impl = resolve_attention_impl(
            opt.get("attention_impl") if isinstance(opt, dict) else None,
            self.device)
        self._build(seed)
        self._pf_cfg = PrefetchConfig.resolve(self.trial, expconf)
        self._health_cfg = HealthConfig.resolve(self.trial, expconf)
        self._preempt_cfg = PreemptionConfig.resolve(self.trial, expconf)
        self._rollbacks = 0
        self._preempt_period = max(1, preempt_period)
        periods = (validation_period, checkpoint_period, report_period)
        try:
            if self._active():
                resume_from = resume_from or core.latest_checkpoint
                if resume_from:
                    self._restore(resume_from)
                ops = core.searcher.operations()
            else:
                ops = self._stand_by(core)
            if profile and ops is not None:
                self._set_profiler_devices(core)
                core.profiler.on()
            while ops is not None and not self._train(core, ops, *periods):
                ops = self._stand_by(core)  # a resize left this rank out
            if ops is None:
                return None
        finally:
            if dist.is_initialized() and core.distributed.is_chief:
                # Wakes the ranks standing by: the run is over.
                self._publish(core, {"end": True})
        core.checkpoint.wait()
        # Fresh kernel builds upload in the background; give successors
        # their artifacts before the process exits.
        self._farm.wait(30.0)
        if profile:
            core.profiler.off()
        return self.state

    def _set_profiler_devices(self, core) -> None:
        core.profiler.set_flops_per_step(
            self.trial.flops_per_step(),
            n_devices=self.mesh.size() if self.mesh is not None else 1)

    def _train(self, core, ops, validation_period: int,
               checkpoint_period: int, report_period: int) -> bool:
        """The loop over `ops` from the state's step. True when the run
        ended (all ops, or a preemption); False when a resize left this
        rank standing by."""
        health = self._health_cfg
        seed = self._seed
        t0 = time.monotonic()
        data_iter, prefetcher = self._stream()
        t_resumed = self._note("stream", t0)
        rng = torch.Generator(device=self.device).manual_seed(seed + 1)
        step = self.state.step
        preempt_period = self._preempt_period
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
            if self._parts is not None and host is not None:
                self._note("first_step", t_resumed)
                self.resize_parts.append(self._parts)
                self._parts = None
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
                self._consumed += 1
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
            for op in ops:
                while True:
                    while step < op.length and not preempted:
                        # Chaos (docs/chaos.md): a delay-mode arm here
                        # models a wedged host — what the watchdog exists
                        # to catch.
                        faultpoint.fire("step.hang")
                        batch = next(data_iter)
                        self._consumed += 1
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
                    if preempted:
                        # Elastic resize (docs/elasticity-torch.md):
                        # reshard in process and keep training instead of
                        # checkpoint-and-exit, when this world can host
                        # the target size itself.
                        target = core.preempt.resize_target()
                        if target is not None and \
                                self._can_resize_in_process(target):
                            if prefetcher is not None:
                                # Its producer reads the loader, whose rows
                                # follow the width about to change.
                                prefetcher.close()
                            if not self._resize_in_process(
                                    core, target, step, last_checkpointed,
                                    op):
                                return False  # standing by
                            t0 = time.monotonic()
                            data_iter, prefetcher = self._stream()
                            t_resumed = self._note("stream", t0)
                            rng.manual_seed(seed + 1)
                            step = last_validated = last_checkpointed = \
                                self.state.step
                            preempted = False
                            watchdog.beat()
                            continue  # resharded: keep training
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
            # Preemption, op ends, resizes and errors all pass here: the
            # watchdog and the prefetch thread are joined, not orphaned.
            watchdog.stop()
            if prefetcher is not None:
                prefetcher.close()
        return True

    # -- elastic resize (docs/elasticity-torch.md) -----------------------

    def _can_resize_in_process(self, target: int) -> bool:
        """Whether this world can serve the resize by resharding in place
        (the JAX Trainer's test). Cluster mode says no: the signal usually
        means this node is going away, so the transition is master-side —
        budgeted checkpoint, clean exit, re-placement at the new size.
        Local mode reshards over a prefix of the world's ranks."""
        if self.core is not None and self.core.info is not None:
            return False
        if target == self.core.distributed.size:
            return False  # nothing to reshard
        if target > self._world_size():
            return False
        return self.trial.mesh_config().resolvable(target)

    def _resize_in_process(self, core, target: int, step: int,
                           last_checkpointed: int, op) -> bool:
        """The resize pipeline on the ranks that train: a
        deadline-budgeted COMPLETED checkpoint (or the newest in the
        lineage), then the transition every rank of the world makes
        (`_transition`), then the `resize_*` metrics. True when this rank
        trains on; False when it stands by."""
        with core.tracer.span("harness.resize.downtime",
                              from_slots=core.distributed.size,
                              target=target):
            t0 = time.monotonic()
            from_slots = core.distributed.size
            reason = core.preempt.preemption_reason() or "resize"
            self._parts = {}
            restore_id = self._resize_checkpoint(core, step,
                                                 last_checkpointed)
            self._note("checkpoint", t0)
            if core.distributed.is_chief:
                self._publish(core, {
                    "target": target, "restore": restore_id,
                    "op": op.length, "consumed": self._consumed})
            active = self._transition(core, self._next_generation(core))
            if not active:
                return False
        downtime_ms = (time.monotonic() - t0) * 1000.0
        step = self.state.step
        logger.info(
            "elastic resize (%s): %d -> %d slots at step %d, restored %s, "
            "downtime %.0fms (no requeue, restarts unchanged)",
            reason, from_slots, target, step, restore_id, downtime_ms)
        core.train.report_training_metrics(step, {
            "resize_from_slots": float(from_slots),
            "resize_target_slots": float(target),
            "resize_downtime_ms": downtime_ms,
        })
        return True

    def _resize_checkpoint(self, core, step: int,
                           last_checkpointed: int) -> str:
        """A COMPLETED checkpoint at the current step, committed before any
        device state is dropped, when the deadline leaves room for it;
        else the newest in the lineage. The chief's choice, every rank's."""
        core.checkpoint.wait()
        restore_id = f"trial{core.checkpoint._trial_id}-step{step}"
        if last_checkpointed != step:
            deadline = core.preempt.preemption_deadline()
            cfg = self._preempt_cfg or PreemptionConfig()
            attempt = bool(core.distributed.broadcast(
                cfg.should_attempt_save(deadline,
                                        core.checkpoint.last_save_ms)))
            if attempt:
                self._checkpoint(core, step)
                core.checkpoint.wait()  # COMMIT inside the grace window
            else:
                lineage = core.checkpoint.lineage()
                restore_id = lineage[0] if lineage else ""
                logger.warning(
                    "resize budget cannot cover a fresh save (deadline "
                    "%.1fs, last save %s ms); resharding from %s instead",
                    deadline or -1.0, core.checkpoint.last_save_ms,
                    restore_id)
            restore_id = core.distributed.broadcast(restore_id)
        if not restore_id:
            raise RuntimeError(
                "resize offered but no COMPLETED checkpoint exists and the "
                "deadline cannot cover one; cannot reshard")
        self._watchdog.beat()
        return restore_id

    def _transition(self, core, info: Dict[str, Any]) -> bool:
        """What every rank of the world does at a resize, in the same
        order: the distributed context and the mesh narrowed or widened to
        the first `target` ranks (collective over the whole world; a
        width's mesh is made once and reused, parallel/mesh.py). A rank inside the prefix then rebuilds the steps
        and restores `info["restore"]` (falling back through the lineage)
        into a template built from the checkpoint, without the trial's
        `init_params`; one outside drops its state and stands by. True
        when this rank trains."""
        target = int(info["target"])
        if self._parts is None:
            self._parts = {}  # a rank standing by
        with core.tracer.span("harness.reshard", target=target):
            self.state = None  # before the new one is allocated
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.monotonic()
            core.distributed.resize(target)
            self.mesh_config = self._check_mesh_support(target)
            self.mesh = create_mesh(self.mesh_config, self.device.type,
                                    ranks=target)
            self._note("groups", t0)
            if not core.distributed.active:
                self._train_step = self._eval_step = None
                self.resize_parts.append(self._parts)
                self._parts = None
                return False
            self._build_steps()
            if self._profile:
                self._set_profiler_devices(core)
            restored = self._restore_chain([info["restore"]], fresh=True)
            if restored is None:
                raise RuntimeError(
                    f"resize to {target} slots failed: no restorable "
                    f"checkpoint in the lineage of {info['restore']}")
        self._parts["restore_bytes"] = core.checkpoint.last_restore_bytes
        self._consumed = int(info["consumed"])
        # Re-arm the preemption watcher: this signal is consumed.
        core.preempt.reset()
        return True

    def _stand_by(self, core):
        """Wait outside the mesh for a transition that takes this rank in
        (-> the searcher ops from the chief's current one on, this rank's
        state restored) or for the end of the run (-> None). The ranks
        that train pay nothing for it: the chief sets a generation key on
        the default group's store at each transition and at the end, and
        a rank standing by polls for the next one."""
        self.state = None
        while True:
            info = self._next_generation(core)
            if info is None:
                return None
            if self._transition(core, info):
                length = int(info["op"])
                return itertools.chain(
                    [SearcherOperation(core.searcher, length)],
                    core.searcher.operations(after=length))

    def _note(self, part: str, t0: float) -> float:
        """Record `part` of the resize in progress as the ms since `t0`;
        -> now."""
        now = time.monotonic()
        if self._parts is not None:
            self._parts[f"{part}_ms"] = (now - t0) * 1e3
        return now

    def _generation_key(self, generation: int) -> str:
        return f"det.elastic.fit{self._fit_id}.gen{generation}"

    def _publish(self, core, info: Dict[str, Any]) -> None:
        import torch.distributed as dist

        store = dist.distributed_c10d._get_default_store()
        store.set(self._generation_key(self._generation + 1),
                  json.dumps(info))

    def _next_generation(self, core) -> Optional[Dict[str, Any]]:
        """The next generation's transition, or None for the end."""
        import torch.distributed as dist

        store = dist.distributed_c10d._get_default_store()
        key = self._generation_key(self._generation + 1)
        while not store.check([key]):
            time.sleep(0.02)
        self._generation += 1
        info = json.loads(store.get(key))
        return None if info.get("end") else info

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
        if self._compile_events:
            # The first calls' events land in the flush after them.
            events, self._compile_events = self._compile_events, []
            host["compile_ms"] = sum(e["compile_ms"] for e in events)
            host["compile_cache_hit"] = (
                1.0 if all(e["cache_hit"] for e in events) else 0.0)
            host["attention_impl"] = self._attention_impl
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
        cfg = self._compile_cfg
        if cfg is not None and cfg.bucket_batch_sizes:
            data = bucketed_iter(data, cfg)
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
            sums.update(zip(keys, global_mean([sums[k] for k in keys],
                                              self.mesh)))
        sums = _to_host(sums)
        avg = {k if k.startswith("validation_") else f"validation_{k}":
               float(v) / count for k, v in sums.items()}
        core.train.report_validation_metrics(step, avg)
        return avg

    def _multi_process(self) -> bool:
        return self.mesh is not None and self.mesh.size() > 1

    def _checkpoint(self, core, step: int) -> None:
        # A sharded state: each rank writes its pieces of the params and
        # of the moments that mirror them; nothing is gathered.
        core.checkpoint.save_state(state_mod.checkpoint_view(self.state),
                                   step)

    def _preempt_checkpoint(self, core, step: int,
                            last_checkpointed: int) -> None:
        """Preemption exit path. Unbounded preemption: save at the current
        step (fit's epilogue commits it). With a termination deadline: save
        and commit inside the window only if the last observed save cost
        fits the grace left, else commit what is pending and leave the
        previous COMPLETED checkpoint to restore from. A resize offer that
        cannot be served in process (`_can_resize_in_process`: cluster
        mode, or a size the mesh does not resolve) takes this path too:
        the master re-places the trial at its new size from this
        checkpoint."""
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

    def _restore_chain(self, candidates, fresh: bool = False
                       ) -> Optional[str]:
        """Try each candidate in order, extending with the lineage after the
        first failure. Missing (FileNotFoundError) and corrupt
        (CorruptCheckpoint) checkpoints fall through to the next
        candidate; anything else re-raises. `fresh`: restore into a
        template built from the candidate (a resize has no live state)."""
        assert self.state is not None or fresh
        with self.core.tracer.span(
                "harness.restore",
                requested=candidates[0] if candidates else "") as sp:
            restored = self._restore_chain_inner(candidates, fresh)
            if sp is not None:
                sp.attrs["restored"] = restored or ""
            return restored

    def _read_checkpoint(self, storage_id: str, fresh: bool) -> TrainState:
        """Checkpoint `storage_id` in the current layout: a sharded state
        reads only the pieces its shards overlap (no collective). At a
        resize the template is built from the checkpoint's own structure
        for the new mesh, and the restore writes into it."""
        ckpt = self.core.checkpoint
        if not fresh:
            return state_mod.from_checkpoint_view(ckpt.restore_state(
                storage_id, state_mod.checkpoint_view(self.state)))
        t0 = time.monotonic()
        template = state_mod.empty_train_state(
            ckpt.abstract_state(storage_id), self._tx, self.device,
            self.mesh, self.trial.param_logical_axes(),
            self.trial.sharding_rules())
        t1 = self._note("template", t0)
        restored = ckpt.restore_state(
            storage_id, state_mod.checkpoint_view(template), into=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._note("restore", t1)
        return state_mod.from_checkpoint_view(restored)

    def _restore_chain_inner(self, candidates, fresh: bool) -> Optional[str]:
        queue = list(candidates)
        tried = set()
        extended = not queue
        while queue:
            sid = queue.pop(0)
            if sid in tried:
                continue
            tried.add(sid)
            failure = None
            try:
                state = self._read_checkpoint(sid, fresh)
            except FileNotFoundError:
                failure = "missing"
            except core_mod.CorruptCheckpoint as e:
                failure = f"failed integrity verification ({e.reason})"
            if self._multi_process():
                # Each rank read its own pieces: a checkpoint is restored
                # only when every rank's read was sound.
                failure = next((f for f in self.core.distributed.allgather(
                    failure) if f), None)
            if failure is None:
                self.state = state
                logger.info("restored from checkpoint %s at step %d", sid,
                            self.state.step)
                return sid
            logger.warning("checkpoint %s %s; walking lineage back", sid,
                           failure)
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
