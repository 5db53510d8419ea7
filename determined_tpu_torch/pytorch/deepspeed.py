"""DeepSpeedTrial-shaped compat surface on the port's core.

The port's copy of determined_tpu/pytorch/deepspeed.py. Reference:
harness/determined/pytorch/deepspeed/_deepspeed_trial.py:729 (user
train_batch receives the data iterator and drives the engine's microbatch
loop; save/load :908,924 are engine-sharded checkpoints) and _mpu.py:9-46
(ModelParallelUnit — which ranks report metrics / build data loaders under
model parallelism).

Users arriving from the reference bring DeepSpeedTrial subclasses, so the
platform ships the same API shape over any deepspeed-compatible engine
object (duck-typed: train_micro_batch_size_per_gpu /
gradient_accumulation_steps / backward / step / save_checkpoint /
load_checkpoint): the port's own ZeRO-1 engine (zero.py) or another. No
deepspeed import happens here.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Iterator, Optional

from determined_tpu_torch import core
from determined_tpu_torch.pytorch._trial import (
    DataLoader,
    PyTorchTrialContext,
    TorchData,
)

logger = logging.getLogger("determined_tpu_torch.pytorch.deepspeed")


class ModelParallelUnit:
    """Which ranks own data loading / metric reporting (reference
    _mpu.py:9-46). Pure-data-parallel engines use make_data_parallel_mpu;
    pipeline/tensor-parallel engines pass their topology's answers."""

    def __init__(
        self,
        data_parallel_rank: int,
        data_parallel_world_size: int,
        should_report_metrics: bool,
        should_build_data_loader: bool,
    ):
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_world_size = data_parallel_world_size
        self.should_report_metrics = should_report_metrics
        self.should_build_data_loader = should_build_data_loader


def make_data_parallel_mpu(dist) -> ModelParallelUnit:
    rank = dist.rank if dist is not None else 0
    size = dist.size if dist is not None else 1
    return ModelParallelUnit(
        data_parallel_rank=rank,
        data_parallel_world_size=size,
        should_report_metrics=True,
        should_build_data_loader=True,
    )


class DeepSpeedTrialContext(PyTorchTrialContext):
    """Reference _deepspeed_context.py:45: engine registration + MPU."""

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.engines: list = []
        self._mpu: Optional[ModelParallelUnit] = None
        self._auto_grad_accum = True

    def wrap_model_engine(self, engine: Any) -> Any:
        """Register a deepspeed engine. The engine owns device placement
        and gradient comms — no DDP wrap, no .to(device)."""
        self.engines.append(engine)
        if self._mpu is None:
            self._mpu = make_data_parallel_mpu(self.dist)
        return engine

    def wrap_mpu(self, mpu: ModelParallelUnit) -> ModelParallelUnit:
        """Install a topology-aware MPU (pipeline/tensor-parallel engines:
        only data-parallel-rank-0 of each replica group reports/loads)."""
        self._mpu = mpu
        return mpu

    def disable_auto_grad_accumulation(self) -> None:
        """User train_batch consumes exactly one microbatch per call
        instead of a full gradient-accumulation window."""
        self._auto_grad_accum = False

    @property
    def mpu(self) -> ModelParallelUnit:
        if self._mpu is None:
            self._mpu = make_data_parallel_mpu(self.dist)
        return self._mpu

    def get_train_micro_batch_size_per_gpu(self) -> int:
        if not self.engines:
            raise RuntimeError("wrap_model_engine() has not been called")
        return int(self.engines[0].train_micro_batch_size_per_gpu())

    def num_micro_batches_per_slot(self) -> int:
        if not self.engines:
            raise RuntimeError("wrap_model_engine() has not been called")
        if not self._auto_grad_accum:
            return 1
        return int(self.engines[0].gradient_accumulation_steps())


class DeepSpeedTrial:
    """User subclass surface (reference _deepspeed_trial.py:729).

    train_batch/evaluate_batch receive the DATA ITERATOR, not a batch —
    the user pulls `num_micro_batches_per_slot()` microbatches and drives
    engine.backward()/engine.step() per microbatch (the engine internally
    steps the optimizer at accumulation boundaries)."""

    trial_context_class = DeepSpeedTrialContext

    def __init__(self, context: DeepSpeedTrialContext):
        self.context = context

    def train_batch(self, dataloader_iter: Optional[Iterator[TorchData]],
                    epoch_idx: int, batch_idx: int) -> Dict[str, Any]:
        raise NotImplementedError

    def evaluate_batch(self, dataloader_iter: Optional[Iterator[TorchData]],
                       batch_idx: int) -> Dict[str, Any]:
        raise NotImplementedError

    def build_training_data_loader(self) -> Optional[DataLoader]:
        raise NotImplementedError

    def build_validation_data_loader(self) -> Optional[DataLoader]:
        raise NotImplementedError

    def save(self, context: DeepSpeedTrialContext, path: str) -> None:
        """Engine-sharded save (reference :908): every rank participates —
        deepspeed writes per-rank shards under `path`."""
        for i, engine in enumerate(context.engines):
            engine.save_checkpoint(path, tag=f"engine{i}")

    def load(self, context: DeepSpeedTrialContext, path: str) -> None:
        """Engine-sharded load (reference :924)."""
        for i, engine in enumerate(context.engines):
            engine.load_checkpoint(path, tag=f"engine{i}")


class DeepSpeedTrainer:
    """Searcher-driven loop for DeepSpeedTrial (reference
    _deepspeed_trial.py controller :37). One step = one train_batch call =
    one full gradient-accumulation window through the engine."""

    def __init__(self, trial: DeepSpeedTrial,
                 core_context: Optional[core.Context] = None):
        self.trial = trial
        self.context = trial.context
        self.dist = self.context.dist
        self.core = core_context or self.context._core or core.init(
            max_length=100, distributed=self.dist)
        if not self.context.engines:
            raise ValueError(
                "trial must wrap_model_engine() in __init__ before fit()")

    @property
    def _mpu(self) -> ModelParallelUnit:
        return self.context.mpu

    def _data_iter(self, build) -> Optional[Iterator]:
        """Ranks whose MPU says they don't own a data loader hand None to
        train_batch/evaluate_batch (reference: model-parallel peers receive
        activations, not data)."""
        if not self._mpu.should_build_data_loader:
            return None
        loader = build()
        if loader is None:
            return None
        dl = loader.get_data_loader(
            num_replicas=self._mpu.data_parallel_world_size,
            rank=self._mpu.data_parallel_rank)

        def forever():
            while True:
                for batch in dl:
                    yield self.context.to_device(batch)

        return forever()

    def _save(self, steps_completed: int) -> None:
        import json
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            self.trial.save(self.context, td)
            if self.dist is None or self.dist.is_chief:
                # Trainer state rides inside the checkpoint (metadata in
                # the registry is for humans; restore must not depend on
                # a registry round-trip).
                with open(os.path.join(td, "ds_trainer.json"), "w") as f:
                    json.dump({"steps_completed": steps_completed}, f)
            self.core.checkpoint.upload(
                td,
                metadata={"steps_completed": steps_completed,
                          "framework": "deepspeed", "sharded": True},
                shard=True,
            )

    def _restore(self) -> int:
        import json

        latest = self.core.latest_checkpoint
        if not latest:
            return 0
        with self.core.checkpoint.restore_path(latest) as path:
            self.trial.load(self.context, str(path))
            state_file = os.path.join(str(path), "ds_trainer.json")
            if os.path.exists(state_file):
                with open(state_file) as f:
                    return int(json.load(f).get("steps_completed", 0))
        return 0

    def _validate(self, steps: int) -> Dict[str, Any]:
        it = self._data_iter(self.trial.build_validation_data_loader)
        metrics = self.trial.evaluate_batch(it, 0)
        reduced = {k: float(v) for k, v in metrics.items()}
        if self.dist is not None and self.dist.size > 1:
            parts = self.dist.allgather(reduced)
            reduced = {
                k: sum(p[k] for p in parts) / len(parts) for k in reduced
            }
        if self._mpu.should_report_metrics and (
                self.dist is None or self.dist.is_chief):
            self.core.train.report_validation_metrics(steps, reduced)
        return reduced

    def fit(self, searcher_metric: Optional[str] = None,
            report_period: int = 10,
            checkpoint_period: int = 0) -> int:
        steps = self._restore()
        data_iter = self._data_iter(self.trial.build_training_data_loader)
        window: Dict[str, float] = {}
        window_n = 0
        for op in self.core.searcher.operations():
            while steps < op.length:
                metrics = self.trial.train_batch(data_iter, 0, steps)
                steps += 1
                for k, v in metrics.items():
                    try:
                        window[k] = window.get(k, 0.0) + float(v)
                    except (TypeError, ValueError):
                        continue
                window_n += 1
                if (steps % report_period == 0 or steps == op.length) and \
                        self._mpu.should_report_metrics and (
                            self.dist is None or self.dist.is_chief):
                    self.core.train.report_training_metrics(
                        steps, {k: v / window_n for k, v in window.items()})
                    window, window_n = {}, 0
                if checkpoint_period and steps % checkpoint_period == 0:
                    self._save(steps)
                if self.core.preempt.should_preempt():
                    self._save(steps)
                    logger.info("preempted at step %d", steps)
                    return steps
            val = self._validate(steps)
            metric = (val.get(searcher_metric)
                      if searcher_metric else
                      next(iter(val.values()), 0.0))
            if searcher_metric and metric is None:
                raise KeyError(
                    f"searcher metric {searcher_metric!r} not in validation "
                    f"metrics {sorted(val)}")
            op.report_completed(float(metric))
            self._save(steps)
        return steps
