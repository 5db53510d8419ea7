"""PyTorchTrial / PyTorchTrialContext / Trainer on the port's core.

Counterpart of determined_tpu/pytorch/_trial.py (reference
harness/determined/pytorch/: the user overrides `__init__`,
`train_batch`, `evaluate_batch` and `build_*_data_loader`; the controller
owns the run loop, driven by the searcher's operations and the Core API).
The loop, the validation reduction, the preemption save and the
checkpoint format follow the JAX package's line for line. What differs:

  - the device is `resolve_device`'s: CUDA, or raise; the CPU only when
    the caller names it (`device="cpu"`). Under the GPU-slot launcher the
    process's device is `cuda:<local rank>` (modulo the devices it sees),
    and DDP is given that device;
  - the process group is the port's `DistributedContext` (nccl on CUDA,
    gloo on the CPU; `DET_TORCH_BACKEND` names another), whose control
    plane is a gloo group;
  - a model sharded by torch's FSDP (`FullyShardedDataParallel`, or
    `fully_shard`'s `FSDPModule`) is not wrapped in DDP, and every rank
    saves its own shard, `state-rank{r}.pt`, into one checkpoint through
    `upload(shard=True)`.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Union

import torch

from determined_tpu_torch import core
from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.core._distributed import DistributedContext

logger = logging.getLogger("determined_tpu_torch.pytorch")

TorchData = Union[Dict[str, torch.Tensor], List[torch.Tensor], torch.Tensor]


def init_torch_distributed(device: torch.device
                           ) -> Optional[DistributedContext]:
    """The process group of a launched run (`launch/torch_distributed.py`'s
    RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): nccl for a
    CUDA `device`, gloo for the CPU, unless DET_TORCH_BACKEND names one.
    None when the run is one process."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    env = dict(os.environ)
    env.setdefault("DET_TORCH_BACKEND",
                   "nccl" if device.type == "cuda" else "gloo")
    return DistributedContext.from_env(env)


def _is_fsdp(model: torch.nn.Module) -> bool:
    """True when torch's FSDP shards the model or any of its modules: it
    then owns its gradient communication."""
    from torch.distributed.fsdp import FSDPModule, FullyShardedDataParallel

    return any(isinstance(m, (FSDPModule, FullyShardedDataParallel))
               for m in model.modules())


def _unwrap(model: torch.nn.Module) -> torch.nn.Module:
    if isinstance(model, torch.nn.parallel.DistributedDataParallel):
        return model.module
    return model


class DataLoader:
    """Thin wrapper mirroring determined.pytorch.DataLoader (pytorch/_data.py):
    records constructor args so the controller can apply per-worker sharding
    (reference samplers.py) before building the real torch DataLoader."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 **kwargs: Any):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.kwargs = kwargs

    def get_data_loader(self, num_replicas: int = 1, rank: int = 0):
        sampler = None
        shuffle = self.shuffle
        if num_replicas > 1:
            sampler = torch.utils.data.distributed.DistributedSampler(
                self.dataset, num_replicas=num_replicas, rank=rank,
                shuffle=self.shuffle,
            )
            shuffle = False
        return torch.utils.data.DataLoader(
            self.dataset, batch_size=self.batch_size, shuffle=shuffle,
            sampler=sampler, **self.kwargs,
        )


class PyTorchTrialContext:
    """Services exposed to the user trial (reference _pytorch_context.py).
    `device` defaults to CUDA, which raises without a card; pass "cpu" to
    run on the CPU."""

    def __init__(self, core_context: Optional[core.Context] = None,
                 hparams: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        # Process group first (before any wrap_model): construction order is
        # context -> trial (__init__ wraps models) -> Trainer.
        self.dist = init_torch_distributed(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            local = self.dist.local_rank if self.dist is not None else 0
            self.device = torch.device(
                "cuda", local % torch.cuda.device_count())
        self._core = core_context
        self._hparams = hparams or (core_context.hparams if core_context else {})
        self.models: List[torch.nn.Module] = []
        self.optimizers: List[torch.optim.Optimizer] = []
        self.lr_schedulers: List[Any] = []

    # -- user surface --------------------------------------------------
    def get_hparam(self, name: str) -> Any:
        if name not in self._hparams:
            raise KeyError(f"hparam {name!r} not set")
        return self._hparams[name]

    def get_hparams(self) -> Dict[str, Any]:
        return dict(self._hparams)

    def wrap_model(self, model: torch.nn.Module) -> torch.nn.Module:
        """Move to the device; wrap in DistributedDataParallel when launched
        distributed (reference _pytorch_context.py:297), unless FSDP
        shards it."""
        model = model.to(self.device)
        if self.dist is not None and self.dist.size > 1 and not _is_fsdp(model):
            # FSDP-wrapped models already own their gradient comms — DDP on
            # top would all-reduce reduce-scattered shards (wrong grads).
            device_ids = [self.device] if self.device.type == "cuda" else None
            model = torch.nn.parallel.DistributedDataParallel(
                model, device_ids=device_ids)
        self.models.append(model)
        return model

    def wrap_optimizer(self, optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
        self.optimizers.append(optimizer)
        return optimizer

    def wrap_lr_scheduler(self, scheduler: Any) -> Any:
        self.lr_schedulers.append(scheduler)
        return scheduler

    def backward(self, loss: torch.Tensor) -> None:
        loss.backward()

    def step_optimizer(self, optimizer: torch.optim.Optimizer) -> None:
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def to_device(self, data: TorchData) -> TorchData:
        if isinstance(data, dict):
            return {k: self.to_device(v) for k, v in data.items()}
        if isinstance(data, (list, tuple)):
            return type(data)(self.to_device(v) for v in data)
        if isinstance(data, torch.Tensor):
            return data.to(self.device)
        return data

    @property
    def distributed(self):
        return self._core.distributed if self._core else None


class PyTorchTrial:
    """User subclass surface (reference _pytorch_trial.py:1391)."""

    def __init__(self, context: PyTorchTrialContext):
        self.context = context

    def train_batch(self, batch: TorchData, epoch_idx: int,
                    batch_idx: int) -> Dict[str, Any]:
        raise NotImplementedError

    def evaluate_batch(self, batch: TorchData,
                       batch_idx: int) -> Dict[str, Any]:
        raise NotImplementedError

    def build_training_data_loader(self) -> DataLoader:
        raise NotImplementedError

    def build_validation_data_loader(self) -> DataLoader:
        raise NotImplementedError

    # Optional checkpoint hooks (reference save/load in the controller).
    def state_dict_extras(self) -> Dict[str, Any]:
        return {}

    def load_state_dict_extras(self, extras: Dict[str, Any]) -> None:
        pass


class Trainer:
    """Controller + Trainer.fit (reference _trainer.py:70 +
    _PyTorchTrialController.run :548)."""

    def __init__(self, trial: PyTorchTrial,
                 core_context: Optional[core.Context] = None):
        self.trial = trial
        self.context = trial.context
        self.dist = self.context.dist
        self.core = core_context or self.context._core or core.init(
            max_length=100, distributed=self.dist
        )
        if (
            self.dist is not None
            and self.core.distributed.size != self.dist.size
        ):
            # A core context that doesn't know the torch process group would
            # make every rank act as chief (N-fold op completions/reports).
            raise ValueError(
                f"core context distributed size "
                f"{self.core.distributed.size} != torch world size "
                f"{self.dist.size}; build it with "
                "core.init(distributed=trial.context.dist)"
            )

    @property
    def _world(self) -> int:
        return self.dist.size if self.dist is not None else 1

    @property
    def _rank(self) -> int:
        return self.dist.rank if self.dist is not None else 0

    # -- checkpointing -------------------------------------------------
    def _sharded_models(self) -> bool:
        return any(_is_fsdp(m) for m in self.context.models)

    def _state(self, steps_completed: int) -> Dict[str, Any]:
        return {
            "models": [_unwrap(m).state_dict() for m in self.context.models],
            "optimizers": [o.state_dict() for o in self.context.optimizers],
            "steps_completed": steps_completed,
            "extras": self.trial.state_dict_extras(),
        }

    def _save(self, steps_completed: int) -> None:
        if self._sharded_models() and self._world > 1:
            # FSDP: each rank's state_dict holds only ITS shard — every rank
            # uploads state-rank{r}.pt into one storage id (sharded upload,
            # reference core/_checkpoint.py:282 semantics).
            with tempfile.TemporaryDirectory() as td:
                torch.save(self._state(steps_completed),
                           os.path.join(td, f"state-rank{self._rank}.pt"))
                self.core.checkpoint.upload(
                    td,
                    metadata={"steps_completed": steps_completed,
                              "framework": "pytorch", "sharded": True,
                              "world_size": self._world},
                    shard=True,
                )
            return
        if self.dist is not None and not self.dist.is_chief:
            self.dist.barrier("ckpt")  # chief writes; workers wait
            return
        with self.core.checkpoint.store_path(
            {"steps_completed": steps_completed, "framework": "pytorch"}
        ) as (path, _sid):
            torch.save(self._state(steps_completed), f"{path}/state.pt")
        if self.dist is not None:
            self.dist.barrier("ckpt")

    def _restore(self) -> int:
        latest = self.core.latest_checkpoint
        if not latest:
            return 0
        with self.core.checkpoint.restore_path(latest) as path:
            sharded = os.path.join(path, f"state-rank{self._rank}.pt")
            fname = sharded if os.path.exists(sharded) else f"{path}/state.pt"
            if not os.path.exists(fname):
                raise FileNotFoundError(
                    f"checkpoint {latest}: no {os.path.basename(sharded)} or "
                    "state.pt — resuming a sharded checkpoint needs the same "
                    "world size it was saved with"
                )
            state = torch.load(fname, map_location=self.context.device,
                               weights_only=False)
        for model, sd in zip(self.context.models, state["models"]):
            _unwrap(model).load_state_dict(sd)
        for opt, sd in zip(self.context.optimizers, state["optimizers"]):
            opt.load_state_dict(sd)
        self.trial.load_state_dict_extras(state.get("extras", {}))
        logger.info("restored at step %d", state["steps_completed"])
        return int(state["steps_completed"])

    def _validate(self, steps_completed: int) -> Dict[str, Any]:
        # Each rank evaluates its shard; sums are reduced over the control
        # plane (reference: distributed metric reducers, pytorch/_reducer.py).
        loader = self.trial.build_validation_data_loader().get_data_loader(
            num_replicas=self._world, rank=self._rank
        )
        for model in self.context.models:
            model.eval()
        totals: Dict[str, float] = {}
        n = 0
        with torch.no_grad():
            for batch_idx, batch in enumerate(loader):
                batch = self.context.to_device(batch)
                metrics = self.trial.evaluate_batch(batch, batch_idx)
                for k, v in metrics.items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                n += 1
        for model in self.context.models:
            model.train()
        if self.dist is not None and self.dist.size > 1:
            parts = self.dist.allgather((totals, n))
            totals, n = {}, 0
            for t, c in parts:
                n += c
                for k, v in t.items():
                    totals[k] = totals.get(k, 0.0) + v
        reduced = {k: v / max(n, 1) for k, v in totals.items()}
        self.core.train.report_validation_metrics(steps_completed, reduced)
        return reduced

    def fit(
        self,
        validation_period: int = 0,  # batches; 0 = only at op boundaries
        checkpoint_period: int = 0,
        searcher_metric: Optional[str] = None,
        report_period: int = 10,
    ) -> int:
        """Run the searcher-driven train/validate/checkpoint loop; returns
        total batches trained."""
        steps = self._restore()
        epoch_idx = 0
        data_iter: Optional[Iterator] = None

        def next_batch():
            nonlocal data_iter, epoch_idx
            while True:
                if data_iter is None:
                    dl = self.trial.build_training_data_loader().get_data_loader(
                        num_replicas=self._world, rank=self._rank
                    )
                    data_iter = iter(dl)
                try:
                    return next(data_iter)
                except StopIteration:
                    data_iter = None
                    epoch_idx += 1

        window: Dict[str, float] = {}
        window_n = 0
        for op in self.core.searcher.operations():
            while steps < op.length:
                batch = self.context.to_device(next_batch())
                metrics = self.trial.train_batch(batch, epoch_idx, steps)
                steps += 1
                for k, v in metrics.items():
                    try:
                        window[k] = window.get(k, 0.0) + float(v)
                    except (TypeError, ValueError):
                        continue
                window_n += 1
                if steps % report_period == 0 or steps == op.length:
                    self.core.train.report_training_metrics(
                        steps, {k: v / window_n for k, v in window.items()}
                    )
                    window, window_n = {}, 0
                if validation_period and steps % validation_period == 0:
                    self._validate(steps)
                if checkpoint_period and steps % checkpoint_period == 0:
                    self._save(steps)
                if self.core.preempt.should_preempt():
                    self._save(steps)
                    logger.info("preempted at step %d", steps)
                    return steps
            val_metrics = self._validate(steps)
            metric_name = searcher_metric or (
                self.core.info.trial.config.get("searcher", {}).get("metric")
                if self.core.info and self.core.info.trial else None
            )
            if metric_name is not None and metric_name not in val_metrics:
                # Reporting an arbitrary substitute would corrupt ASHA
                # promotion ordering; fail loudly like keras/_trial.py and
                # the reference do.
                raise KeyError(
                    f"searcher metric {metric_name!r} not in validation "
                    f"metrics {sorted(val_metrics)}"
                )
            metric_value = (
                val_metrics[metric_name]
                if metric_name is not None
                else next(iter(val_metrics.values()), 0.0)
            )
            op.report_completed(float(metric_value))
            self._save(steps)
        return steps
