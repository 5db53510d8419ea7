"""TorchTrial — the class users subclass.

Counterpart of determined_tpu/train/trial.py's `TrialContext` and
`JaxTrial`, with the same method names and defaults. A trial is a bundle
of functions over a param tree of tensors; the Trainer owns the device and
the loop. Hyperparameters arrive via `self.context.hparams`.

What differs from the JAX package: `init_params` receives a
`torch.Generator` on the trainer's device instead of a `jax.random` key;
`optimizer()` returns a transformation of `train/optim.py`; and a run
has one process per device, so a loader yields this rank's rows of the
global batch (`TrialContext.distributed` says which), where a JAX process
yields its host's (`parallel.mesh.batch_shard` says which block).
`mesh_config()` may set `data` and `fsdp` above 1, `expert` for a
trial that declares `supports_expert_parallel()`, `tensor` and `context`
for a trial whose model splits its work over them (GPT-2, dense or MoE;
MNIST, ResNet and the diffusion UNet, which split over `tensor` and
compute replicated over `context`), and `pipeline` for a stateless trial
that implements `loss_pipelined()` (the Trainer selects it, and
`evaluate_pipelined()` when the trial has it); the Trainer raises for
`tensor`, `context` and `expert` for a trial whose
`supports_model_parallel()` is False.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Iterable, Optional

from determined_tpu_torch.parallel.mesh import MeshConfig
from determined_tpu_torch.parallel.sharding import LogicalRules
from determined_tpu_torch.train import optim


class TrialContext:
    """What a trial sees of its environment (hparams, per-host batch)."""

    def __init__(
        self,
        hparams: Optional[Dict[str, Any]] = None,
        core_context=None,
        global_batch_size: Optional[int] = None,
        n_devices: int = 1,
    ):
        self.hparams = dict(hparams or {})
        self.core = core_context
        self.n_devices = n_devices
        self._global_batch_size = global_batch_size or self.hparams.get(
            "global_batch_size", 32
        )

    def get_hparam(self, name: str, default: Any = None) -> Any:
        if default is None and name not in self.hparams:
            raise KeyError(f"hyperparameter {name!r} not set")
        return self.hparams.get(name, default)

    @property
    def global_batch_size(self) -> int:
        return int(self._global_batch_size)

    @property
    def optimizations(self) -> Dict[str, Any]:
        """The experiment config's `optimizations:` block. Local mode has
        no experiment config, so it is empty; callers .get() with the
        documented defaults."""
        info = getattr(self.core, "info", None)
        trial_info = getattr(info, "trial", None)
        cfg = getattr(trial_info, "config", None) or {}
        block = cfg.get("optimizations") if isinstance(cfg, dict) else None
        return dict(block) if isinstance(block, dict) else {}

    @property
    def per_device_batch_size(self) -> int:
        return max(1, self.global_batch_size // max(1, self.n_devices))

    @property
    def distributed(self):
        """The run's process topology (rank, size): the core context's,
        or one local process without one."""
        from determined_tpu_torch.core._distributed import DistributedContext

        dist = getattr(self.core, "distributed", None)
        return dist if dist is not None else DistributedContext.local()


class TorchTrial(abc.ABC):
    """Subclass and implement the pieces; Trainer does the rest."""

    # Trials that keep non-gradient state (BatchNorm stats) set this and use
    # the stateful loss signature (see train.step.make_train_step).
    stateful = False

    # The device prefetcher (determined_tpu_torch.data): None inherits the
    # experiment config's `prefetch:` block (default: on, depth 2); False
    # feeds each batch to the step with a copy there; a dict such as
    # {"depth": 4} tunes it. Loaders yield host batches: the pipeline owns
    # the copy to the device.
    prefetch = None

    def __init__(self, context: TrialContext):
        self.context = context

    # -- model ---------------------------------------------------------

    @abc.abstractmethod
    def init_params(self, rng) -> Any:
        """Build the initial parameter tree from `rng`, a torch.Generator
        on the trainer's device."""

    @abc.abstractmethod
    def loss(self, params, batch, rng):
        """Stateless: (params, batch, rng) -> loss | (loss, metrics).
        Stateful: (params, extra, batch, rng) -> (loss, metrics, new_extra)."""

    def loss_pipelined(self, params, batch, rng, mesh):
        """Pipeline-parallel loss, used by the Trainer whenever the mesh has
        `pipeline > 1`. Implementations run the model's layer stack through
        `parallel.pipeline.pipeline_apply` over `mesh` (see
        models/gpt2.loss_fn_pipelined). Trials that do not implement this
        cannot run with a pipeline axis: the Trainer refuses the mesh
        instead of silently running a gathered non-pipelined step."""
        raise NotImplementedError

    def supports_pipeline(self) -> bool:
        return type(self).loss_pipelined is not TorchTrial.loss_pipelined

    def init_extra(self) -> Any:
        """Initial non-gradient state (stateful trials only)."""
        return None

    def optimizer(self) -> optim.GradientTransformation:
        lr = self.context.hparams.get("learning_rate", 1e-3)
        return optim.adamw(lr)

    def param_logical_axes(self) -> Optional[Any]:
        """Tree of logical-axis tuples for the param layout; None ->
        replicate every leaf."""
        return None

    def sharding_rules(self) -> LogicalRules:
        return LogicalRules()

    def mesh_config(self) -> MeshConfig:
        """Default: pure data parallel over the run's devices (the `mesh`
        hparam block when set)."""
        mc = self.context.hparams.get("mesh")
        return MeshConfig.from_dict(mc) if mc else MeshConfig()

    def supports_model_parallel(self) -> bool:
        """False for a trial whose model splits no work over the `tensor`,
        `context` or `expert` axes and would compute with its leaves laid
        out by their logical axes anyway (a model of the user's own that
        takes the port's sharded state without the collectives): the
        Trainer refuses those axes above 1 for it, before any state is
        built. The port's models (models/gpt2.py, mnist.py, resnet.py,
        diffusion.py) split their work, so the default is True."""
        return True

    def supports_expert_parallel(self) -> bool:
        """Trials whose model routes tokens over the mesh `expert` axis (an
        MoE block, ops/moe.py) override this to return True. A mesh asking
        for `expert > 1` is refused for the others: a decoy expert axis
        would replicate the work across those devices."""
        return False

    # -- data ----------------------------------------------------------

    @abc.abstractmethod
    def build_training_data(self) -> Iterable[Any]:
        """Iterable of batches (dicts of numpy arrays or tensors): in a run
        of several processes, this rank's rows of each global batch.
        Restarts when exhausted; infinite iterators are idiomatic."""

    def build_validation_data(self) -> Iterable[Any]:
        return ()

    # -- evaluation ----------------------------------------------------

    def evaluate(self, params, batch) -> Dict[str, Any]:
        """Per-batch validation metrics; averaged over batches by the Trainer.
        Stateful trials receive (params, extra, batch)."""
        raise NotImplementedError(
            "implement evaluate() or leave build_validation_data() empty"
        )

    def evaluate_pipelined(self, params, batch, mesh) -> Dict[str, Any]:
        """Pipeline-parallel evaluate, selected by the Trainer when
        mesh.pipeline > 1 (mirrors loss/loss_pipelined). Without it, the
        plain evaluate() runs under the pipeline mesh with every stage's
        layers gathered: correct but slow; the Trainer warns."""
        raise NotImplementedError

    def supports_pipelined_eval(self) -> bool:
        return (type(self).evaluate_pipelined
                is not TorchTrial.evaluate_pipelined)

    # -- knobs ----------------------------------------------------------

    def flops_per_step(self) -> Optional[float]:
        """Model FLOPs per global optimizer step (fwd+bwd). When provided,
        the profiler reports a `device_flops_util` series."""
        return None

    def searcher_metric(self, val_metrics: Dict[str, Any]) -> float:
        """Scalar the HP searcher optimises; default: validation loss."""
        for k in ("validation_loss", "loss"):
            if k in val_metrics:
                return float(val_metrics[k])
        return float(next(iter(val_metrics.values())))
