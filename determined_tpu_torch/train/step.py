"""Train and eval step factories.

Counterpart of determined_tpu/train/step.py on one device. The JAX package
jits forward, backward and the optimizer update into one program per
trial; PyTorch runs eagerly, so a step here is the same sequence of calls
(the CUDA kernels and PyTorch's own) issued from the host without a sync.
Meshes, input shardings and `make_multi_step` are not ported
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from determined_tpu_torch.train import optim
from determined_tpu_torch.train.state import TrainState

# loss_fn(params, batch, rng) -> scalar loss OR (loss, aux_metrics)
LossFn = Callable[..., Any]


def _call_loss(loss_fn: LossFn, params, batch, rng
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    out = loss_fn(params, batch, rng)
    if isinstance(out, tuple):
        loss, aux = out
    else:
        loss, aux = out, {}
    return loss, aux


def make_train_step(loss_fn: LossFn, tx: optim.GradientTransformation,
                    stateful: bool = False):
    """Build `step(state, batch, rng) -> (state, metrics)`.

    Stateless (default): loss_fn(params, batch, rng) -> loss | (loss,
    metrics). Stateful (BatchNorm etc.): loss_fn(params, extra, batch, rng)
    -> (loss, metrics, new_extra); new_extra lands in state.extra.

    metrics always include `loss`, `grad_norm` (the global norm of the raw
    gradients, before any clipping in `tx`) and `all_finite`, as fp32
    device scalars: nothing here waits for the device. The state is
    updated in place and returned.
    """

    def step(state: TrainState, batch: Any, rng: torch.Generator):
        params = state.leaves()
        if stateful:
            loss, aux, new_extra = loss_fn(state.params, state.extra, batch,
                                           rng)
        else:
            loss, aux = _call_loss(loss_fn, state.params, batch, rng)
            new_extra = None
        loss = loss.float()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            gnorm = optim.global_norm(grads)
            # Divergence sentinel (train/health.py): grad_norm reduces over
            # every gradient leaf, so a NaN/Inf anywhere reaches it; one
            # logical-and over (loss, grad_norm) covers the whole step.
            all_finite = torch.logical_and(torch.isfinite(loss),
                                           torch.isfinite(gnorm))
            state.apply_gradients(grads, tx, new_extra)
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in aux.items()}
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "all_finite": all_finite.float(), **aux}
        return state, metrics

    return step


def make_eval_step(eval_fn: Callable[..., Dict[str, Any]],
                   stateful: bool = False):
    """Build `eval_step(state, batch) -> metrics` (per-batch sums/means),
    run without autograd. Stateless: eval_fn(params, batch); stateful:
    eval_fn(params, extra, batch)."""

    def step(state: TrainState, batch: Any):
        with torch.no_grad():
            if stateful:
                return eval_fn(state.params, state.extra, batch)
            return eval_fn(state.params, batch)

    return step
