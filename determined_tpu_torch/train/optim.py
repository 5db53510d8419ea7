"""The optax transformations the trials use, in PyTorch.

The JAX package takes its optimizers from optax; the port keeps its own
copy of the pieces the flagship example chains (examples/gpt2/model_def.py
`optimizer()`) and of `JaxTrial.optimizer`'s default, with optax's exact
arithmetic and defaults:

  - `clip_by_global_norm(max_norm)`: `g * max_norm / norm` only when
    `norm >= max_norm` (no epsilon, unlike `torch.nn.utils.clip_grad_norm_`);
  - `adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)`: Adam's
    bias-corrected update, plus `weight_decay * param` on every leaf (no
    mask), times `-lr`; `lr` may be a schedule, read at the step count
    BEFORE the increment, as `optax.scale_by_schedule` does;
  - `sgd(lr, momentum=None, nesterov=False)`: optax's `trace` (`t <- g +
    momentum * t`; the update `g + momentum * t` with nesterov, else `t`)
    then `-lr` times it (the MNIST and ResNet trials);
  - `warmup_cosine_decay_schedule`, `linear_schedule`,
    `cosine_decay_schedule`: the optax schedules (step 0 of a warmup from
    0 has lr 0);
  - `chain(...)`.

A transformation has optax's shape, `init(params) -> state` and
`update(grads, state, params) -> (updates, state)`, over flat lists of
tensors (`TrainState` flattens the param tree). The JAX package's updates
are pure; these update `grads` and the moment buffers in place, as JAX's
buffer donation lets XLA do, and `apply_updates` adds into the params in
place. Counts are host integers, so no step reads a value back from the
device.

A step captured as a CUDA graph (`train/step.make_multi_step`) cannot
take the host floats an update computes from its count (the learning rate
of a schedule, Adam's bias corrections): the graph would replay the
capture's values. So each transformation also has `hyper(state) ->
(floats, next_state)`, the host floats its next update reads and the
state after that update's host bookkeeping, and its `update` takes them
as a device tensor (`hyper=`) instead of computing them: the caller fills
the tensor before each replay and advances the host state with
`next_state`. A transformation whose `hyper` is None cannot be replayed.

Sharded leaves (DTensor params, `parallel/sharding.py`) reach the
transformations as their local tensors in a `LocalShards` list, which
carries the reduction of the global norm: each shard counted once, each
replica once.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]


class GradientTransformation(NamedTuple):
    init: Callable[[List[torch.Tensor]], Any]
    update: Callable[..., Tuple[List[torch.Tensor], Any]]
    hyper: Optional[Callable[[Any], Tuple[List[float], Any]]] = None


class LocalShards(list):
    """The local tensors of a list of leaves, some of them shards of
    sharded leaves, with `sq_sum(tensors) -> 0-d tensor`: the global sum of
    squares of the leaves they are pieces of (a collective)."""

    def __init__(self, tensors, sq_sum: Callable[[Sequence[torch.Tensor]],
                                                 torch.Tensor]):
        super().__init__(tensors)
        self.sq_sum = sq_sum


# ---------------------------------------------------------------- schedules


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return lambda count: float(init_value)

    def schedule(count: int) -> float:
        c = min(max(count - transition_begin, 0), transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warmup from `init_value` to `peak_value` over `warmup_steps`,
    then cosine decay to `end_value` at `decay_steps` (which includes the
    warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha, exponent)

    def schedule(count: int) -> float:
        return warm(count) if count < warmup_steps else \
            decay(count - warmup_steps)

    return schedule


# ------------------------------------------------------------ transforms


def sq_sum(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of squares over every tensor, fp32, on their device."""
    return sum(torch.sum(t.float() * t.float()) for t in tensors)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every leaf), fp32, on the leaves' device;
    for `LocalShards`, over the full leaves they are pieces of."""
    if isinstance(tensors, LocalShards):
        return torch.sqrt(tensors.sq_sum(tensors))
    return torch.sqrt(sq_sum(tensors))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(grads, state, params=None, hyper=None):
        g_norm = global_norm(grads)
        trigger = g_norm < max_norm
        for g in grads:
            g.copy_(torch.where(trigger, g, (g / g_norm.to(g.dtype))
                                * max_norm))
        return grads, state

    return GradientTransformation(init, update, lambda state: ([], state))


def _as_schedule(lr: ScalarOrSchedule) -> Schedule:
    return lr if callable(lr) else (lambda count: float(lr))


def adamw(learning_rate: ScalarOrSchedule, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: scale_by_adam, add_decayed_weights, scale_by_lr."""
    schedule = _as_schedule(learning_rate)

    def init(params):
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def next_floats(state):
        """(-lr, 1 - b1^t, 1 - b2^t) of the next update (t = count + 1;
        the schedule reads the count before the increment)."""
        count = state["count"] + 1
        return ([-schedule(state["count"]), 1 - b1 ** count, 1 - b2 ** count],
                {"count": count, "mu": state["mu"], "nu": state["nu"]})

    def update(grads, state, params, hyper=None):
        mu, nu = state["mu"], state["nu"]
        floats, new_state = next_floats(state)
        if hyper is None:
            # The floats as a device tensor here too, so an eager update
            # does the arithmetic of a replayed one (a foreach op by a
            # tensor scalar rounds otherwise than by a Python float).
            hyper = torch.tensor(floats, dtype=torch.float32)
            if mu and mu[0].is_cuda:
                hyper = hyper.to(mu[0].device, non_blocking=True)
        neg_lr, bc1, bc2 = hyper.unbind(0)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        mu_hat = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(mu_hat, denom)
        if weight_decay:
            torch._foreach_add_(mu_hat, params, alpha=weight_decay)
        torch._foreach_mul_(mu_hat, neg_lr)
        for g, u in zip(grads, mu_hat):
            g.copy_(u)
        return grads, new_state

    return GradientTransformation(init, update, next_floats)


def sgd(learning_rate: ScalarOrSchedule, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    """optax.sgd: `trace(decay=momentum, nesterov)` when `momentum` is set,
    then `scale_by_learning_rate`. Each product is rounded on its own, as
    optax's are (no fused multiply-add): `t = g + momentum * t`."""
    schedule = _as_schedule(learning_rate)

    def init(params):
        trace = None if momentum is None else \
            [torch.zeros_like(p) for p in params]
        return {"count": 0, "trace": trace}

    def next_floats(state):
        """[-lr] of the next update, the schedule read at the count before
        the increment."""
        return ([-schedule(state["count"])],
                {"count": state["count"] + 1, "trace": state["trace"]})

    def update(grads, state, params=None, hyper=None):
        floats, new_state = next_floats(state)
        if hyper is None:
            hyper = torch.tensor(floats, dtype=torch.float32)
            if grads and grads[0].is_cuda:
                hyper = hyper.to(grads[0].device, non_blocking=True)
        trace = state["trace"]
        if trace is not None:
            torch._foreach_mul_(trace, momentum)
            torch._foreach_add_(trace, grads)
            if nesterov:
                torch._foreach_add_(grads, torch._foreach_mul(trace, momentum))
            else:
                for g, t in zip(grads, trace):
                    g.copy_(t)
        torch._foreach_mul_(grads, hyper[0])
        return grads, new_state

    return GradientTransformation(init, update, next_floats)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def next_floats(state):
        floats, states = [], []
        for t, s in zip(transforms, state):
            f, s = t.hyper(s)
            floats += f
            states.append(s)
        return floats, tuple(states)

    def update(grads, state, params=None, hyper=None):
        new_state = []
        off = 0
        for t, s in zip(transforms, state):
            part = None
            if hyper is not None:
                n = len(t.hyper(s)[0])
                part, off = hyper[off:off + n], off + n
            grads, s = t.update(grads, s, params, hyper=part)
            new_state.append(s)
        return grads, tuple(new_state)

    capturable = all(t.hyper is not None for t in transforms)
    return GradientTransformation(init, update,
                                  next_floats if capturable else None)


def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> None:
    """params += updates, in place."""
    with torch.no_grad():
        torch._foreach_add_(list(params), list(updates))
