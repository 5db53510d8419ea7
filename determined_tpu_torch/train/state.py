"""Train state on one device.

Counterpart of determined_tpu/train/state.py without meshes: one object
carrying step, params, opt_state and the non-gradient `extra`. The JAX
package donates the state to its jitted step so XLA reuses the buffers;
here the step updates the parameters and the optimizer's moment buffers in
place (`apply_gradients`), which keeps one copy of each on the device the
same way. `step` and the optimizer counts are host integers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch

from determined_tpu_torch.models.gpt2 import _flatten
from determined_tpu_torch.train import optim


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any
    # Non-gradient mutable collections (e.g. BatchNorm running stats). None
    # for purely functional models.
    extra: Any = None

    def leaves(self) -> List[torch.Tensor]:
        """The param leaves in a fixed order (the `/`-joined key paths of a
        nested dict, or the tensor itself): what the optimizer state
        mirrors."""
        return param_leaves(self.params)

    def apply_gradients(self, grads: List[torch.Tensor],
                        tx: optim.GradientTransformation,
                        new_extra: Any = None) -> "TrainState":
        """One optimizer update, in place: `grads` (ordered as `leaves()`)
        become the updates and are added into the params."""
        with torch.no_grad():
            params = self.leaves()
            updates, self.opt_state = tx.update(list(grads), self.opt_state,
                                                params)
            optim.apply_updates(params, updates)
        self.step += 1
        if new_extra is not None:
            self.extra = new_extra
        return self


def param_leaves(params: Any) -> List[torch.Tensor]:
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return list(_flatten(params).values())
    return [p for p in params]


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree if tree.device == device else tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def create_train_state(
    init_fn: Callable[[torch.Generator], Any],
    tx: optim.GradientTransformation,
    generator: torch.Generator,
    device: Optional[torch.device] = None,
    extra: Any = None,
) -> TrainState:
    """Initialise a TrainState on `device`: the params from `init_fn`
    (moved there when it made them elsewhere), marked to take gradients,
    and the optimizer state built over them."""
    params = init_fn(generator)
    if device is not None:
        params = _to_device(params, torch.device(device))
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return TrainState(step=0, params=params, opt_state=tx.init(leaves),
                      extra=extra)
