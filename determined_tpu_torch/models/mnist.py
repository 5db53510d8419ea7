"""The MNIST CNN in PyTorch: determined_tpu/models/mnist.py's function.

Two 3x3 SAME convolutions with ReLU, each followed by a 2x2 VALID
max-pool, then two dense layers. Images come in NHWC as in the JAX
model; the convolutions run in NCHW on OIHW kernels (models/_conv.py).
`fc1`'s rows run (h, w, c), as the JAX model flattens NHWC, so the
activation is flattened in that order: an NCHW flatten would permute
them.

Over a `tensor` axis (`fc1` over ("embed", "mlp"), `fc2` over ("mlp",
None), as in the JAX model) the dense pair is Megatron's MLP: each rank
computes its columns of `fc1` (its slice of the hidden units) and its
rows of `fc2`, the f/g pair (`parallel/collectives`) stands at the
pair's start and end, and `fc2`'s bias is added once, after the sum. The
convolutions are replicated there, as in the JAX model, and so are the
logits and the loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from determined_tpu_torch.models import _conv
from determined_tpu_torch.models.gpt2 import map_params
from determined_tpu_torch.parallel import collectives, sharding


@dataclasses.dataclass(frozen=True)
class Config:
    n_classes: int = 10
    c1: int = 32
    c2: int = 64
    hidden: int = 128
    dtype: Any = torch.float32


def init(gen: torch.Generator, cfg: Config = Config()) -> Dict[str, Any]:
    """He-normal kernels (OIHW for the convolutions) and zero biases, on
    `gen`'s device."""
    dev, dt = gen.device, cfg.dtype

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=dev)

    return {
        "conv1": {"kernel": _conv.he_normal((cfg.c1, 1, 3, 3), 9, gen, dt),
                  "bias": zeros(cfg.c1)},
        "conv2": {"kernel": _conv.he_normal((cfg.c2, cfg.c1, 3, 3),
                                            9 * cfg.c1, gen, dt),
                  "bias": zeros(cfg.c2)},
        "fc1": {"kernel": _conv.he_normal((7 * 7 * cfg.c2, cfg.hidden),
                                          7 * 7 * cfg.c2, gen, dt),
                "bias": zeros(cfg.hidden)},
        "fc2": {"kernel": _conv.he_normal((cfg.hidden, cfg.n_classes),
                                          cfg.hidden, gen, dt),
                "bias": zeros(cfg.n_classes)},
    }


def param_logical_axes(cfg: Config = Config()) -> Dict[str, Any]:
    return {
        "conv1": {"kernel": (None, None, None, None), "bias": (None,)},
        "conv2": {"kernel": (None, None, None, None), "bias": (None,)},
        "fc1": {"kernel": ("embed", "mlp"), "bias": ("mlp",)},
        "fc2": {"kernel": ("mlp", None), "bias": (None,)},
    }


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX params (numpy arrays, HWIO kernels) as the port's."""
    return _conv.tree_from_numpy(tree, device)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params in the JAX layout, as numpy arrays."""
    return _conv.tree_to_numpy(params)


def apply(params: Dict[str, Any], images: torch.Tensor,
          cfg: Config = Config()) -> torch.Tensor:
    """images: [B, 28, 28, 1] -> logits [B, n_classes]."""
    tensor = _conv.mesh_groups(params["fc1"]["kernel"], "MNIST").tensor
    p = map_params(lambda t: sharding.gather_for_use(t, keep=("tensor",)),
                   params)
    x = _conv.nchw(images, cfg.dtype)
    x = F.relu(_conv.conv2d_same(x, p["conv1"]["kernel"],
                                 bias=p["conv1"]["bias"]))
    x = F.max_pool2d(x, 2, 2)
    x = F.relu(_conv.conv2d_same(x, p["conv2"]["kernel"],
                                 bias=p["conv2"]["bias"]))
    x = F.max_pool2d(x, 2, 2)
    x = _fc_part(_conv.nhwc(x).reshape(x.shape[0], -1), p, tensor)
    if tensor is not None:
        x = collectives.reduce_from(x, tensor.group)
    return x + p["fc2"]["bias"]


def _fc_part(x, p, tensor=None):
    """The dense pair over the hidden units that `p` (the rank's pieces)
    holds, fc2's bias left out: x [B, F] whole. The sum of the ranks'
    parts plus the bias is the pair; with `tensor=None` one process runs
    any rank's part (chip_smoke.py's phase 18a)."""
    x = _conv.copy_to(x, tensor)
    return F.relu(x @ p["fc1"]["kernel"] + p["fc1"]["bias"]) @ \
        p["fc2"]["kernel"]


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: Config = Config()):
    """-> (mean cross-entropy, {"accuracy"})."""
    logits = apply(params, batch["images"], cfg)
    labels = batch["labels"].long()
    logp = torch.log_softmax(_conv.wide(logits), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll.mean(), {"accuracy": acc}
