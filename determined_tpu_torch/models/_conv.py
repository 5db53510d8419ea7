"""What the convolutional models (mnist.py, resnet.py, diffusion.py) share.

The JAX models compute in NHWC with HWIO kernels and XLA's "SAME"
padding. The port keeps the JAX interfaces (images in and outputs out are
NHWC) and computes in PyTorch's NCHW with OIHW kernels: an NHWC tensor
permuted to NCHW is a view with channels_last strides, the layout cuDNN's
fast convolutions take on the card, so nothing is copied at the boundary.

  - `conv2d_same`: XLA's SAME padding, which is asymmetric where the
    padding total is odd (a 3x3 stride-2 conv on an even size pads (0, 1);
    the 7x7 stride-2 stem at 224 pads (2, 3)): an explicit `F.pad` there,
    the convolution's own padding where both sides are equal.
  - `max_pool_same`: a SAME max-pool, padded with -inf.
  - `to_oihw` / `to_hwio`, `oihw_axes`, `tree_from_numpy` /
    `tree_to_numpy`: a JAX param tree (numpy arrays, HWIO kernels, lists)
    to the port's (tensors, OIHW kernels, dicts keyed by the list index,
    which `TrainState` flattens) and back; a tuple of logical axes names
    the dims of the JAX leaf, so it is permuted with the leaf.
  - `mesh_groups`: the groups a model computes over on the mesh its
    leaves lie on: the batch axes (`data`, `fsdp`), over which BatchNorm
    sums its statistics, and `tensor`, over which the leaves the JAX
    model names "mlp" or "heads" are split (the default rules map both
    to `tensor`). `context` is accepted and computes replicated: the JAX
    rules map only "seq" to it, and no conv model names "seq", so the
    ranks of a context group hold the same rows and compute the same
    values. `expert` is refused, as the JAX Trainer refuses it for a
    model that does not route.
  - `copy_to` (Megatron's f before a part of a layer split over
    `tensor`) and `gather_channels` (an NCHW activation split by channels
    over `tensor` made whole: `collectives.gather_from` on its NHWC view,
    so a channels_last tensor stays one); each is the identity without a
    `tensor` group, so one process can run every rank's part of a layer.
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from determined_tpu_torch.parallel import collectives, sharding
from determined_tpu_torch.parallel.mesh import AxisGroup, axis_group


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                bias: torch.Tensor = None) -> torch.Tensor:
    """x [B, C, H, W] * w [O, C, kh, kw] with SAME padding."""
    (hl, hh), (wl, wh) = (same_padding(x.shape[2], w.shape[2], stride),
                          same_padding(x.shape[3], w.shape[3], stride))
    if hl == hh and wl == wh:
        return F.conv2d(x, w, bias, stride, (hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, bias, stride)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """A k x k max-pool with SAME padding (XLA's `reduce_window` with -inf
    as the init value)."""
    (hl, hh), (wl, wh) = (same_padding(x.shape[2], k, stride),
                          same_padding(x.shape[3], k, stride))
    x = F.pad(x, (wl, wh, hl, hh), value=-math.inf)
    return F.max_pool2d(x, k, stride)


def wide(t: torch.Tensor) -> torch.Tensor:
    """`t` in the JAX models' fp32 accumulation dtype: fp32, or float64
    for a float64 tensor (the models then run wholly in float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def nchw(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC images as an NCHW view (channels_last strides) in `dtype`."""
    return images.to(dtype).permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def he_normal(shape: Sequence[int], fan_in: int, gen: torch.Generator,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`jax.nn.initializers.he_normal()`: a normal truncated at 2 standard
    deviations, scaled to variance 2 / fan_in, drawn from `gen`."""
    std = math.sqrt(2.0 / fan_in) / .87962566103423978
    t = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                       generator=gen)


# ------------------------------------------------- layouts across packages


def to_oihw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))


def to_hwio(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))


def oihw_axes(axes: tuple) -> tuple:
    """The logical axes of an HWIO leaf, permuted as the leaf is."""
    return (axes[3], axes[2], axes[0], axes[1])


def tree_from_numpy(tree: Any, device=None) -> Any:
    """A JAX param (or batch-stats) tree of numpy arrays as the port's:
    tensors on `device`, 4-D kernels OIHW, lists as dicts keyed "0", "1",
    ..."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): tree_from_numpy(v, device) for i, v in enumerate(tree)}
    a = np.asarray(tree)
    if a.ndim == 4:
        a = to_oihw(a)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_to_numpy(tree: Any) -> Any:
    """`tree_from_numpy`'s inverse: the JAX package's layout."""
    if isinstance(tree, dict):
        if tree and all(k.isdigit() for k in tree):
            return [tree_to_numpy(tree[str(i)]) for i in range(len(tree))]
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    a = tree.detach().cpu().numpy()
    return to_hwio(a) if a.ndim == 4 else a


def axes_from_jax(axes: Any) -> Any:
    """A JAX tree of logical-axis tuples in the port's layout."""
    if isinstance(axes, dict):
        return {k: axes_from_jax(v) for k, v in axes.items()}
    if isinstance(axes, list):
        return {str(i): axes_from_jax(v) for i, v in enumerate(axes)}
    return oihw_axes(axes) if len(axes) == 4 else axes


# ------------------------------------------------------------- the mesh


class Groups(NamedTuple):
    """What a conv model computes over: the process groups of the batch
    axes above 1, and the `tensor` axis (None when it is 1 or there is no
    mesh)."""
    batch: List[Any]
    tensor: Optional[AxisGroup]


def mesh_groups(leaf: torch.Tensor, model: str) -> Groups:
    """The groups of the mesh `leaf` lies on (module docstring); no groups
    for a plain tensor. Raises for `expert` above 1: these models route
    nothing over it."""
    mesh = sharding.mesh_of(leaf)
    if mesh is None:
        return Groups([], None)
    expert = axis_group(mesh, "expert")
    if expert is not None:
        raise ValueError(
            f"the {model} model routes nothing over the expert mesh axis; "
            f"the mesh asks for expert={expert.size}")
    return Groups([g.group for g in (axis_group(mesh, "data"),
                                     axis_group(mesh, "fsdp"))
                   if g is not None], axis_group(mesh, "tensor"))


def copy_to(x: torch.Tensor, tensor: Optional[AxisGroup]) -> torch.Tensor:
    """Megatron's f (`collectives.copy_to`): `x`, whole on every rank of
    `tensor`, enters a part of a layer split over it; `x` itself without
    a group."""
    return x if tensor is None else collectives.copy_to(x, tensor.group)


def gather_channels(x: torch.Tensor, tensor: Optional[AxisGroup]
                    ) -> torch.Tensor:
    """x [B, C/t, H, W], this rank's channels, -> [B, C, H, W]: the
    group's slices side by side in rank order; the backward keeps this
    rank's slice of the gradient (`collectives.gather_from`). `x` itself
    without a group."""
    if tensor is None:
        return x
    return collectives.gather_from(nhwc(x), tensor.group, 3).permute(
        0, 3, 1, 2)
