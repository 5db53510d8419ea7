"""GPT-2 in PyTorch: parameters, the training forward and the loss.

Counterpart of determined_tpu/models/gpt2.py: the same `Config` fields and
presets, `init` with the same shapes and standard deviations,
`param_count`, `flops_per_token`, the fp32 `_layer_norm`, the token
embedding, and the dense training forward (`_block`, `apply`, `loss_fn`)
with its rematerialisation (`_remat`). The serving slice (serve/model.py)
reuses the embedding and the layer norm. Parameters are a nested dict of
tensors in the JAX package's layout, so a JAX param tree carries over
unchanged (`params_from_numpy`):

  - transformer blocks stacked along a leading `[L, ...]` layers dim;
  - weight matrices stored `(in, out)`, so the forward computes `x @ W`;
  - the LM head tied to `wte`.

Mixed precision as in the JAX package: fp32 parameters, each weight cast
to `cfg.dtype` right before its product (so the fp32 parameters get fp32
gradients), activations in `cfg.dtype`, the layer norms and the loss's
logsumexp in fp32. Attention goes through ops/flash_attention.py by
`cfg.attention_impl`, or, for "ring" and "ulysses", through
ops/ring_attention.py and ops/ulysses.py. With `num_experts > 1` every
block's FFN is the routed MoE FFN of ops/moe.py (its params under
`blocks/moe`), and the loss adds `moe_aux_coef` times the layers' mean
load-balance loss. `apply_pipelined` and `loss_fn_pipelined` run the
blocks as GPipe stages over the `pipeline` mesh axis
(parallel/pipeline.py) for a dense config.

Over a mesh (the params DTensors, train/state.py) two axes split the
work of one row as the JAX package's GSPMD layout does:

  - `tensor`, Megatron's layout. The qkv and `mlp_up` products are split
    by columns (each rank its heads, kept head-aligned by the state's
    tensor layout of the fused qkv dim, `sharding.Fused`, and its slice of
    the FFN), `attn_out` and `mlp_down` by rows; the f/g pair
    (`parallel/collectives`) stands at each split's start and end, and a
    row-split product's bias is added once, after the all-reduce. The
    tied table is split by vocab rows (50,257 rows split unevenly): the
    embedding is a lookup of the rank's rows, masked, summed over the
    group (the value of JAX's one-hot product), and the LM head gives
    each rank its vocab slice of the logits, whose loss takes the global
    max and sum of exponentials and the target's logit from the rank
    that holds it.
  - `context`: `loss_fn` shifts the tokens first, as JAX's `_shift`, and
    each rank keeps its contiguous chunk of inputs and targets
    (`parallel/mesh.seq_shard`), its positions' rows of `wpe`; attention
    runs over the ring or Ulysses, and the loss is the mean over the
    group's chunks (`collectives.sum_over`, so each rank's gradient is its
    own chunk's, which `sharding.gather_for_use` averages over the axis as
    over data). `apply` takes the whole sequence and gives the whole
    logits.

An MoE model takes both axes too (ops/moe.py): its routing's slot order
is the global token order, so a context rank's count prefix runs over
the context group as over the batch group, and each expert's FFN is
split over `tensor` as the dense FFN is.

Over `pipeline` (`apply_pipelined`, `loss_fn_pipelined`, the JAX
package's functions) every stage embeds its rows, stage s runs layers
[s L/S, (s+1) L/S) of each microbatch (the blocks' "layers" dim is
sharded over the axis; `_block` keeps its tensor and fsdp work inside a
stage), and the last stage runs `ln_f`, the tied head and the loss,
whose value `pipeline.from_last` gives every stage. The replicated
leaves (`wte`, `wpe`, `ln_f`) are used for real on the first stage (the
embedding) and the last (the head), with zero gradients elsewhere, and
their gradients are summed over the axis: `wte`'s is the head's plus
the embedding's, as `jax.grad` of the JAX function gives it. Activations
are in `cfg.dtype` throughout (the JAX function computes in fp32 on its
CPU backend only, to dodge an XLA crash there).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from determined_tpu_torch.ops import moe
from determined_tpu_torch.ops.flash_attention import flash_attention
from determined_tpu_torch.ops.ring_attention import ring_attention
from determined_tpu_torch.ops.ulysses import ulysses_attention
from determined_tpu_torch.parallel import collectives, pipeline, sharding
from determined_tpu_torch.parallel.mesh import AxisGroup, axis_group, chunk

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    d_ff: int = 0  # 0 -> 4*d_model
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16  # activation dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    remat_policy: Optional[str] = "dots"
    attention_impl: str = "flash"
    attention_bf16: bool = False
    overlap_allgather: bool = False
    layer_norm_eps: float = 1e-5
    scan_unroll: int = 1
    # Mixture-of-Experts: >1 replaces every block's MLP with a top-k routed
    # MoE FFN whose experts shard over the mesh `expert` axis (ops/moe.py).
    num_experts: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_head:
            raise ValueError(
                f"d_model {self.d_model} is not divisible by n_head "
                f"{self.n_head}")
        return self.d_model // self.n_head

    @staticmethod
    def small() -> "Config":
        return Config()  # gpt2-124M

    @staticmethod
    def medium() -> "Config":
        return Config(d_model=1024, n_layer=24, n_head=16)

    @staticmethod
    def large() -> "Config":
        return Config(d_model=1280, n_layer=36, n_head=20)

    @staticmethod
    def tiny() -> "Config":
        """Test-sized config."""
        return Config(
            vocab_size=512, n_positions=128, d_model=64, n_layer=2, n_head=4
        )


def param_count(cfg: Config) -> int:
    d, f, v, p, L = cfg.d_model, cfg.ff_dim, cfg.vocab_size, cfg.n_positions, cfg.n_layer
    per_layer = (
        3 * d * d + 3 * d  # qkv
        + d * d + d  # attn out
        + d * f + f  # mlp up
        + f * d + d  # mlp down
        + 4 * d  # 2 layernorms
    )
    return v * d + p * d + L * per_layer + 2 * d  # + final ln


def flops_per_token(cfg: Config, seq_len: int) -> float:
    """Approx fwd+bwd FLOPs per token (6N + attention term) for MFU math."""
    n_params = param_count(cfg)
    attn = 12 * cfg.n_layer * cfg.d_model * seq_len  # 2*2*3 * L * d * s
    return 6.0 * n_params + attn


# ---------------------------------------------------------------- init


def init(generator: torch.Generator, cfg: Config,
         device: Optional[torch.device] = None) -> Params:
    """Random GPT-2 parameters from `generator`: N(0, 0.02), residual
    projections scaled by 1/sqrt(2L), biases 0 and LayerNorm scales 1 —
    the shapes and deviations of the JAX `init`. The draws differ from
    `jax.random`'s; the tests carry JAX params over with
    `params_from_numpy` instead. With `num_experts > 1` the blocks hold
    `moe` (`ops/moe.init_moe`, stacked over the layers) in place of
    `mlp_up` and `mlp_down`."""
    d, f, v, p, L = cfg.d_model, cfg.ff_dim, cfg.vocab_size, cfg.n_positions, cfg.n_layer
    pd = cfg.param_dtype
    device = device if device is not None else generator.device
    std, res_std = 0.02, 0.02 / math.sqrt(2 * L)

    def normal(shape, s):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * s).to(pd)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=device)

    wte, wpe = normal((v, d), std), normal((p, d), std)
    blocks = {
        "ln1": {"scale": ones((L, d)), "bias": zeros((L, d))},
        "qkv": {"kernel": normal((L, d, 3 * d), std),
                "bias": zeros((L, 3 * d))},
        "attn_out": {"kernel": normal((L, d, d), res_std),
                     "bias": zeros((L, d))},
        "ln2": {"scale": ones((L, d)), "bias": zeros((L, d))},
    }
    if cfg.num_experts > 1:
        blocks["moe"] = moe.init_moe(generator, d, f, cfg.num_experts,
                                     param_dtype=pd, std=std, layers=L,
                                     device=device)
    else:
        blocks["mlp_up"] = {"kernel": normal((L, d, f), std),
                            "bias": zeros((L, f))}
        blocks["mlp_down"] = {"kernel": normal((L, f, d), res_std),
                              "bias": zeros((L, d))}
    return {
        "wte": wte,
        "wpe": wpe,
        "blocks": blocks,
        "ln_f": {"scale": ones((d,)), "bias": zeros((d,))},
    }


def param_logical_axes(cfg: Config) -> Dict[str, Any]:
    """Logical axis names per param dim (the JAX package's); the leading
    "layers" dim of the stacked blocks maps to the `pipeline` mesh axis
    (replicated when pipeline=1); an MoE block's expert dim maps to the
    `expert` axis. The qkv leaves' "heads" dim is `Fused` (q, k and v side
    by side): the same name, and the state keeps it head-aligned when the
    axis splits it (parallel/sharding.py)."""
    L = "layers"
    heads = sharding.Fused("heads", 3)
    blocks: Dict[str, Any] = {
        "ln1": {"scale": (L, "embed"), "bias": (L, "embed")},
        "qkv": {"kernel": (L, "embed", heads), "bias": (L, heads)},
        "attn_out": {"kernel": (L, "heads", "embed"), "bias": (L, "embed")},
        "ln2": {"scale": (L, "embed"), "bias": (L, "embed")},
    }
    if cfg.num_experts > 1:
        blocks["moe"] = moe.moe_logical_axes(layers=True)
    else:
        blocks["mlp_up"] = {"kernel": (L, "embed", "mlp"), "bias": (L, "mlp")}
        blocks["mlp_down"] = {"kernel": (L, "mlp", "embed"),
                              "bias": (L, "embed")}
    return {
        # Split by vocab rows, 50,257 of them: unequal pieces by design.
        "wte": (sharding.Uneven("vocab"), "embed"),
        "wpe": (None, "embed"),
        "blocks": blocks,
        "ln_f": {"scale": ("embed",), "bias": ("embed",)},
    }


# ----------------------------------------------------- param trees <-> files


def _flatten(tree: Params, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            flat.update(_flatten(val, path))
        else:
            flat[path] = val
    return flat


def _unflatten(flat: Dict[str, Any]) -> Params:
    tree: Params = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def map_params(fn, tree: Params) -> Params:
    """Apply `fn` to every leaf of a nested param dict."""
    return {k: map_params(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def params_from_numpy(tree: Params, device=None) -> Params:
    """A param tree of numpy arrays (e.g. a JAX tree through np.asarray)
    as torch tensors on `device`, with the same structure, layout and
    dtypes."""
    return map_params(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(tree: Params) -> Params:
    return map_params(lambda t: t.detach().cpu().numpy(), tree)


def save_params_npz(path: str, params: Params) -> None:
    """Write a param tree to `.npz`, one array per `/`-joined key path."""
    np.savez(path, **_flatten(params_to_numpy(params)))


def load_params_npz(path: str) -> Params:
    """Read a `save_params_npz` file back into a tree of numpy arrays."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


# ---------------------------------------------------------------- forward


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm in fp32 with the population variance, cast back to x's
    dtype. `scale` and `bias` are used in their own (fp32) dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _vocab_start(cfg: Config, tensor: AxisGroup) -> int:
    """The first vocab row of this tensor rank's slice of `wte` (DTensor
    splits a dim as `torch.chunk`: ceil(V / tp) rows a rank, fewer on the
    last)."""
    return min(tensor.index * -(-cfg.vocab_size // tensor.size),
               cfg.vocab_size)


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: Config,
                  dtype: torch.dtype,
                  tensor: Optional[AxisGroup] = None) -> torch.Tensor:
    """Token embedding: the gather `wte[tokens]` in `dtype`. Over a
    `tensor` axis, `params["wte"]` is this rank's vocab rows: each rank
    looks up the tokens it holds, zeros for the others, and the sum over
    the group is the embedding (JAX's one-hot product's value)."""
    wte = params["wte"].to(dtype)
    if tensor is None:
        return wte[tokens.long()]
    n = wte.shape[0]
    local = tokens.long() - _vocab_start(cfg, tensor)
    mine = (local >= 0) & (local < n)
    x = wte[torch.where(mine, local, 0)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=dtype,
                                                     device=x.device))
    return collectives.reduce_from(x, tensor.group)


class _Axes(NamedTuple):
    """The mesh axes above 1 that split a row's work (None: not split)."""
    mesh: Any
    tensor: Optional[AxisGroup]
    context: Optional[AxisGroup]


def _axes(params: Params, cfg: Config) -> _Axes:
    mesh = sharding.mesh_of(params["wte"])
    return _Axes(mesh, axis_group(mesh, "tensor"),
                 axis_group(mesh, "context"))


def _attention(q, k, v, cfg: Config, axes: Optional[_Axes]
               ) -> torch.Tensor:
    """q, k, v: [B, S, H, Dh], this rank's chunk and heads. Causal
    self-attention by `cfg.attention_impl`."""
    mesh = axes.mesh if axes is not None else None
    if cfg.attention_impl == "ring":
        return ring_attention(q, k, v, mesh=mesh)
    if cfg.attention_impl == "ulysses":
        return ulysses_attention(q, k, v, causal=True, mesh=mesh,
                                 n_head=cfg.n_head)
    if axes is not None and axes.context is not None:
        raise ValueError(
            f"attention_impl {cfg.attention_impl!r} over a context axis "
            "above 1: a rank holds one chunk of the sequence; use "
            "attention_impl ring or ulysses")
    return flash_attention(q, k, v, causal=True, impl=cfg.attention_impl,
                           bf16=cfg.attention_bf16)


def _block(x: torch.Tensor, lp: Params, cfg: Config,
           axes: Optional[_Axes] = None):
    """One transformer block -> (x, the MoE load-balance loss, or None for
    a dense FFN). x: [B, S, D]; lp: this layer's param slice (over a
    `tensor` axis the rank's heads and FFN slice); `axes`: the mesh of
    sharded params and its splitting axes (ops/moe.py routes over the
    mesh)."""
    b, s, d = x.shape
    dh = cfg.head_dim
    dt = cfg.dtype
    mesh = axes.mesh if axes is not None else None
    tensor = axes.tensor if axes is not None else None

    def split_in(t):  # Megatron's f before a column-split product
        return t if tensor is None else collectives.copy_to(t, tensor.group)

    def split_out(t):  # its g after a row-split one
        return t if tensor is None else \
            collectives.reduce_from(t, tensor.group)

    y = split_in(_layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                             cfg.layer_norm_eps))
    qkv = y @ lp["qkv"]["kernel"].to(dt) + lp["qkv"]["bias"].to(dt)
    # Per-head views of the fused product: the kernels read them in place.
    h = qkv.shape[-1] // (3 * dh)  # the heads this rank holds
    q, k, v = (t.view(b, s, h, dh) for t in qkv.split(h * dh, dim=-1))
    attn = _attention(q, k, v, cfg, axes).reshape(b, s, h * dh)
    attn = split_out(attn @ lp["attn_out"]["kernel"].to(dt)) + \
        lp["attn_out"]["bias"].to(dt)
    x = x + attn

    y = _layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                    cfg.layer_norm_eps)
    if cfg.num_experts > 1:
        down, aux = moe.moe_block(
            y, lp["moe"], cfg.num_experts, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, mesh=mesh)
        return x + down, aux
    up = split_in(y) @ lp["mlp_up"]["kernel"].to(dt) + \
        lp["mlp_up"]["bias"].to(dt)
    up = F.gelu(up, approximate="tanh")
    down = split_out(up @ lp["mlp_down"]["kernel"].to(dt)) + \
        lp["mlp_down"]["bias"].to(dt)
    return x + down, None


# What each remat policy saves, as aten ops reach the selective checkpoint
# (the JAX package's `jax.checkpoint_policies` of the same names):
#
#   None, "nothing"  nothing: the whole block runs again in the backward
#                    (`nothing_saveable`; JAX's bare `jax.checkpoint`).
#   "dots"           the products without batch dims: the projections
#                    reach autograd as 2-D `mm`/`addmm` (`x @ W` folds
#                    [B, S] into rows), and their outputs are kept
#                    (`dots_with_no_batch_dims_saveable`).
#   "dots_saveable"  every product: also `bmm`/`baddbmm`, the batched
#                    products (the reference attention's QK^T and PV)
#                    (`dots_saveable`).
#   "everything"     everything: the block is not checkpointed at all
#                    (`everything_saveable`), so nothing runs again.
#
# The flash kernels' `autograd.Function` is not a product in either
# package (a `pallas_call` there, ctypes launches here): under every
# policy but "everything" its forward runs again in the recompute, so a
# step launches the forward kernel twice a layer. The RNG state is not
# stashed for the recompute (`preserve_rng_state=False`): the block draws
# nothing, and stashing reads the CUDA generator, which a step captured as
# a CUDA graph (train/step.make_multi_step) must not do.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_SAVED_BATCHED_DOTS = _SAVED_DOTS + (torch.ops.aten.bmm.default,
                                     torch.ops.aten.baddbmm.default)
REMAT_POLICIES = (None, "nothing", "dots", "dots_saveable", "everything")


def _saving(ops):
    def policy(ctx, op, *args, **kwargs):
        if op in ops:
            return torch_checkpoint.CheckpointPolicy.MUST_SAVE
        return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE

    return policy


_dots_policy = _saving(_SAVED_DOTS)
_dots_saveable_policy = _saving(_SAVED_BATCHED_DOTS)


def _remat(block, cfg: Config):
    """Wrap a block fn in activation checkpointing per cfg.remat_policy
    (REMAT_POLICIES; what each saves is listed above)."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"remat_policy {cfg.remat_policy!r} not in {REMAT_POLICIES}")
    if cfg.remat_policy == "everything":
        return block
    kwargs: Dict[str, Any] = {"use_reentrant": False,
                              "preserve_rng_state": False}
    policy = {"dots": _dots_policy,
              "dots_saveable": _dots_saveable_policy}.get(cfg.remat_policy)
    if policy is not None:
        kwargs["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, policy)

    def wrapped(x, lp):
        return torch_checkpoint.checkpoint(block, x, lp, **kwargs)

    return wrapped


def _unstack_layers(blocks: Params, n_layer: int):
    """The stacked `[L, ...]` block params as L per-layer dicts of views.
    One unbind per leaf, so each leaf's backward stacks its L gradients
    once instead of adding L full-size zero-padded slices. A sharded leaf
    (a DTensor split along dim 1, the "embed" dim under fsdp) unbinds
    into per-layer DTensors split along their dim 0, each gathered just
    before its block runs (`apply`)."""
    parts = {k: v.unbind(0) for k, v in _flatten(blocks).items()}
    return [_unflatten({k: p[i] for k, p in parts.items()})
            for i in range(n_layer)]


def _gather_layer(lp: Params, async_op: bool = False) -> Params:
    """One layer's params for use (`sharding.gather_for_use`): a leaf split
    over the `tensor` axis keeps its split; an MoE layer's experts stay
    split over the `expert` axis. `async_op`: the gathers are issued and
    waited for at first use."""
    out = {k: map_params(functools.partial(_gather, async_op=async_op), v)
           for k, v in lp.items() if k != "moe"}
    if "moe" in lp:
        out["moe"] = moe.gather_params(lp["moe"], async_op=async_op)
    return out


def _gather(p, async_op: bool = False):
    return sharding.gather_for_use(p, keep=("tensor",), async_op=async_op)


def _trunk(params: Params, tokens: torch.Tensor, cfg: Config,
           axes: _Axes, start: int = 0):
    """tokens [B, s] at positions start.. -> (the final layer norm's
    output [B, s, D] in cfg.dtype, the tied table as this rank holds it,
    the layers' MoE losses)."""
    # Sharded params (DTensors, train/state.py) are gathered just before
    # use; plain tensors pass through.
    x, wte = _embed(params, tokens, cfg, axes, start, _gather)
    block = functools.partial(_block, cfg=cfg, axes=axes)
    if cfg.remat and torch.is_grad_enabled():
        block = _remat(block, cfg)
    # `overlap_allgather`: layer i+1's gather is issued before block i runs,
    # as the JAX model's `_scan_overlap` does. The gathers are async and
    # wait at their first use, so the next layer's is in flight while this
    # one computes; at most two layers are gathered at once, and the
    # arithmetic is the plain loop's. The gathers stay outside the remat'd
    # block. Plain tensors (fsdp 1) pass through either way.
    layers = _unstack_layers(params["blocks"], cfg.n_layer)
    ahead = 1 if cfg.overlap_allgather else 0
    gathered = [_gather_layer(lp, async_op=True) for lp in layers[:ahead]]
    auxs = []
    for i in range(len(layers)):
        if i + ahead < len(layers):  # det: noqa[DTL104]: n_layer, fixed
            gathered.append(_gather_layer(layers[i + ahead],
                                          async_op=bool(ahead)))
        x, aux = block(x, gathered.pop(0))
        auxs.append(aux)
    ln_f = map_params(_gather, params["ln_f"])
    x = _layer_norm(x, ln_f["scale"], ln_f["bias"], cfg.layer_norm_eps)
    return x, wte, auxs


def _embed(params: Params, tokens: torch.Tensor, cfg: Config, axes: _Axes,
           start: int, gather):
    """tokens [B, s] at positions start.. -> (the embedding [B, s, D] in
    cfg.dtype, the tied table as this rank holds it). `gather` makes a
    leaf ready for use; the tied `wte` is gathered once, so its two uses'
    gradients sum before the one reduce-scatter."""
    wte = gather(params["wte"])
    x = _embed_tokens({"wte": wte}, tokens, cfg, cfg.dtype, axes.tensor)
    pos = gather(params["wpe"]).to(cfg.dtype)
    return x + pos[start:start + tokens.shape[1]][None], wte


def _head(x: torch.Tensor, wte: torch.Tensor, cfg: Config,
          tensor: Optional[AxisGroup]) -> torch.Tensor:
    """The tied LM head: logits [B, s, V] (over a `tensor` axis this
    rank's vocab slice) in cfg.dtype."""
    if tensor is not None:
        x = collectives.copy_to(x, tensor.group)
    return x @ wte.to(cfg.dtype).t()


def _all_gather(t: torch.Tensor, axis: AxisGroup, dim: int,
                size: Optional[int] = None) -> torch.Tensor:
    """Every rank's `t` of the group concatenated along `dim`, in rank
    order, differentiable; pieces shorter than the first (an uneven
    split) padded for the exchange and trimmed to `size`."""
    from torch.distributed import _functional_collectives as fc

    n = -(-size // axis.size) if size is not None else t.shape[dim]
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, n - t.shape[dim]]
    # Renamed after torch 2.11 (the older name warns from 2.13).
    gather = getattr(fc, "all_gather_single_autograd", None) or \
        fc.all_gather_tensor_autograd
    out = fc.wait_tensor(gather(F.pad(t, pad).contiguous(), dim,
                                axis.group))
    return out if size is None else out.narrow(dim, 0, size)


def _chunk_logits(params: Params, inputs: torch.Tensor, cfg: Config):
    """inputs [B, S] -> (the axes, this rank's (start, stop) of the
    sequence, its logits [B, stop - start, V] in cfg.dtype (over a
    `tensor` axis its vocab slice), the layers' MoE losses). Over a
    context axis the rank runs its chunk of the positions."""
    axes = _axes(params, cfg)
    start, stop = 0, inputs.shape[1]
    if axes.context is not None:
        start, stop = chunk(inputs.shape[1], axes.context.index,
                            axes.context.size)
    x, wte, auxs = _trunk(params, inputs[:, start:stop], cfg, axes, start)
    return axes, (start, stop), _head(x, wte, cfg, axes.tensor), auxs


def apply(params: Params, tokens: torch.Tensor, cfg: Config,
          return_aux: bool = False):
    """Forward pass: tokens [B, S] -> logits [B, S, vocab] in cfg.dtype;
    with `return_aux` also the mean MoE load-balance loss over the layers
    (fp32; 0 for a dense config). Over a mesh, every rank of a context
    and tensor group passes the same tokens and gets the same logits:
    each computes its chunk and vocab slice, and the pieces are
    gathered."""
    axes, _, logits, auxs = _chunk_logits(params, tokens, cfg)
    logits = _whole_logits(logits, axes, cfg)
    if not return_aux:
        return logits
    if cfg.num_experts > 1:
        return logits, torch.stack(auxs).mean()
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def _whole_logits(logits: torch.Tensor, axes: _Axes, cfg: Config
                  ) -> torch.Tensor:
    """A rank's logits (its chunk of the sequence, its vocab slice) ->
    the whole [B, S, V], gathered over the context and tensor groups."""
    if axes.tensor is not None:
        logits = _all_gather(logits, axes.tensor, 2, cfg.vocab_size)
    if axes.context is not None:
        logits = _all_gather(logits, axes.context, 1)
    return logits


def _shift(batch: Dict[str, torch.Tensor]):
    tokens = batch["tokens"]
    if "targets" in batch:
        return tokens, batch["targets"]
    return tokens[:, :-1], tokens[:, 1:]


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL as logsumexp(logits) - logits[target], in fp32."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - tgt.float())


def _nll_vocab_split(logits: torch.Tensor, targets: torch.Tensor,
                     cfg: Config, tensor: AxisGroup) -> torch.Tensor:
    """`_nll` from this rank's vocab slice of the logits: the global max
    (no gradient: the logsumexp does not depend on it), the sum of
    exponentials and the target's logit from the rank that holds it, each
    summed over the group with Megatron's g, so every rank's slice gets
    its own gradient."""
    lf = logits.float()
    m = collectives.max_over(lf.amax(dim=-1), tensor.group)
    sumexp = collectives.reduce_from(
        torch.exp(lf - m[..., None]).sum(dim=-1), tensor.group)
    lse = m + torch.log(sumexp)
    n = logits.shape[-1]
    local = targets.long() - _vocab_start(cfg, tensor)
    mine = (local >= 0) & (local < n)
    tgt = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    tgt = torch.where(mine, tgt[..., 0].float(), 0.0)
    return torch.mean(lse - collectives.reduce_from(tgt, tensor.group))


def _chunk_nll(logits: torch.Tensor, targets: torch.Tensor, cfg: Config,
               axes: _Axes) -> torch.Tensor:
    """The mean NLL from this rank's logits and targets (its chunk, its
    vocab slice): over a context axis the mean over the group's chunks
    (`collectives.sum_over`, so each rank's gradient is its own chunk's,
    which `sharding.gather_for_use` averages over the axis as over
    data)."""
    if axes.tensor is not None:
        nll = _nll_vocab_split(logits, targets, cfg, axes.tensor)
    else:
        nll = _nll(logits, targets)
    if axes.context is not None:
        nll = collectives.sum_over(nll, axes.context.group) / \
            axes.context.size
    return nll


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: Config) -> torch.Tensor:
    """{"tokens": [B, S+1]} (or {"tokens", "targets"}) -> mean NLL (fp32),
    plus `moe_aux_coef` times the load-balance loss for an MoE config.
    Over a context axis every rank passes the whole rows and keeps its
    chunk of the shifted sequence; the result is the mean over the
    group."""
    inputs, targets = _shift(batch)
    axes, (start, stop), logits, auxs = _chunk_logits(params, inputs, cfg)
    nll = _chunk_nll(logits, targets[:, start:stop], cfg, axes)
    if cfg.num_experts > 1:
        return nll + cfg.moe_aux_coef * torch.stack(auxs).mean()
    return nll


# ------------------------------------------------------------- pipelined


def _pipelined_trunk(params: Params, inputs: torch.Tensor, cfg: Config,
                     mesh, rules, num_microbatches: Optional[int],
                     schedule):
    """inputs [B, S] (this rank's rows) -> (the axes, the pipeline stage,
    this rank's (start, stop) of the sequence, the final layer norm's
    output on the last stage (None on the others), the tied table as this
    rank holds it, and on the other stages the token their loss hangs on
    (None on the last))."""
    if cfg.num_experts > 1:
        raise NotImplementedError(
            "MoE blocks are not supported under pipeline parallelism yet — "
            "drop the pipeline axis or use a dense config")
    axes = _axes(params, cfg)
    mesh = mesh if mesh is not None else axes.mesh
    stage = pipeline.Stage(mesh)
    start, stop = 0, inputs.shape[1]
    if axes.context is not None:
        start, stop = chunk(inputs.shape[1], axes.context.index,
                            axes.context.size)

    def rep(p):  # replicated over the stages: the shares' sum
        return sharding.gather_for_use(p, keep=("tensor",),
                                       sum_over=("pipeline",))

    x, wte = _embed(params, inputs[:, start:stop], cfg, axes, start, rep)
    ln_f = map_params(rep, params["ln_f"])

    def block(xx, lp):
        return _block(xx, lp, cfg, axes)[0]

    if cfg.remat and torch.is_grad_enabled():
        block = _remat(block, cfg)
    shards = pipeline._batch_shards(mesh, rules)
    m = num_microbatches or pipeline.pipeline_microbatches_default(
        mesh, inputs.shape[0] * shards, rules)
    tail = None
    if schedule is not None:
        y = schedule(block, params["blocks"], x, m)
    elif stage.n_stages == 1:
        y = pipeline.pipeline_apply(block, params["blocks"], x, mesh=mesh,
                                    num_microbatches=m, rules=rules)
    else:
        y, tail = pipeline.run_stage(
            block, pipeline.stage_layers(params["blocks"], stage), x,
            stage=stage, num_microbatches=m, shards=shards)
    if y is None:
        # No head here; the final norm's gradient collectives still run.
        tail = pipeline.tie(tail, ln_f["scale"], ln_f["bias"], zero=True)
        return axes, stage, (start, stop), None, wte, tail
    x = _layer_norm(y, ln_f["scale"], ln_f["bias"], cfg.layer_norm_eps)
    return axes, stage, (start, stop), x, wte, None


def _from_last(t: torch.Tensor, shape, dtype, stage, schedule
               ) -> torch.Tensor:
    if schedule is not None or stage.n_stages == 1:
        return t
    return pipeline.from_last(t, shape, dtype, stage)


def apply_pipelined(params: Params, tokens: torch.Tensor, cfg: Config,
                    mesh, rules: Optional[sharding.LogicalRules] = None,
                    num_microbatches: Optional[int] = None,
                    schedule=None) -> torch.Tensor:
    """Forward pass with the transformer blocks run as pipeline stages
    over the mesh's `pipeline` axis (GPipe; parallel/pipeline.py):
    tokens [B, S] -> logits [B, S, vocab] in cfg.dtype, on every stage.
    The embedding runs on every stage, `ln_f` and the head on the last.
    `mesh`: the DeviceMesh (None: the params'); `num_microbatches` by
    default `pipeline_microbatches_default` of the global batch.
    `schedule(block_fn, blocks, x, num_microbatches)`, when given, runs
    the blocks in its place (`pipeline.walk`: every stage in one
    process)."""
    b, s = tokens.shape
    axes, stage, _, x, wte, tail = _pipelined_trunk(
        params, tokens, cfg, mesh, rules, num_microbatches, schedule)
    if x is not None:
        tail = _whole_logits(_head(x, wte, cfg, axes.tensor), axes, cfg)
    return _from_last(tail, (b, s, cfg.vocab_size), cfg.dtype, stage,
                      schedule)


def loss_fn_pipelined(params: Params, batch: Dict[str, torch.Tensor],
                      cfg: Config, mesh,
                      rules: Optional[sharding.LogicalRules] = None,
                      num_microbatches: Optional[int] = None,
                      schedule=None) -> torch.Tensor:
    """`loss_fn` with the blocks run as pipeline stages
    (`apply_pipelined`): the mean NLL (fp32), computed on the last stage
    and the same on every stage. A dense config only."""
    inputs, targets = _shift(batch)
    axes, stage, (start, stop), x, wte, tail = _pipelined_trunk(
        params, inputs, cfg, mesh, rules, num_microbatches, schedule)
    if x is not None:
        tail = _chunk_nll(_head(x, wte, cfg, axes.tensor),
                          targets[:, start:stop], cfg, axes)
    return _from_last(tail, (), torch.float32, stage, schedule)
