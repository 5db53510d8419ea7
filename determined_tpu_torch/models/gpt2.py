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
`cfg.attention_impl`. MoE blocks and the pipelined forward
(`apply_pipelined`) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from determined_tpu_torch.ops.flash_attention import flash_attention
from determined_tpu_torch.parallel import sharding

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
    # Mixture-of-Experts: >1 replaces every block's MLP with a routed FFN.
    # The port does not serve MoE yet (ROADMAP.md); the fields keep the
    # config interchangeable with the JAX package's.
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
    `params_from_numpy` instead."""
    if cfg.num_experts > 1:
        raise NotImplementedError(
            "MoE GPT-2 is not ported yet (ROADMAP.md: MoE decode)")
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

    return {
        "wte": normal((v, d), std),
        "wpe": normal((p, d), std),
        "blocks": {
            "ln1": {"scale": ones((L, d)), "bias": zeros((L, d))},
            "qkv": {"kernel": normal((L, d, 3 * d), std),
                    "bias": zeros((L, 3 * d))},
            "attn_out": {"kernel": normal((L, d, d), res_std),
                         "bias": zeros((L, d))},
            "ln2": {"scale": ones((L, d)), "bias": zeros((L, d))},
            "mlp_up": {"kernel": normal((L, d, f), std),
                       "bias": zeros((L, f))},
            "mlp_down": {"kernel": normal((L, f, d), res_std),
                         "bias": zeros((L, d))},
        },
        "ln_f": {"scale": ones((d,)), "bias": zeros((d,))},
    }


def param_logical_axes(cfg: Config) -> Dict[str, Any]:
    """Logical axis names per param dim (the JAX package's); the leading
    "layers" dim of the stacked blocks maps to the `pipeline` mesh axis
    (replicated when pipeline=1)."""
    if cfg.num_experts > 1:
        raise NotImplementedError(
            "MoE GPT-2 is not ported yet (ROADMAP.md: MoE decode)")
    L = "layers"
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": {
            "ln1": {"scale": (L, "embed"), "bias": (L, "embed")},
            "qkv": {"kernel": (L, "embed", "heads"), "bias": (L, "heads")},
            "attn_out": {"kernel": (L, "heads", "embed"),
                         "bias": (L, "embed")},
            "ln2": {"scale": (L, "embed"), "bias": (L, "embed")},
            "mlp_up": {"kernel": (L, "embed", "mlp"), "bias": (L, "mlp")},
            "mlp_down": {"kernel": (L, "mlp", "embed"),
                         "bias": (L, "embed")},
        },
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


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: Config,
                  dtype: torch.dtype) -> torch.Tensor:
    """Token embedding: the gather `wte[tokens]` in `dtype`."""
    return params["wte"].to(dtype)[tokens.long()]


def _block(x: torch.Tensor, lp: Params, cfg: Config) -> torch.Tensor:
    """One transformer block. x: [B, S, D]; lp: this layer's param slice."""
    b, s, d = x.shape
    h, dh = cfg.n_head, cfg.head_dim
    dt = cfg.dtype

    y = _layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                    cfg.layer_norm_eps)
    qkv = y @ lp["qkv"]["kernel"].to(dt) + lp["qkv"]["bias"].to(dt)
    # Per-head views of the fused product: the kernels read them in place.
    q, k, v = (t.view(b, s, h, dh) for t in qkv.split(d, dim=-1))
    attn = flash_attention(q, k, v, causal=True, impl=cfg.attention_impl,
                           bf16=cfg.attention_bf16).reshape(b, s, d)
    attn = attn @ lp["attn_out"]["kernel"].to(dt) + \
        lp["attn_out"]["bias"].to(dt)
    x = x + attn

    y = _layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                    cfg.layer_norm_eps)
    up = y @ lp["mlp_up"]["kernel"].to(dt) + lp["mlp_up"]["bias"].to(dt)
    up = F.gelu(up, approximate="tanh")
    down = up @ lp["mlp_down"]["kernel"].to(dt) + \
        lp["mlp_down"]["bias"].to(dt)
    return x + down


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


def apply(params: Params, tokens: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Forward pass: tokens [B, S] -> logits [B, S, vocab] in cfg.dtype."""
    if cfg.num_experts > 1:
        raise NotImplementedError(
            "MoE GPT-2 is not ported yet (ROADMAP.md: MoE decode)")
    s = tokens.shape[1]
    dt = cfg.dtype
    # Sharded params (DTensors, train/state.py) are gathered just before
    # use; plain tensors pass through. The tied `wte` is gathered once, so
    # its two uses' gradients sum before the one reduce-scatter.
    gather = sharding.gather_for_use
    wte = gather(params["wte"])
    x = _embed_tokens({"wte": wte}, tokens, cfg, dt)
    x = x + gather(params["wpe"]).to(dt)[:s][None]
    block = functools.partial(_block, cfg=cfg)
    if cfg.remat and torch.is_grad_enabled():
        block = _remat(block, cfg)
    for lp in _unstack_layers(params["blocks"], cfg.n_layer):
        x = block(x, map_params(gather, lp))
    ln_f = map_params(gather, params["ln_f"])
    x = _layer_norm(x, ln_f["scale"], ln_f["bias"], cfg.layer_norm_eps)
    return x @ wte.to(dt).t()


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL as logsumexp(logits) - logits[target], in fp32."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - tgt.float())


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: Config) -> torch.Tensor:
    """{"tokens": [B, S+1]} (or {"tokens", "targets"}) -> mean NLL (fp32)."""
    tokens = batch["tokens"]
    if "targets" in batch:
        inputs, targets = tokens, batch["targets"]
    else:
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    return _nll(apply(params, inputs, cfg), targets)
