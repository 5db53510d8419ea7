"""KV-cached GPT-2 inference steps over a paged KV pool, in PyTorch.

Counterpart of the paged half of determined_tpu/serve/model.py:

  - **prefill** (`paged_prefill`): one causal pass over a prompt's novel
    suffix (right-padded to a bucket), writing its K/V into the sequence's
    pool blocks and returning the next-token logits. A prompt whose first
    `prefix_len` tokens are already cached (prefix caching) runs only the
    rest.
  - **decode** (`paged_decode_step`): one token per slot per call. Each slot
    writes its K/V into the block its table maps `position // block_size`
    to, then attends over its blocks through ops/paged_attention (the CUDA
    kernel on the card, the plain version on the CPU).

The pool is `{"k", "v"}: [L, num_blocks + 1, block_size, H, Dh]`; the last
block is the trash block where padded and inactive writes land. Where the
JAX functions donate the cache and return a new one, these update the K/V
pool tensors in place and return the same dict.

The per-layer `lax.scan` of the JAX package becomes a Python loop over the
stacked `[L, ...]` parameters. Weights are read in the JAX layout
(`(in, out)` matrices, `x @ W`); everything but the LayerNorm parameters
is cast to `cfg.dtype` before use (a no-op once the engine has cast them).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from determined_tpu_torch.models.gpt2 import Config, _embed_tokens, _layer_norm
from determined_tpu_torch.ops.paged_attention import paged_decode_attention

Cache = Dict[str, torch.Tensor]


def _layer(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer `i`'s slice of the stacked block params (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _qkv(x: torch.Tensor, lp, cfg: Config):
    """x: [B, S, D] -> q, k, v: [B, S, H, Dh]."""
    b, s, _ = x.shape
    dt = cfg.dtype
    qkv = x @ lp["qkv"]["kernel"].to(dt) + lp["qkv"]["bias"].to(dt)
    q, k, v = qkv.chunk(3, dim=-1)
    shape = (b, s, cfg.n_head, cfg.head_dim)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _mlp(y: torch.Tensor, lp, cfg: Config) -> torch.Tensor:
    """The block's dense FFN with the tanh-form GELU."""
    if cfg.num_experts > 1:
        raise NotImplementedError(
            "MoE serving is not ported yet (ROADMAP.md: MoE decode)")
    dt = cfg.dtype
    up = y @ lp["mlp_up"]["kernel"].to(dt) + lp["mlp_up"]["bias"].to(dt)
    up = F.gelu(up, approximate="tanh")
    return up @ lp["mlp_down"]["kernel"].to(dt) + lp["mlp_down"]["bias"].to(dt)


def _attn_out(attn: torch.Tensor, lp, cfg: Config) -> torch.Tensor:
    dt = cfg.dtype
    return attn @ lp["attn_out"]["kernel"].to(dt) + lp["attn_out"]["bias"].to(dt)


def _finish(params, x: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Final layernorm + the LM head tied to wte -> logits [..., vocab]."""
    x = _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"],
                    cfg.layer_norm_eps)
    return x @ params["wte"].to(cfg.dtype).T


# ---------------------------------------------------------------- paged pool


def init_paged_cache(cfg: Config, pool_blocks: int, block_size: int,
                     dtype: Optional[torch.dtype] = None,
                     device=None) -> Cache:
    """Zeroed paged KV pool: {"k","v"}: [L, pool_blocks, bs, H, Dh].

    `pool_blocks` INCLUDES the trailing trash block (callers size it as
    `num_blocks + 1`)."""
    dt = dtype or cfg.dtype
    shape = (cfg.n_layer, pool_blocks, block_size, cfg.n_head, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def paged_cache_bytes(cfg: Config, pool_blocks: int, block_size: int,
                      dtype: Optional[torch.dtype] = None) -> int:
    """Device bytes of the paged pool (both K and V)."""
    itemsize = torch.empty((), dtype=dtype or cfg.dtype).element_size()
    per = cfg.n_layer * pool_blocks * block_size * cfg.n_head * cfg.head_dim
    return 2 * per * itemsize


def paged_prefill(
    params: Dict[str, Any],
    cache: Cache,
    tokens: torch.Tensor,        # [bucket] int: the NOVEL SUFFIX, right-padded
    suffix_len: int,             # real suffix length (<= bucket)
    prefix_len: int,             # tokens already cached (KV reuse)
    block_table: torch.Tensor,   # [max_blocks] int32: the sequence's table
    cfg: Config,
) -> Tuple[Cache, torch.Tensor]:
    """Prefill the suffix of a prompt whose first `prefix_len` tokens' K/V
    already sit in `block_table`'s blocks.

    Returns (cache, last-position logits [vocab] fp32); the cache's pool
    tensors are updated in place. The suffix K/V are scattered into the
    pool per the table (padded positions into the trash block) BEFORE the
    lane is gathered, then the suffix queries attend over the gathered
    lane (cached prefix + just-written suffix) under `j <= prefix_len + i`.
    """
    suffix_len, prefix_len = int(suffix_len), int(prefix_len)
    s = tokens.shape[0]
    mb = block_table.shape[0]
    bs = cache["k"].shape[2]
    trash = cache["k"].shape[1] - 1
    dt = cfg.dtype
    dev = tokens.device
    table = block_table.long()
    x = _embed_tokens(params, tokens[None], cfg, dt)
    # Absolute positions prefix_len + i, clipped to the position table
    # (padded lanes' queries are garbage the `last` index never selects).
    ar = torch.arange(s, device=dev)
    pos_ids = torch.clamp(prefix_len + ar, max=params["wpe"].shape[0] - 1)
    x = x + params["wpe"].to(dt)[pos_ids][None]
    dest_blk = torch.where(ar < suffix_len,
                           table[torch.clamp(pos_ids // bs, max=mb - 1)],
                           torch.full_like(pos_ids, trash))
    dest_off = pos_ids % bs
    mask = (torch.arange(mb * bs, device=dev)[None, :]
            <= (prefix_len + ar)[:, None])  # [S, mb*bs]
    scale = 1.0 / math.sqrt(cfg.head_dim)

    for i in range(cfg.n_layer):
        lp = _layer(params["blocks"], i)
        k_pool, v_pool = cache["k"][i], cache["v"][i]
        y = _layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                        cfg.layer_norm_eps)
        q, k, v = _qkv(y, lp, cfg)  # [1, S, H, Dh]
        k_pool[dest_blk, dest_off] = k[0].to(k_pool.dtype)
        v_pool[dest_blk, dest_off] = v[0].to(v_pool.dtype)
        k_lane = k_pool[table].reshape(mb * bs, cfg.n_head, cfg.head_dim)
        v_lane = v_pool[table].reshape(mb * bs, cfg.n_head, cfg.head_dim)
        logits = torch.einsum("bshd,mhd->bhsm", q, k_lane).float()
        logits = torch.where(mask[None, None], logits * scale,
                             torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        attn = torch.einsum("bhsm,mhd->bshd", probs, v_lane).reshape(x.shape)
        x = x + _attn_out(attn, lp, cfg)
        y = _layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                        cfg.layer_norm_eps)
        x = x + _mlp(y, lp, cfg)
    # Only the last real position's logits are returned, so only its row
    # goes through the LM head (the rows are independent).
    last = x[0, max(suffix_len - 1, 0)]
    return cache, _finish(params, last, cfg).float()


def paged_decode_step(
    params: Dict[str, Any],
    cache: Cache,
    tokens: torch.Tensor,        # [slots] int: last emitted token per slot
    positions: torch.Tensor,     # [slots] int32: index this step writes at
    block_tables: torch.Tensor,  # [slots, max_blocks] int32
    cfg: Config,
    attention_impl: str = "auto",
) -> Tuple[Cache, torch.Tensor]:
    """One paged decode step for every slot -> (cache, logits [slots, V]).

    Each slot writes this step's K/V at `table[min(pos // bs, mb - 1)]`,
    offset `pos % bs`, BEFORE attention reads the pool; the pool tensors
    are updated in place. Inactive slots (all-trash table, position 0)
    all write trash offset 0 — duplicate scatter indices there are
    harmless, since nothing reads the trash block's content."""
    slots = tokens.shape[0]
    bs = cache["k"].shape[2]
    mb = block_tables.shape[1]
    dt = cfg.dtype
    pos = positions.long()
    x = _embed_tokens(params, tokens[:, None], cfg, dt)
    x = x + params["wpe"].to(dt)[pos][:, None]
    wblk = block_tables.long().gather(
        1, torch.clamp(pos // bs, max=mb - 1)[:, None])[:, 0]  # [slots]
    woff = pos % bs

    for i in range(cfg.n_layer):
        lp = _layer(params["blocks"], i)
        k_pool, v_pool = cache["k"][i], cache["v"][i]
        y = _layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                        cfg.layer_norm_eps)
        q, k, v = _qkv(y, lp, cfg)  # [slots, 1, H, Dh]
        k_pool[wblk, woff] = k[:, 0].to(k_pool.dtype)
        v_pool[wblk, woff] = v[:, 0].to(v_pool.dtype)
        attn = paged_decode_attention(
            q[:, 0].contiguous(), k_pool, v_pool, block_tables, positions,
            impl=attention_impl)  # [slots, H, Dh]
        x = x + _attn_out(attn.reshape(slots, 1, -1), lp, cfg)
        y = _layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                        cfg.layer_norm_eps)
        x = x + _mlp(y, lp, cfg)
    return cache, _finish(params, x, cfg)[:, 0].float()


def copy_paged_block(cache: Cache, dst: int, src: int) -> Cache:
    """Copy-on-write: duplicate pool block `src` into `dst` across every
    layer (both K and V), in place. Used when a sequence must write into a
    block whose content other sequences share (prefix caching)."""
    cache["k"][:, dst] = cache["k"][:, src]
    cache["v"][:, dst] = cache["v"][:, src]
    return cache


def sample(logits: torch.Tensor,        # [slots, vocab] fp32
           temperature: torch.Tensor,   # [slots] fp32; 0 = greedy
           generator: torch.Generator) -> torch.Tensor:
    """Next token per slot: argmax at temperature 0, else a categorical
    draw from softmax(logits / max(t, 1e-6)) by the Gumbel-max trick, with
    noise from `generator` (a different stream of bits than jax.random's)."""
    greedy = logits.argmax(dim=-1)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    expo = torch.empty_like(logits).exponential_(generator=generator)
    drawn = (logits / temp - torch.log(expo)).argmax(dim=-1)
    return torch.where(temperature > 0, drawn, greedy).to(torch.int32)
