"""KV-cached GPT-2 inference steps (prefill + single-token decode), in PyTorch.

Counterpart of determined_tpu/serve/model.py. Two cache layouts:

  - **paged** (the default; `init_paged_cache` / `paged_prefill` /
    `paged_decode_step`): a block pool `{"k", "v"}: [L, num_blocks + 1,
    block_size, H, Dh]` addressed through per-sequence block tables. The
    last block is the trash block where padded and inactive writes land.
    Prefill runs a prompt's novel suffix (right-padded to a bucket) and
    writes its K/V into the sequence's blocks; a prompt whose first
    `prefix_len` tokens are cached (prefix caching) runs only the rest.
    Decode writes each slot's K/V into the block its table maps
    `position // block_size` to, then attends over its blocks through
    ops/paged_attention (the CUDA kernel on the card, the plain version on
    the CPU).
  - **dense** (`init_cache` / `prefill` / `decode_step`): one private lane
    `[L, slots, max_seq, H, Dh]` a slot, plain attention over the lane (the
    JAX package's is plain einsum attention too: no kernel).

Where the JAX functions donate the cache and return a new one, these update
the K/V tensors in place and return the same dict.

**Shape-static and free of host reads.** Every length, slot and index that
the JAX functions take as a traced scalar (`suffix_len`, `prefix_len`,
`length`, `slot`, the adapter index, the block copy's `dst`/`src`) may be a
0-d integer tensor on the device, and nothing here reads a device value on
the host: no `int(tensor)`, no 0-d tensor used as a Python index (PyTorch
reads those with `.item()`), no data-dependent shape. So the engine can
capture each function once in a CUDA graph and replay it with new inputs
copied into the same buffers, as the JAX engine compiles each once. Python
ints are accepted too (eager callers); they are made into tensors on the
device.

**Adapters** (multi-adapter serving): an adapter is the tied embedding /
LM-head table of a head-tuned fine-tune. The stack `[A+1, V, D]` (index 0
= the base table) is an input like the params, and a per-lane index picks
each lane's table at the two places the table is read: the token embedding
(`_embed_adapter`) and the logits (`_finish_adapter`). The transformer body
and the cached K/V stay the base's.

The per-layer `lax.scan` of the JAX package becomes a Python loop over the
stacked `[L, ...]` parameters. Weights are read in the JAX layout
(`(in, out)` matrices, `x @ W`); everything but the LayerNorm parameters
is cast to `cfg.dtype` before use (a no-op once the engine has cast them).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from determined_tpu_torch.models.gpt2 import Config, _embed_tokens, _layer_norm
from determined_tpu_torch.ops.paged_attention import paged_decode_attention

Cache = Dict[str, torch.Tensor]
Scalar = Union[int, torch.Tensor]


def _index(v: Scalar, device) -> torch.Tensor:
    """A length or index as a 1-element int64 tensor on `device`: a tensor
    (the engine's static int32 input) is widened there, a Python int is
    made there. Shape [1], never 0-d: a 0-d tensor used as an index is read
    on the host."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.long).reshape(1)
    return torch.tensor([int(v)], dtype=torch.long, device=device)


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


def _block_tail(x: torch.Tensor, attn: torch.Tensor, lp,
                cfg: Config) -> torch.Tensor:
    """The block after attention: out-projection, residual, ln2, FFN."""
    x = x + _attn_out(attn, lp, cfg)
    y = _layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                    cfg.layer_norm_eps)
    return x + _mlp(y, lp, cfg)


def _finish(params, x: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Final layernorm + the LM head tied to wte -> logits [..., vocab]."""
    x = _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"],
                    cfg.layer_norm_eps)
    return x @ params["wte"].to(cfg.dtype).T


# ------------------------------------------------------------- adapters


def _embed_adapter(adapters: torch.Tensor, idx: torch.Tensor,
                   tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-lane token embedding from the adapter stack `[A+1, V, D]`.

    idx 0-d (prefill: one lane, tokens [S] -> [S, D]) or [slots] (decode:
    one token a lane, tokens [slots] -> [slots, D]). The JAX function takes
    each lane's whole table and then its rows; this gathers the rows
    `adapters[idx, tokens]` alone, the same values."""
    return adapters[idx.reshape(-1).long(), tokens.long()].to(dtype)


def _finish_adapter(params, x: torch.Tensor, adapters: torch.Tensor,
                    idx: torch.Tensor, cfg: Config) -> torch.Tensor:
    """_finish with the LM head picked per lane from the adapter stack.

    x: [B, S, D]; idx 0-d (prefill, B == 1) or [slots] (decode, S == 1)
    -> logits [B, S, V]."""
    x = _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"],
                    cfg.layer_norm_eps)
    sel = adapters.index_select(0, idx.reshape(-1).long()).to(cfg.dtype)
    return x @ sel.transpose(1, 2)


def _embed(params, tokens: torch.Tensor, cfg: Config,
           adapters: Optional[torch.Tensor],
           idx: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embedding [..., D] of `tokens` [...] from wte or the stack."""
    if adapters is None:
        return _embed_tokens(params, tokens, cfg, cfg.dtype)
    return _embed_adapter(adapters, idx, tokens, cfg.dtype)


def _logits(params, x: torch.Tensor, cfg: Config,
            adapters: Optional[torch.Tensor],
            idx: Optional[torch.Tensor]) -> torch.Tensor:
    """Logits [B, S, V] of x [B, S, D] from wte or the stack."""
    if adapters is None:
        return _finish(params, x, cfg)
    return _finish_adapter(params, x, adapters, idx, cfg)


def _attend(q: torch.Tensor, k_lane: torch.Tensor, v_lane: torch.Tensor,
            mask: torch.Tensor, eq: str, out_eq: str,
            head_dim: int) -> torch.Tensor:
    """Plain masked attention with the JAX arithmetic: fp32 logits scaled
    by 1/sqrt(Dh), masked to fp32's min, fp32 softmax, probabilities cast
    to q's dtype before the product with V."""
    logits = torch.einsum(eq, q, k_lane).float()
    logits = torch.where(mask, logits * (1.0 / math.sqrt(head_dim)),
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum(out_eq, probs, v_lane)


def _last_row(x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """x[0, max(length - 1, 0)] kept as [1, 1, D], picked on the device."""
    return x[0].index_select(0, torch.clamp(length - 1, min=0))[None]


# ---------------------------------------------------------------- dense


def init_cache(cfg: Config, slots: int, max_seq: int,
               dtype: Optional[torch.dtype] = None, device=None) -> Cache:
    """Zeroed slot-dense KV cache: {"k","v"}: [L, slots, max_seq, H, Dh]."""
    if max_seq > cfg.n_positions:
        raise ValueError(
            f"max_seq {max_seq} exceeds the model's position table "
            f"({cfg.n_positions})")
    dt = dtype or cfg.dtype
    shape = (cfg.n_layer, slots, max_seq, cfg.n_head, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def cache_bytes(cfg: Config, slots: int, max_seq: int,
                dtype: Optional[torch.dtype] = None) -> int:
    """Device bytes of the dense cache (both K and V)."""
    itemsize = torch.empty((), dtype=dtype or cfg.dtype).element_size()
    per = cfg.n_layer * slots * max_seq * cfg.n_head * cfg.head_dim
    return 2 * per * itemsize


def prefill(
    params: Dict[str, Any],
    cache: Cache,
    tokens: torch.Tensor,     # [bucket] int, right-padded to the bucket
    length: Scalar,           # real prompt length (<= bucket)
    slot: Scalar,             # cache lane to fill
    cfg: Config,
    adapters: Optional[torch.Tensor] = None,      # [A+1, V, D] stack
    slot_adapter: Optional[torch.Tensor] = None,  # 0-d stack index
) -> Tuple[Cache, torch.Tensor]:
    """Run the prompt through the model, filling cache lane `slot`
    (positions 0..bucket-1; the padded ones hold garbage that the decode
    mask never reads before a decode step overwrites it).

    Returns (cache, last-position logits [vocab] fp32)."""
    s = tokens.shape[0]
    dev = tokens.device
    length = _index(length, dev)
    slot = _index(slot, dev)
    x = _embed(params, tokens, cfg, adapters, slot_adapter)[None]
    x = x + params["wpe"].to(cfg.dtype)[:s][None]
    ar = torch.arange(s, device=dev)
    # Causal, and keys past the prompt's end masked (key-side padding).
    mask = (ar[None, :] <= ar[:, None]) & (ar[None, :] < length)

    for i in range(cfg.n_layer):
        lp = _layer(params["blocks"], i)
        y = _layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                        cfg.layer_norm_eps)
        q, k, v = _qkv(y, lp, cfg)  # [1, S, H, Dh]
        for key, t in (("k", k), ("v", v)):
            lane = cache[key][i].narrow(1, 0, s)  # [slots, S, H, Dh]
            lane.index_copy_(0, slot, t.to(lane.dtype))
        attn = _attend(q, k, v, mask[None, None], "bqhd,bkhd->bhqk",
                       "bhqk,bkhd->bqhd", cfg.head_dim)
        x = _block_tail(x, attn.reshape(x.shape), lp, cfg)
    # Only the last real position's logits are returned, so only its row
    # goes through the LM head (the rows are independent).
    last = _logits(params, _last_row(x, length), cfg, adapters, slot_adapter)
    return cache, last[0, 0].float()


def decode_step(
    params: Dict[str, Any],
    cache: Cache,
    tokens: torch.Tensor,     # [slots] int: last emitted token per slot
    positions: torch.Tensor,  # [slots] int: index this step writes/attends at
    cfg: Config,
    adapters: Optional[torch.Tensor] = None,       # [A+1, V, D] stack
    slot_adapters: Optional[torch.Tensor] = None,  # [slots] stack index
) -> Tuple[Cache, torch.Tensor]:
    """One dense decode step for every slot -> (cache, logits [slots, V]).

    Each slot writes this step's K/V at its lane's `position` and attends
    over `index <= position`: the prompt, every earlier step and this one,
    never a stale byte. Inactive slots ride along at position 0."""
    slots = tokens.shape[0]
    max_seq = cache["k"].shape[2]
    dev = tokens.device
    pos = positions.long()
    x = _embed(params, tokens, cfg, adapters, slot_adapters)[:, None]
    x = x + params["wpe"].to(cfg.dtype)[pos][:, None]
    lane_ids = torch.arange(slots, device=dev)
    mask = torch.arange(max_seq, device=dev)[None] <= pos[:, None]

    for i in range(cfg.n_layer):
        lp = _layer(params["blocks"], i)
        k_lane, v_lane = cache["k"][i], cache["v"][i]
        y = _layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                        cfg.layer_norm_eps)
        q, k, v = _qkv(y, lp, cfg)  # [slots, 1, H, Dh]
        k_lane.index_put_((lane_ids, pos), k[:, 0].to(k_lane.dtype))
        v_lane.index_put_((lane_ids, pos), v[:, 0].to(v_lane.dtype))
        attn = _attend(q[:, 0], k_lane, v_lane, mask[:, None],
                       "bhd,bmhd->bhm", "bhm,bmhd->bhd", cfg.head_dim)
        x = _block_tail(x, attn.reshape(slots, 1, -1), lp, cfg)
    logits = _logits(params, x, cfg, adapters, slot_adapters)
    return cache, logits[:, 0].float()


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
    suffix_len: Scalar,          # real suffix length (<= bucket)
    prefix_len: Scalar,          # tokens already cached (KV reuse)
    block_table: torch.Tensor,   # [max_blocks] int32: the sequence's table
    cfg: Config,
    adapters: Optional[torch.Tensor] = None,      # [A+1, V, D] stack
    slot_adapter: Optional[torch.Tensor] = None,  # 0-d stack index
) -> Tuple[Cache, torch.Tensor]:
    """Prefill the suffix of a prompt whose first `prefix_len` tokens' K/V
    already sit in `block_table`'s blocks.

    Returns (cache, last-position logits [vocab] fp32); the cache's pool
    tensors are updated in place. The suffix K/V are scattered into the
    pool per the table (padded positions into the trash block) BEFORE the
    lane is gathered, then the suffix queries attend over the gathered
    lane (cached prefix + just-written suffix) under `j <= prefix_len + i`.
    """
    s = tokens.shape[0]
    mb = block_table.shape[0]
    bs = cache["k"].shape[2]
    trash = cache["k"].shape[1] - 1
    dev = tokens.device
    suffix_len = _index(suffix_len, dev)
    prefix_len = _index(prefix_len, dev)
    table = block_table.long()
    x = _embed(params, tokens, cfg, adapters, slot_adapter)[None]
    # Absolute positions prefix_len + i, clipped to the position table
    # (padded lanes' queries are garbage the `last` index never selects).
    ar = torch.arange(s, device=dev)
    pos_ids = torch.clamp(prefix_len + ar, max=params["wpe"].shape[0] - 1)
    x = x + params["wpe"].to(cfg.dtype)[pos_ids][None]
    dest_blk = torch.where(ar < suffix_len,
                           table[torch.clamp(pos_ids // bs, max=mb - 1)],
                           torch.full_like(pos_ids, trash))
    dest_off = pos_ids % bs
    mask = (torch.arange(mb * bs, device=dev)[None, :]
            <= (prefix_len + ar)[:, None])  # [S, mb*bs]

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
        attn = _attend(q, k_lane, v_lane, mask[None, None],
                       "bshd,mhd->bhsm", "bhsm,mhd->bshd", cfg.head_dim)
        x = _block_tail(x, attn.reshape(x.shape), lp, cfg)
    last = _logits(params, _last_row(x, suffix_len), cfg, adapters,
                   slot_adapter)
    return cache, last[0, 0].float()


def paged_decode_step(
    params: Dict[str, Any],
    cache: Cache,
    tokens: torch.Tensor,        # [slots] int: last emitted token per slot
    positions: torch.Tensor,     # [slots] int32: index this step writes at
    block_tables: torch.Tensor,  # [slots, max_blocks] int32
    cfg: Config,
    attention_impl: str = "auto",
    adapters: Optional[torch.Tensor] = None,       # [A+1, V, D] stack
    slot_adapters: Optional[torch.Tensor] = None,  # [slots] stack index
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
    pos = positions.long()
    x = _embed(params, tokens, cfg, adapters, slot_adapters)[:, None]
    x = x + params["wpe"].to(cfg.dtype)[pos][:, None]
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
        x = _block_tail(x, attn.reshape(slots, 1, -1), lp, cfg)
    logits = _logits(params, x, cfg, adapters, slot_adapters)
    return cache, logits[:, 0].float()


def copy_paged_block(cache: Cache, dst: Scalar, src: Scalar) -> Cache:
    """Copy-on-write: duplicate pool block `src` into `dst` across every
    layer (both K and V), in place. Used when a sequence must write into a
    block whose content other sequences share (prefix caching)."""
    dev = cache["k"].device
    dst, src = _index(dst, dev), _index(src, dev)
    for key in ("k", "v"):
        cache[key].index_copy_(1, dst, cache[key].index_select(1, src))
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
