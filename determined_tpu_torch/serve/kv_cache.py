"""KV-cache block manager — paged admission control + prefix caching.

The port's own copy of determined_tpu/serve/kv_cache.py, with the same
accounting contract.

The device-side KV cache is a paged block pool (`serve/model.py`
`init_paged_cache`: `[L, num_blocks + 1, block_size, H, Dh]`, the last
block being the trash block the manager never hands out). This manager
owns the pool's HOST-side truth, vLLM style:

  - **allocation**: a sequence is admitted only when enough blocks exist
    to cover its worst case (prompt + max_new_tokens); exhaustion keeps
    it queued (backpressure, never failure). Because the device layout is
    paged too (the tables this manager hands out index the real pool),
    the accounting now bounds actual HBM — not a worst-case `slots ×
    max_seq` reservation.
  - **prefix caching**: full prompt blocks are registered in a chained
    hash index (`hash(chunk_0)`, `hash(h_0, chunk_1)`, … — a hit at
    depth i implies the whole prefix matches). A new prompt reuses every
    matching block by bumping its refcount; admission charges only the
    novel suffix's blocks. Retired prompt blocks with no remaining
    sharers park in an LRU "cached" pool: still reusable by the next
    matching prompt, evicted only when a fresh allocation needs the
    space — so a fleet serving a shared system prompt pays its KV once.
  - **copy-on-write**: a sequence that must write into a block whose
    content other sequences still reference gets a private copy (the
    caller mirrors the copy on-device via `engine.copy_block`). With
    full-block-granular sharing this only happens when a prompt is a
    complete cache hit and the last token must be recomputed for its
    logits.

Thread-safe: the batcher allocates at step boundaries while the HTTP
front-end reads stats. Misuse (double admit, unknown free) raises —
an accounting bug must surface, not silently skew capacity.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple


class KVBlockError(ValueError):
    """Inconsistent block-manager use (double free, unknown sequence)."""


class BlockManager:
    """Fixed pool of refcounted KV blocks with a prefix-reuse index."""

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = True):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = bool(prefix_cache)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._owned: Dict[str, List[int]] = {}  # seq id -> block ids
        self._refs: Dict[int, int] = {}         # block id -> refcount
        self._block_hash: Dict[int, int] = {}   # block id -> chain hash
        self._hash_block: Dict[int, int] = {}   # chain hash -> block id
        # ref==0 prompt blocks retained for reuse, LRU order (oldest first).
        self._cached: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()
        self._ever_freed: set = set()  # block ids that have cycled back
        # Lifetime counters (stats / tests).
        self.total_allocated = 0
        self.total_freed = 0
        self.total_reused = 0
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens_seen = 0
        self.cached_evictions = 0
        self.cow_copies = 0

    # -- geometry ------------------------------------------------------

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Blocks covering `n_tokens` (ceil division; 0 tokens → 0)."""
        return (max(0, n_tokens) + self.block_size - 1) // self.block_size

    @property
    def free_blocks(self) -> int:
        """Blocks available to a new allocation: truly free + cached
        (evictable) prefix blocks nobody references."""
        with self._lock:
            return len(self._free) + len(self._cached)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def cached_blocks(self) -> int:
        """Evictable ref==0 prompt blocks retained for prefix reuse."""
        with self._lock:
            return len(self._cached)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.blocks_for_tokens(n_tokens) <= self.free_blocks

    # -- internal pool ops (lock held) ---------------------------------

    def _take_locked(self) -> int:
        """Pop one block: free list first, then evict the LRU cached
        prefix block (dropping its index entry). Caller checked capacity."""
        if self._free:
            blk = self._free.pop()
        else:
            blk, h = self._cached.popitem(last=False)  # LRU
            self._hash_block.pop(h, None)
            self._block_hash.pop(blk, None)
            self.cached_evictions += 1
        if blk in self._ever_freed:
            self.total_reused += 1
        self._refs[blk] = 1
        self.total_allocated += 1
        return blk

    def _release_locked(self, blk: int, discard: bool) -> None:
        """Drop one reference; at zero the block parks (hashed prompt
        block) or returns to the free list."""
        refs = self._refs.get(blk, 0) - 1
        if refs < 0:
            raise KVBlockError(f"block {blk} over-released")
        if refs > 0:
            self._refs[blk] = refs
            return
        self._refs.pop(blk, None)
        self._ever_freed.add(blk)
        self.total_freed += 1  # counted when the block truly leaves use
        h = self._block_hash.get(blk)
        if h is not None and self.prefix_cache and not discard:
            self._cached[blk] = h
            self._cached.move_to_end(blk)
        else:
            if h is not None:
                self._hash_block.pop(h, None)
                self._block_hash.pop(blk, None)
            self._free.append(blk)

    @staticmethod
    def _chain_hashes(prompt: Sequence[int], block_size: int) -> List[int]:
        """Chained content hashes of the prompt's FULL blocks: a match at
        depth i implies blocks 0..i all match (the hash folds the
        previous hash in)."""
        hashes: List[int] = []
        h = 0
        for i in range(len(prompt) // block_size):
            chunk = tuple(int(t) for t in
                          prompt[i * block_size:(i + 1) * block_size])
            h = hash((h, chunk))
            hashes.append(h)
        return hashes

    # -- admission (paged + prefix-aware) ------------------------------

    def admit(
        self, seq_id: str, prompt: Sequence[int], total_tokens: int
    ) -> Optional[Tuple[List[int], int, List[Tuple[int, int]]]]:
        """Admit a sequence: reuse cached prefix blocks, charge only the
        rest.

        Returns `(block_table, cached_len, cow_pairs)` or None when the
        pool can't cover the charge (caller keeps the request queued):

          - `block_table`: pool block ids in logical order, covering
            `total_tokens` (prompt + every future generated token);
          - `cached_len`: prompt tokens whose K/V need NO recompute —
            always < len(prompt), so prefill has at least one query to
            produce logits from;
          - `cow_pairs`: `(src, dst)` device copies the caller must
            perform before writing (a full-prompt cache hit whose final
            block is still shared).
        """
        prompt = list(prompt)
        n_prompt = len(prompt)
        if n_prompt <= 0:
            raise KVBlockError("cannot admit an empty prompt")
        if total_tokens < n_prompt:
            raise KVBlockError("total_tokens must cover the prompt")
        need_total = self.blocks_for_tokens(total_tokens)
        with self._lock:
            if seq_id in self._owned:
                raise KVBlockError(f"sequence {seq_id!r} already owns blocks")
            matched: List[int] = []
            if self.prefix_cache:
                for h in self._chain_hashes(prompt, self.block_size):
                    blk = self._hash_block.get(h)
                    if blk is None:
                        break
                    matched.append(blk)
            cached_len = len(matched) * self.block_size
            # Prefill needs >= 1 query token for the next-token logits; a
            # full-prompt hit recomputes (and rewrites) the last token.
            cow_needed = 0
            if cached_len >= n_prompt:
                cached_len = n_prompt - 1
                last = matched[-1]
                # The recompute writes into the final matched block; a
                # private copy is only needed while others reference it
                # (a parked ref==0 block is exclusively ours once pinned).
                if self._refs.get(last, 0) > 0:
                    cow_needed = 1
            # Capacity: free + evictable-cached, EXCLUDING matched blocks
            # (they are about to be pinned, not evicted).
            need_new = need_total - len(matched) + cow_needed
            evictable = sum(1 for b in self._cached if b not in matched)
            if need_new > len(self._free) + evictable:
                return None
            # Pin the matched prefix blocks.
            for blk in matched:
                if blk in self._cached:
                    del self._cached[blk]
                self._refs[blk] = self._refs.get(blk, 0) + 1
            cow_pairs: List[Tuple[int, int]] = []
            if cow_needed:
                src = matched[-1]
                dst = self._take_locked()
                cow_pairs.append((src, dst))
                self.cow_copies += 1
                # The copy replaces the shared block in THIS table only.
                self._release_locked(src, discard=False)
                matched[-1] = dst
            table = list(matched)
            for _ in range(need_total - len(matched)):
                table.append(self._take_locked())
            self._owned[seq_id] = table
            # Counters move only on a SUCCESSFUL admission: a blocked
            # request retries every step boundary, and counting each
            # attempt would skew the hit rate.
            self.prompt_tokens_seen += n_prompt
            # Register the new full prompt blocks for future reuse (the
            # batcher prefills them before the next admission runs, so
            # registering now is safe in the single-consumer batcher).
            if self.prefix_cache:
                self.prefix_queries += 1
                hashes = self._chain_hashes(prompt, self.block_size)
                if matched:
                    self.prefix_hits += 1
                self.prefix_hit_tokens += cached_len
                for i, h in enumerate(hashes):
                    if h not in self._hash_block:
                        self._hash_block[h] = table[i]
                        self._block_hash[table[i]] = h
            return list(table), cached_len, cow_pairs

    # -- legacy allocation (no prompt content → no prefix reuse) -------

    def allocate(self, seq_id: str, n_tokens: int) -> Optional[List[int]]:
        """Reserve blocks for a sequence of up to `n_tokens` tokens.

        Returns the block ids, or None when the pool can't cover it (the
        caller keeps the request queued — backpressure, not failure).
        """
        need = self.blocks_for_tokens(n_tokens)
        with self._lock:
            if seq_id in self._owned:
                raise KVBlockError(f"sequence {seq_id!r} already owns blocks")
            if need > len(self._free) + len(self._cached):
                return None
            blocks = [self._take_locked() for _ in range(need)]
            self._owned[seq_id] = blocks
            return list(blocks)

    def extend(self, seq_id: str, n_tokens: int) -> bool:
        """Grow a sequence's reservation to cover `n_tokens` total. True on
        success; False when the pool is exhausted (caller must retire or
        reject)."""
        with self._lock:
            owned = self._owned.get(seq_id)
            if owned is None:
                raise KVBlockError(f"sequence {seq_id!r} owns no blocks")
            need = self.blocks_for_tokens(n_tokens) - len(owned)
            if need <= 0:
                return True
            if need > len(self._free) + len(self._cached):
                return False
            owned.extend(self._take_locked() for _ in range(need))
            return True

    def free(self, seq_id: str, discard: bool = False) -> int:
        """Release a retired sequence's references; returns the block
        count released. Shared blocks stay resident for their other
        owners; sole-owned prompt blocks park in the prefix cache
        (`discard=True` — e.g. a failed prefill whose K/V never got
        written — sends them straight back to the free list instead).
        Double-free / unknown ids raise."""
        with self._lock:
            blocks = self._owned.pop(seq_id, None)
            if blocks is None:
                raise KVBlockError(f"sequence {seq_id!r} owns no blocks")
            for blk in blocks:
                self._release_locked(blk, discard)
            return len(blocks)

    def owned(self, seq_id: str) -> List[int]:
        with self._lock:
            return list(self._owned.get(seq_id, ()))

    def ref_count(self, block_id: int) -> int:
        with self._lock:
            return self._refs.get(block_id, 0)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            free = len(self._free) + len(self._cached)
            hit_rate = (self.prefix_hit_tokens / self.prompt_tokens_seen
                        if self.prompt_tokens_seen else 0.0)
            return {
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "free_blocks": free,
                "used_blocks": self.num_blocks - free,
                "cached_blocks": len(self._cached),
                "total_allocated": self.total_allocated,
                "total_freed": self.total_freed,
                "total_reused": self.total_reused,
                "prefix_cache": self.prefix_cache,
                "prefix_queries": self.prefix_queries,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prompt_tokens_seen": self.prompt_tokens_seen,
                "prefix_cache_hit_rate": round(hit_rate, 4),
                "cached_evictions": self.cached_evictions,
                "cow_copies": self.cow_copies,
            }
