"""ServingEngine — params -> warmed prefill/decode over a paged KV pool.

Counterpart of determined_tpu/serve/engine.py for the paged layout. Owns
everything device-side for one serve replica:

  - the params, moved to the device once and cast once to `cfg.dtype`
    (all but the fp32 LayerNorm parameters; the cast is deterministic, so
    casting at load equals casting at every use);
  - the paged KV pool `[L, num_blocks + 1, block_size, H, Dh]` (the last
    block is the trash block) and the per-slot block tables the batcher
    hands in at prefill;
  - a `torch.Generator` on the device, seeded from `serving.seed`, for
    temperature sampling.

`compile()` plays the part of the JAX engine's AOT compile: it builds the
CUDA kernel and runs one warm call of decode and of every prefill bucket
(all writes land in the trash block), so no request pays a build.

The engine is single-consumer: only the batcher thread calls
prefill/decode; stats reads are plain counters.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.models.gpt2 import Config, load_params_npz
from determined_tpu_torch.ops import _build
from determined_tpu_torch.ops.paged_attention import (
    paged_attention_cuda, paged_attention_reference)
from determined_tpu_torch.serve import model as smodel

logger = logging.getLogger("determined_tpu_torch.serve")

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024)


def default_buckets(max_seq: int) -> List[int]:
    out = [b for b in DEFAULT_BUCKETS if b < max_seq]
    return out + [max_seq]


def load_checkpoint_params(path: str) -> Dict[str, Any]:
    """Params (numpy arrays) from a `models.gpt2.save_params_npz` file."""
    return load_params_npz(path)


def resolve_attention_impl(impl: str, device: torch.device) -> str:
    """serving.attention_impl -> "kernel" | "reference".

    "auto" is the CUDA kernel on a CUDA device and the plain version on the
    CPU; "kernel" (config spelling "pallas" accepted) forces the kernel and
    raises at the first decode on the CPU; "reference" is the explicit A/B
    switch to the plain version."""
    if impl == "auto":
        return "kernel" if device.type == "cuda" else "reference"
    if impl in ("kernel", "pallas"):
        return "kernel"
    if impl == "reference":
        return "reference"
    raise ValueError(
        f"unknown serving.attention_impl {impl!r}; valid: auto, kernel "
        "(or pallas), reference")


def _cast_params(params: Dict[str, Any], cfg: Config,
                 device: torch.device) -> Dict[str, Any]:
    """Move to `device`; cast everything but LayerNorm params to cfg.dtype."""
    def cast(tree, keep_dtype):
        if isinstance(tree, dict):
            return {k: cast(v, keep_dtype or k.startswith("ln"))
                    for k, v in tree.items()}
        t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
            np.array(tree, copy=True))
        t = t.to(device)
        return t if keep_dtype else t.to(cfg.dtype)
    return cast(params, False)


class ServingEngine:
    """Warmed prefill/decode over a fixed slot batch + paged KV pool.

    Every call takes the slot's block table canonicalised to the full
    `max_seq_len // block_size` length (unused entries point at the trash
    block), as the JAX engine's executables do.
    """

    def __init__(
        self,
        params: Dict[str, Any],
        cfg: Config,
        *,
        slots: int = 8,
        max_seq_len: int = 256,
        prefill_buckets: Optional[Sequence[int]] = None,
        seed: int = 0,
        attention_impl: str = "auto",
        kv_block_size: int = 16,
        kv_num_blocks: Optional[int] = None,
        device=None,
    ):
        if slots <= 0:
            raise ValueError("slots must be positive")
        if cfg.num_experts > 1:
            raise NotImplementedError(
                "MoE serving is not ported yet (ROADMAP.md: MoE decode)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.max_seq_len = min(max_seq_len, cfg.n_positions)
        self.prefill_buckets = sorted(set(
            min(b, self.max_seq_len)
            for b in (prefill_buckets or default_buckets(self.max_seq_len))))
        self.params = _cast_params(params, cfg, self.device)
        self.attention_impl = resolve_attention_impl(attention_impl,
                                                     self.device)
        self.block_size = int(kv_block_size)
        self.num_blocks = int(kv_num_blocks) if kv_num_blocks else 0
        self._check_geometry()
        self._cache: Optional[smodel.Cache] = None  # made at compile()
        self._tables: Optional[np.ndarray] = None   # host [slots, mb] int32
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        self._compiled = False
        self.compile_stats: Dict[str, float] = {}
        # device-call counters (drained into /v1/stats)
        self.decode_steps = 0
        self.prefills = 0
        self.block_copies = 0
        self.attention_launches = 0  # kernel launches made by decode()

    # -- paged geometry ------------------------------------------------

    def _check_geometry(self) -> None:
        if self.max_seq_len % self.block_size != 0:
            raise ValueError(
                f"kv_block_size {self.block_size} must divide max_seq_len "
                f"{self.max_seq_len}")
        if not self.num_blocks:
            self.num_blocks = self.slots * (
                self.max_seq_len // self.block_size)

    def adapter_index(self, name: Optional[str]) -> int:
        """Only the base model is served ('' / None / 'base' -> 0); any
        other `model:` name raises ValueError (an HTTP 400), never a silent
        base-model answer. Adapters are not ported yet (ROADMAP.md)."""
        if not name or name == "base":
            return 0
        raise ValueError(f"unknown adapter {name!r}; resident: (none)")

    @property
    def max_blocks_per_seq(self) -> int:
        return self.max_seq_len // self.block_size

    @property
    def trash_block(self) -> int:
        """Pool index of the write sink for padded/inactive lanes."""
        return self.num_blocks

    def set_block_geometry(self, block_size: int, num_blocks: int) -> None:
        """Sync the device pool to an external BlockManager's geometry
        (the batcher calls this before compile)."""
        if self._compiled and (block_size != self.block_size
                               or num_blocks != self.num_blocks):
            raise RuntimeError(
                "engine already compiled with block geometry "
                f"{self.num_blocks}x{self.block_size}; cannot switch to "
                f"{num_blocks}x{block_size}")
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self._check_geometry()

    def cache_hbm_bytes(self) -> int:
        """Device bytes the KV pool occupies (the admission budget's
        anchor)."""
        return smodel.paged_cache_bytes(
            self.cfg, self.num_blocks + 1, self.block_size)

    # -- warm-up -------------------------------------------------------

    def compile(self) -> Dict[str, float]:
        """Allocate the pool, build the kernel, and warm decode and every
        prefill bucket once (their writes land in the trash block), so no
        request pays a build or a first-call cost."""
        t_all = time.monotonic()
        if self._cache is None:
            self._cache = smodel.init_paged_cache(
                self.cfg, self.num_blocks + 1, self.block_size,
                device=self.device)
            self._tables = np.full(
                (self.slots, self.max_blocks_per_seq), self.trash_block,
                np.int32)
        if self.attention_impl == "kernel" and self.device.type == "cuda":
            t0 = time.monotonic()
            _build.load("paged_attention")
            self.compile_stats["kernel_build_s"] = round(
                time.monotonic() - t0, 3)
        self._compiled = True
        t0 = time.monotonic()
        zeros = np.zeros((self.slots,), np.int32)
        self._decode_logits(zeros, zeros)
        self._sync()
        self.compile_stats["decode_s"] = round(time.monotonic() - t0, 3)
        trash_table = np.full((self.max_blocks_per_seq,), self.trash_block,
                              np.int32)
        for bucket in self.prefill_buckets:
            t0 = time.monotonic()
            self._prefill_logits(np.zeros((bucket,), np.int32), 0, 0,
                                 trash_table)
            self._sync()
            self.compile_stats[f"prefill_{bucket}_s"] = round(
                time.monotonic() - t0, 3)
        self.compile_stats["total_s"] = round(time.monotonic() - t_all, 3)
        logger.info("serving engine warmed: %s", self.compile_stats)
        return dict(self.compile_stats)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def bucket_for(self, length: int) -> Optional[int]:
        """Smallest prefill bucket covering `length`; None when the prompt
        exceeds every bucket (reject at admission)."""
        for b in self.prefill_buckets:
            if length <= b:
                return b
        return None

    # -- device calls (batcher thread only) ----------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill_logits(self, padded: np.ndarray, s_len: int,
                        cached_len: int, table: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            _, logits = smodel.paged_prefill(
                self.params, self._cache, self._to_device(padded), s_len,
                cached_len, self._to_device(table), self.cfg)
        return logits

    def _decode_logits(self, tokens: np.ndarray,
                       positions: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            _, logits = smodel.paged_decode_step(
                self.params, self._cache, self._to_device(tokens),
                self._to_device(positions), self._to_device(self._tables),
                self.cfg, attention_impl=self.attention_impl)
        return logits

    def _default_table(self, slot: int, n_blocks: int) -> list:
        """Static per-slot partition for direct engine use (no external
        BlockManager): slot i owns pool blocks [i*mb, (i+1)*mb)."""
        mb = self.max_blocks_per_seq
        if (slot + 1) * mb > self.num_blocks:
            raise ValueError(
                f"pool of {self.num_blocks} blocks cannot statically "
                f"partition slot {slot}; pass an explicit block_table")
        return list(range(slot * mb, slot * mb + n_blocks))

    def copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write device copy: pool block `src` -> `dst` across all
        layers (both K and V)."""
        if not self._compiled:
            self.compile()
        smodel.copy_paged_block(self._cache, int(dst), int(src))
        self.block_copies += 1

    def prefill_request(self, slot: int, tokens: np.ndarray,
                        temperature: float = 0.0,
                        block_table: Optional[Sequence[int]] = None,
                        cached_len: int = 0, adapter: int = 0) -> int:
        """Prefill `tokens` into the slot's blocks; returns the first
        generated token. The bucket is chosen by the NOVEL length: with
        `cached_len > 0` (prefix-cache hit) only `tokens[cached_len:]` runs
        through the model."""
        if not self._compiled:
            self.compile()
        if adapter:
            raise ValueError("engine has no adapters resident")
        length = int(tokens.shape[0])
        if not 0 <= cached_len < length:
            raise ValueError(
                f"cached_len {cached_len} must leave >= 1 novel token "
                f"of the {length}-token prompt")
        mb = self.max_blocks_per_seq
        if block_table is None:
            block_table = self._default_table(slot, mb)
        table = np.full((mb,), self.trash_block, np.int32)
        table[:min(len(block_table), mb)] = list(block_table)[:mb]
        suffix = np.asarray(tokens, np.int32)[cached_len:]
        s_len = int(suffix.shape[0])
        bucket = self.bucket_for(s_len)
        if bucket is None:
            raise ValueError(
                f"suffix length {s_len} exceeds the largest prefill "
                f"bucket ({self.prefill_buckets[-1]})")
        padded = np.zeros((bucket,), np.int32)
        padded[:s_len] = suffix
        logits = self._prefill_logits(padded, s_len, cached_len, table)
        self._tables[slot] = table
        self.prefills += 1
        temps = torch.tensor([temperature], dtype=torch.float32,
                             device=self.device)
        tok = smodel.sample(logits[None], temps, self._generator)
        return int(tok[0])

    def release_slot(self, slot: int) -> None:
        """Point a retired slot's table at the trash block so later decode
        steps can never touch its (possibly reallocated) blocks."""
        if self._tables is not None:
            self._tables[slot] = self.trash_block

    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               temperatures: np.ndarray) -> np.ndarray:
        """One decode step for all slots -> sampled next tokens [slots]."""
        if not self._compiled:
            self.compile()
        launches0 = paged_attention_cuda.launches
        logits = self._decode_logits(np.asarray(tokens, np.int32),
                                     np.asarray(positions, np.int32))
        self.attention_launches += paged_attention_cuda.launches - launches0
        temps = self._to_device(np.asarray(temperatures, np.float32))
        toks = smodel.sample(logits, temps, self._generator)
        self.decode_steps += 1
        return toks.cpu().numpy()

    def stats(self) -> Dict[str, Any]:
        return {
            "slots": self.slots,
            "device": str(self.device),
            "max_seq_len": self.max_seq_len,
            "prefill_buckets": list(self.prefill_buckets),
            "attention_impl": self.attention_impl,
            "kv_layout": "paged",
            "kv_block_size": self.block_size,
            "kv_num_blocks": self.num_blocks,
            "cache_hbm_bytes": self.cache_hbm_bytes(),
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "block_copies": self.block_copies,
            "attention_launches": self.attention_launches,
            "attention_reference_calls": paged_attention_reference.calls,
            "compile": dict(self.compile_stats),
        }
