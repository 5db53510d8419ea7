"""ServingEngine — params -> prefill/decode captured once as CUDA graphs.

Counterpart of determined_tpu/serve/engine.py. Owns everything device-side
for one serve replica:

  - the params, moved to the device once and cast once to `cfg.dtype`
    (all but the fp32 LayerNorm parameters; the cast is deterministic, so
    casting at load equals casting at every use);
  - with adapters resident, the stack `[A+1, V, D]` of tied embedding /
    LM-head tables (index 0 = the base's) and each slot's index into it;
  - the KV cache: the paged pool `[L, num_blocks + 1, block_size, H, Dh]`
    (the last block is the trash block) and the per-slot block tables the
    batcher hands in at prefill, or with `attention_impl: dense` one lane
    `[L, slots, max_seq_len, H, Dh]` a slot;
  - a `torch.Generator` on the device, seeded from `serving.seed`, for
    temperature sampling.

`compile()` is the counterpart of the JAX engine's AOT compile, which
compiles decode, every prefill bucket and the block copy before the first
request is admitted, so no request pays a trace. On a CUDA device it

  1. builds the kernels, or with a compile farm (`engine.farm`, a
     `FarmClient` scoped to the serving signature: serve/task.py) fetches
     the paged kernel's library from the node's AOT directory or the
     master and builds it with nvcc only where none exists; a fresh build
     is saved into the node's AOT directory and uploaded in the
     background (docs/compile-farm-torch.md), and `kernel_build_s` reads
     0.0 on a hit;
  2. allocates the static inputs of each function: one int32 device buffer
     a function (tokens, positions, tables, lengths, adapter indices,
     temperatures as views into it) and a pinned host twin;
  3. warms each function once on a side stream;
  4. captures one `torch.cuda.CUDAGraph` for decode, one a prefill bucket
     (the largest first, so the shared pool is sized once) and one for the
     block copy, all in one memory pool (`torch.cuda.graph_pool_handle()`),
     and replays each once (its first launch uploads it to the device).
     The warm-up, the capture and that replay run on the inputs `_declare`
     leaves: paged writes land in the trash block.

Every later call writes its numpy inputs into the pinned buffer, copies it
to the device in one copy and replays the graph; decode and prefill end, as
before, in one device-to-host copy of the sampled tokens. After capture
nothing that a graph reads is reallocated: the params, the cache, the
adapter stack and the input buffers keep their addresses (the block
geometry is frozen at compile). A capture or a replay that fails raises:
there is no eager path on CUDA. On the CPU (`device="cpu"`, as the tests
ask) there are no graphs, and the same functions run eagerly on the same
input buffers.

Sampling stays outside the graphs, as the JAX engine compiles `sample` as
an executable of its own: it draws from the engine's generator, whose
state a replayed graph would not advance. `compile()` runs it once at
each of its shapes (`sample_s`), from a scratch generator.

The decode graph holds the paged kernel's launches (one a layer): each
replay adds that count to `attention_launches`, since the wrapper's
counter sees the kernel only while the graph is captured.

The engine is single-consumer: only the batcher thread calls prefill,
decode and copy_block, so graphs that share the pool never replay at the
same time; stats reads are plain counters.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.core._checkpoint import CorruptCheckpoint
from determined_tpu_torch.models.gpt2 import Config
from determined_tpu_torch.ops import _build
from determined_tpu_torch.ops.paged_attention import (
    paged_attention_cuda, paged_attention_reference)
from determined_tpu_torch.serve import model as smodel

logger = logging.getLogger("determined_tpu_torch.serve")

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024)


def default_buckets(max_seq: int) -> List[int]:
    out = [b for b in DEFAULT_BUCKETS if b < max_seq]
    return out + [max_seq]


def load_checkpoint_params(checkpoint_ctx, storage_id: str) -> Dict[str, Any]:
    """Verified params from a COMPLETED checkpoint (lineage fallback).

    `checkpoint_ctx` is a core CheckpointContext; `storage_id` may be
    "latest" (the newest COMPLETED checkpoint of its lineage). Each
    candidate is verified against its manifest before a byte of it is
    used; a corrupt or missing one falls back through the COMPLETED
    lineage, and an explicit id that fails extends its candidates with the
    lineage behind it. Serving a half-written model would be worse than
    refusing to start."""
    if storage_id == "latest":
        candidates = checkpoint_ctx.lineage()
        if not candidates:
            raise FileNotFoundError(
                "serving.checkpoint=latest but the lineage has no "
                "COMPLETED checkpoint")
    else:
        candidates = [storage_id]
    last_err: Optional[Exception] = None
    for i, sid in enumerate(candidates):
        try:
            params = checkpoint_ctx.restore_params(sid)
            logger.info("serving params restored from checkpoint %s", sid)
            return params
        except (FileNotFoundError, CorruptCheckpoint) as e:
            last_err = e
            logger.warning("checkpoint %s unusable (%s); %s", sid, e,
                           "walking lineage back" if i + 1 < len(candidates)
                           else "lineage exhausted")
            if storage_id != "latest" and i == 0:
                candidates.extend(
                    c for c in checkpoint_ctx.lineage() if c != sid)
    raise last_err if last_err is not None else FileNotFoundError(storage_id)


def resolve_attention_impl(impl: str, device: torch.device) -> str:
    """serving.attention_impl -> "kernel" | "reference" | "dense".

    "auto" is the CUDA kernel on a CUDA device and the plain version on the
    CPU (both paged); "kernel" (config spelling "pallas" accepted) forces
    the kernel and raises at the first decode on the CPU; "reference" is
    the explicit A/B switch to the plain version; "dense" keeps the
    slot-dense lane layout (plain attention, no prefix cache)."""
    if impl == "auto":
        return "kernel" if device.type == "cuda" else "reference"
    if impl in ("kernel", "pallas"):
        return "kernel"
    if impl in ("reference", "dense"):
        return impl
    raise ValueError(
        f"unknown serving.attention_impl {impl!r}; valid: auto, kernel "
        "(or pallas), reference, dense")


def _as_tensor(a: Any) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, copy=True))


def _cast_params(params: Dict[str, Any], cfg: Config,
                 device: torch.device) -> Dict[str, Any]:
    """Move to `device`; cast everything but the LayerNorm params and the
    MoE router (used in fp32, ops/moe.py) to cfg.dtype."""
    def cast(tree, keep_dtype):
        if isinstance(tree, dict):
            return {k: cast(v, keep_dtype or k.startswith("ln")
                            or k == "router")
                    for k, v in tree.items()}
        t = _as_tensor(tree).to(device)
        return t if keep_dtype else t.to(cfg.dtype)
    return cast(params, False)


class _Inputs:
    """The inputs of one captured function: int32 or float32 views into one
    int32 device buffer, loaded with one host-to-device copy a call from a
    pinned host twin (pageable memory on the CPU).

    `fields` maps a name to (shape, dtype); `host[name]` is the numpy view
    a call writes, `dev[name]` the tensor the function reads."""

    def __init__(self, fields: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 device: torch.device):
        total = sum(math.prod(shape) for shape, _ in fields.values())
        cuda = device.type == "cuda"
        self.device_buf = torch.zeros(total, dtype=torch.int32, device=device)
        self.host_buf = torch.zeros(total, dtype=torch.int32, pin_memory=cuda)
        host_np = self.host_buf.numpy()
        self.dev: Dict[str, torch.Tensor] = {}
        self.host: Dict[str, np.ndarray] = {}
        off = 0
        for name, (shape, dtype) in fields.items():
            n = math.prod(shape)
            d, h = self.device_buf[off:off + n], host_np[off:off + n]
            if dtype == torch.float32:  # the same 4 bytes, read as floats
                d, h = d.view(torch.float32), h.view(np.float32)
            self.dev[name] = d.view(shape)
            self.host[name] = h.reshape(shape)
            off += n
        # Recorded after each copy: the next load waits for it before it
        # writes the host buffer that copy reads.
        self._copied = torch.cuda.Event() if cuda else None

    def load(self, **values: Any) -> None:
        if self._copied is not None:
            self._copied.synchronize()
        for name, v in values.items():
            self.host[name][...] = v
        self.device_buf.copy_(self.host_buf, non_blocking=True)
        if self._copied is not None:
            self._copied.record()


class ServingEngine:
    """Prefill/decode over a fixed slot batch and a KV cache, captured as
    CUDA graphs on a CUDA device.

    Paged calls take the slot's block table canonicalised to the full
    `max_seq_len // block_size` length (unused entries point at the trash
    block), as the JAX engine's executables do, so one decode graph and one
    prefill graph a bucket cover every table.
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
        adapters: Optional[Dict[str, Any]] = None,
        device=None,
    ):
        if slots <= 0:
            raise ValueError("slots must be positive")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.max_seq_len = min(max_seq_len, cfg.n_positions)
        self.prefill_buckets = sorted(set(
            min(b, self.max_seq_len)
            for b in (prefill_buckets or default_buckets(self.max_seq_len))))
        self.params = _cast_params(params, cfg, self.device)
        # Multi-adapter serving: adapter name -> params tree of a head-tuned
        # fine-tune. Only its (tied) embedding/LM-head table is used: the
        # stack [A+1, V, D] (index 0 = base) is an input of every graph and
        # a per-slot index picks each lane's table, so routing changes
        # operands, never graphs. The transformer body stays the base's; an
        # adapter whose body drifted would be served the base body, so
        # anything but an exact wte-shape match is refused.
        self.adapter_ids: Dict[str, int] = {"base": 0}
        self._adapter_stack: Optional[torch.Tensor] = None
        self._slot_adapters: Optional[np.ndarray] = None
        if adapters:
            base_wte = self.params["wte"]
            tables = [base_wte]
            for name, tree in adapters.items():
                wte = tree.get("wte") if isinstance(tree, dict) else None
                if wte is None:
                    raise ValueError(
                        f"adapter {name!r}: checkpoint has no 'wte' table")
                if tuple(wte.shape) != tuple(base_wte.shape):
                    raise ValueError(
                        f"adapter {name!r}: wte shape {tuple(wte.shape)} "
                        f"!= base {tuple(base_wte.shape)} — adapters must "
                        "share the base model's geometry")
                self.adapter_ids[name] = len(tables)
                tables.append(_as_tensor(wte).to(self.device, base_wte.dtype))
            self._adapter_stack = torch.stack(tables)
            self._slot_adapters = np.zeros((slots,), np.int32)
        self.attention_impl = resolve_attention_impl(attention_impl,
                                                     self.device)
        self.paged = self.attention_impl != "dense"
        self.block_size = int(kv_block_size)
        self.num_blocks = int(kv_num_blocks) if kv_num_blocks else 0
        self._check_geometry()
        self._cache: Optional[smodel.Cache] = None  # made at compile()
        self._tables: Optional[np.ndarray] = None   # host [slots, mb], paged
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        self._compiled = False
        self._inputs: Dict[str, _Inputs] = {}
        # name -> (graph, output, paged-kernel launches the graph holds);
        # None on the CPU, where the functions run eagerly.
        self._graphs: Optional[Dict[str, Tuple[Any, Any, int]]] = None
        self._functions: Dict[str, Callable[[], Any]] = {}
        self.compile_stats: Dict[str, Any] = {}
        # Compile farm client (serve/task.py's `serving.warm_aot`), or None.
        self.farm = None
        # device-call counters (drained into /v1/stats)
        self.decode_steps = 0
        self.prefills = 0
        self.block_copies = 0
        self.attention_launches = 0  # kernel launches made by decode()

    # -- geometry ------------------------------------------------------

    def _check_geometry(self) -> None:
        if not self.paged:
            return
        if self.max_seq_len % self.block_size != 0:
            raise ValueError(
                f"kv_block_size {self.block_size} must divide max_seq_len "
                f"{self.max_seq_len}")
        if not self.num_blocks:
            self.num_blocks = self.slots * (
                self.max_seq_len // self.block_size)

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
        if not self.paged:
            return
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
        """Device bytes the KV cache occupies (the admission budget's
        anchor)."""
        if self.paged:
            return smodel.paged_cache_bytes(
                self.cfg, self.num_blocks + 1, self.block_size)
        return smodel.cache_bytes(self.cfg, self.slots, self.max_seq_len)

    # -- adapters ------------------------------------------------------

    @property
    def has_adapters(self) -> bool:
        return self._adapter_stack is not None

    @property
    def adapter_names(self) -> List[str]:
        return [n for n in self.adapter_ids if n != "base"]

    def adapter_index(self, name: Optional[str]) -> int:
        """Stack index for a per-request `model:` name; '' / None / 'base'
        = the base model. Unknown names raise ValueError (an HTTP 400),
        never a silent base-model answer."""
        if not name or name == "base":
            return 0
        idx = self.adapter_ids.get(name)
        if idx is None:
            raise ValueError(
                f"unknown adapter {name!r}; resident: "
                f"{self.adapter_names or '(none)'}")
        return idx

    def set_slot_adapter(self, slot: int, adapter: int) -> None:
        if self._slot_adapters is not None:
            self._slot_adapters[slot] = adapter

    # -- compile: static inputs, warm-up, capture ----------------------

    def _declare(self) -> None:
        """The static inputs of every function and the function itself,
        in capture order: the prefill buckets from the largest down, then
        decode, then the block copy (paged)."""
        i32, f32 = torch.int32, torch.float32
        cfg, slots, mb = self.cfg, self.slots, self.max_blocks_per_seq
        stack = self._adapter_stack
        adapter = ({"adapter": ((), i32)} if stack is not None else {})

        def add(name, fields, fn):
            self._inputs[name] = _Inputs(fields, self.device)
            self._functions[name] = fn

        for bucket in sorted(self.prefill_buckets, reverse=True):
            if self.paged:
                fields = {"tokens": ((bucket,), i32), "suffix_len": ((), i32),
                          "prefix_len": ((), i32), "table": ((mb,), i32)}
            else:
                fields = {"tokens": ((bucket,), i32), "length": ((), i32),
                          "slot": ((), i32)}
            fields.update(adapter, temp=((), f32))
            name = f"prefill_{bucket}"

            def prefill(name=name):
                d = self._inputs[name].dev
                if self.paged:
                    return smodel.paged_prefill(
                        self.params, self._cache, d["tokens"],
                        d["suffix_len"], d["prefix_len"], d["table"], cfg,
                        adapters=stack, slot_adapter=d.get("adapter"))[1]
                return smodel.prefill(
                    self.params, self._cache, d["tokens"], d["length"],
                    d["slot"], cfg, adapters=stack,
                    slot_adapter=d.get("adapter"))[1]
            add(name, fields, prefill)

        fields = {"tokens": ((slots,), i32), "positions": ((slots,), i32),
                  "temps": ((slots,), f32)}
        if self.paged:
            fields["tables"] = ((slots, mb), i32)
        if stack is not None:
            fields["adapter"] = ((slots,), i32)

        def decode():
            d = self._inputs["decode"].dev
            if self.paged:
                return smodel.paged_decode_step(
                    self.params, self._cache, d["tokens"], d["positions"],
                    d["tables"], cfg, attention_impl=self.attention_impl,
                    adapters=stack, slot_adapters=d.get("adapter"))[1]
            return smodel.decode_step(
                self.params, self._cache, d["tokens"], d["positions"], cfg,
                adapters=stack, slot_adapters=d.get("adapter"))[1]
        add("decode", fields, decode)

        if self.paged:
            def copy_block():
                d = self._inputs["copy_block"].dev
                smodel.copy_paged_block(self._cache, d["dst"], d["src"])
            add("copy_block", {"dst": ((), i32), "src": ((), i32)},
                copy_block)

        # Warm-up and capture run on these inputs: every paged write lands
        # in the trash block (tables all trash, suffix length 0, inactive
        # slots at position 0); the dense warm-up writes lanes no request
        # holds yet.
        trash = self.trash_block
        for name, inp in self._inputs.items():
            for key in ("table", "tables", "dst", "src"):
                if key in inp.host:
                    inp.host[key][...] = trash
            inp.load()

    def _capture(self, name: str, pool) -> None:
        """Warm `name` once on a side stream, capture it into a graph in
        the shared pool, counting the paged-kernel launches it holds, and
        replay it once: a graph's first launch uploads it to the device,
        which no request should pay for."""
        fn = self._functions[name]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.inference_mode():
            fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        launches0 = paged_attention_cuda.launches
        with torch.inference_mode(), torch.cuda.graph(graph, pool=pool):
            out = fn()
        self._graphs[name] = (graph, out,
                              paged_attention_cuda.launches - launches0)
        graph.replay()

    def compile(self, farm=None) -> Dict[str, Any]:
        """Allocate the cache and the static inputs, build the kernels
        (through `farm`, default `self.farm`), and capture decode, every
        prefill bucket and the block copy as CUDA graphs (on the CPU: run
        each once). A second call returns the first one's stats: the
        graphs are captured once."""
        if self._compiled:
            return dict(self.compile_stats)
        t_all = time.monotonic()
        cfg = self.cfg
        if self.paged:
            self._cache = smodel.init_paged_cache(
                cfg, self.num_blocks + 1, self.block_size, device=self.device)
            self._tables = np.full((self.slots, self.max_blocks_per_seq),
                                   self.trash_block, np.int32)
        else:
            self._cache = smodel.init_cache(cfg, self.slots, self.max_seq_len,
                                            device=self.device)
        cuda = self.device.type == "cuda"
        if self.attention_impl == "kernel" and cuda:
            farm = farm if farm is not None else self.farm
            _build.load("paged_attention", farm=farm)
            self.compile_stats["kernel_build_s"] = round(
                _build.build_seconds["paged_attention"], 3)
            self.compile_stats["kernel_source"] = \
                _build.sources["paged_attention"]
            if farm is not None and \
                    _build.sources["paged_attention"] == "nvcc":
                # The next replica on this node finds it without the
                # master; _build has queued the upload.
                farm.save_local(_build.artifacts("paged_attention"))
        self._declare()
        pool = None
        if cuda:
            self._graphs = {}
            pool = torch.cuda.graph_pool_handle()
        for name, fn in self._functions.items():
            t0 = time.monotonic()
            if cuda:
                self._capture(name, pool)
            else:
                with torch.inference_mode():
                    fn()
            self.compile_stats[f"{name}_s"] = round(time.monotonic() - t0, 3)
        # The sampler runs outside the graphs: run it once at both shapes
        # it is called with (decode [slots, V], prefill [1, V]), so no
        # request pays its first use. A scratch generator leaves the
        # engine's stream of draws untouched.
        t0 = time.monotonic()
        scratch = torch.Generator(device=self.device).manual_seed(0)
        for rows in (self.slots, 1):
            smodel.sample(
                torch.zeros((rows, cfg.vocab_size), dtype=torch.float32,
                            device=self.device),
                torch.ones((rows,), dtype=torch.float32, device=self.device),
                scratch)
        self.compile_stats["sample_s"] = round(time.monotonic() - t0, 3)
        if cuda:
            torch.cuda.synchronize(self.device)
        self._compiled = True
        self.compile_stats["total_s"] = round(time.monotonic() - t_all, 3)
        logger.info("serving engine %s: %s",
                    "captured" if cuda else "warmed", self.compile_stats)
        return dict(self.compile_stats)

    def _run(self, name: str) -> Tuple[Any, int]:
        """Replay `name`'s graph (CUDA) or run its function (CPU) on the
        loaded inputs -> (output, paged-kernel launches it made)."""
        if self._graphs is None:
            launches0 = paged_attention_cuda.launches
            with torch.inference_mode():
                out = self._functions[name]()
            return out, paged_attention_cuda.launches - launches0
        graph, out, launches = self._graphs[name]
        graph.replay()
        return out, launches

    def bucket_for(self, length: int) -> Optional[int]:
        """Smallest prefill bucket covering `length`; None when the prompt
        exceeds every bucket (reject at admission)."""
        for b in self.prefill_buckets:
            if length <= b:
                return b
        return None

    # -- device calls (batcher thread only) ----------------------------

    def decode_logits(self, tokens: np.ndarray, positions: np.ndarray,
                      temperatures: Any = 0.0) -> torch.Tensor:
        """`decode` up to the sampler: load one step's inputs and run it ->
        logits [slots, V] fp32. On CUDA this is the decode graph's output
        buffer, which the next replay overwrites."""
        if not self._compiled:
            self.compile()
        fields = {"tokens": tokens, "positions": positions,
                  "temps": temperatures}
        if self.paged:
            fields["tables"] = self._tables
        if self.has_adapters:
            fields["adapter"] = self._slot_adapters
        self._inputs["decode"].load(**fields)
        logits, launches = self._run("decode")
        self.attention_launches += launches
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
        if not self.paged:
            raise RuntimeError("copy_block requires the paged cache")
        if not self._compiled:
            self.compile()
        self._inputs["copy_block"].load(dst=dst, src=src)
        self._run("copy_block")
        self.block_copies += 1

    def prefill_request(self, slot: int, tokens: np.ndarray,
                        temperature: float = 0.0,
                        block_table: Optional[Sequence[int]] = None,
                        cached_len: int = 0, adapter: int = 0) -> int:
        """Prefill `tokens` into the slot's cache; returns the first
        generated token. Paged: the bucket is chosen by the NOVEL length,
        so with `cached_len > 0` (prefix-cache hit) only
        `tokens[cached_len:]` runs through the model. `adapter` selects the
        slot's table from the adapter stack (0 = base); the slot keeps it
        for every decode step until release."""
        logits = self.prefill_logits(slot, tokens, temperature, block_table,
                                     cached_len, adapter)
        self.prefills += 1
        bucket = self.bucket_for(int(tokens.shape[0]) - cached_len)
        temp = self._inputs[f"prefill_{bucket}"].dev["temp"].reshape(1)
        tok = smodel.sample(logits[None], temp, self._generator)
        return int(tok[0])

    def prefill_logits(self, slot: int, tokens: np.ndarray,
                       temperature: float = 0.0,
                       block_table: Optional[Sequence[int]] = None,
                       cached_len: int = 0, adapter: int = 0) -> torch.Tensor:
        """`prefill_request` up to the sampler -> the next-token logits
        [V] fp32 (on CUDA the bucket graph's output buffer, which the next
        replay overwrites)."""
        if not self._compiled:
            self.compile()
        if adapter and not self.has_adapters:
            raise ValueError("engine has no adapters resident")
        length = int(tokens.shape[0])
        if self.paged:
            if not 0 <= cached_len < length:
                raise ValueError(
                    f"cached_len {cached_len} must leave >= 1 novel token "
                    f"of the {length}-token prompt")
            mb = self.max_blocks_per_seq
            if block_table is None:
                block_table = self._default_table(slot, mb)
            table = np.full((mb,), self.trash_block, np.int32)
            table[:min(len(block_table), mb)] = list(block_table)[:mb]
        elif cached_len:
            raise ValueError("prefix caching requires the paged cache layout")
        suffix = np.asarray(tokens, np.int32)[cached_len:]
        s_len = int(suffix.shape[0])
        bucket = self.bucket_for(s_len)
        if bucket is None:
            raise ValueError(
                f"{'suffix' if self.paged else 'prompt'} length {s_len} "
                f"exceeds the largest prefill bucket "
                f"({self.prefill_buckets[-1]})")
        padded = np.zeros((bucket,), np.int32)
        padded[:s_len] = suffix
        fields: Dict[str, Any] = {"tokens": padded, "temp": temperature}
        if self.paged:
            fields.update(suffix_len=s_len, prefix_len=cached_len,
                          table=table)
        else:
            fields.update(length=s_len, slot=slot)
        if self.has_adapters:
            fields["adapter"] = adapter
        self.set_slot_adapter(slot, adapter)
        self._inputs[f"prefill_{bucket}"].load(**fields)
        logits = self._run(f"prefill_{bucket}")[0]
        if self.paged:
            self._tables[slot] = table
        return logits

    def release_slot(self, slot: int) -> None:
        """Point a retired slot's table at the trash block so later decode
        steps can never touch its (possibly reallocated) blocks, and hand
        the lane's adapter back to base."""
        if self._tables is not None:
            self._tables[slot] = self.trash_block
        self.set_slot_adapter(slot, 0)

    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               temperatures: np.ndarray) -> np.ndarray:
        """One decode step for all slots -> sampled next tokens [slots].

        Paged mode feeds the per-slot block tables recorded at prefill
        (they only change at admission/CoW, both of which happen at step
        boundaries in the batcher thread)."""
        logits = self.decode_logits(tokens, positions, temperatures)
        toks = smodel.sample(logits, self._inputs["decode"].dev["temps"],
                             self._generator)
        self.decode_steps += 1
        return toks.cpu().numpy()

    def stats(self) -> Dict[str, Any]:
        return {
            "slots": self.slots,
            "device": str(self.device),
            "adapters": self.adapter_names,
            "max_seq_len": self.max_seq_len,
            "prefill_buckets": list(self.prefill_buckets),
            "attention_impl": self.attention_impl,
            "kv_layout": "paged" if self.paged else "dense",
            "kv_block_size": self.block_size if self.paged else None,
            "kv_num_blocks": self.num_blocks if self.paged else None,
            "cache_hbm_bytes": self.cache_hbm_bytes(),
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "block_copies": self.block_copies,
            "attention_launches": self.attention_launches,
            "attention_reference_calls": paged_attention_reference.calls,
            # Each captured graph and the paged-kernel launches it holds
            # (empty on the CPU: no graphs).
            "cuda_graphs": {name: held for name, (_, _, held)
                            in (self._graphs or {}).items()},
            "compile": dict(self.compile_stats),
        }
