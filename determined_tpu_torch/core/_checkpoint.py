"""CheckpointContext — train-state checkpoints under a two-phase commit,
and file checkpoints.

Counterpart of determined_tpu/core/_checkpoint.py. Checkpoints live where
the trial's `checkpoint_storage` says (storage/: `shared_fs`, `directory`,
`gcs`, `s3`, `azure`). The JAX package writes array shards with orbax;
here the whole state goes through `torch.save` into
`<storage_id>/state/state.pt`, under the same two-phase commit
(core/_integrity.py):

  1. `save_state` snapshots the state, writes `metadata.json` and reports
     the checkpoint PARTIAL. The state file and its manifest are written
     by a background thread (`async_save`, core.init's default) or before
     `save_state` returns;
  2. the next `wait()`, `save_state` or `close()` waits for that write,
     writes the COMMIT marker and reports the checkpoint COMPLETED. A
     write that failed raises there.

On a cloud backend the checkpoint is staged in a local directory: the
background write uploads the staged files and removes them, and phase 2
uploads the manifest (each file's size, from the bucket's listing) and
then the COMMIT marker, as the JAX package commits its remote
checkpoints. `restore_state` downloads the checkpoint and verifies it;
`verify` checks the bucket's listing against the manifest.

The snapshot is what makes the background write safe: the optimizer
updates params and moments in place, so the thread must never read the
live tensors. Each CUDA leaf is copied into a pinned host buffer on a
side stream (the buffers are kept and reused by the next save) and the
compute stream waits on that copy's event before it runs anything more;
CPU leaves are copied into reused buffers at once. At most one save is
pending: `save_state` commits the previous one first.

File checkpoints (`store_path`, `upload`, `download`, `restore_path`,
`delete`, `load_metadata`) follow the JAX package's contract: the chief
writes `metadata.json`, and the report goes out after the storage
context exits (a cloud backend uploads on exit).

Reports go to the master's registry (`POST /api/v1/checkpoints`) in
managed mode, where `lineage()` is the registry's COMPLETED checkpoints
of the trial; without a master they are kept in `local_reported`, and the
lineage is read from them and a scan of the committed `trial{N}-step{M}`
directories of a filesystem storage. Serving restores only the params:
`restore_params`.

In a run of several processes every rank calls `save_state` with the
same step, so every rank names the checkpoint alike without a broadcast
(`trial{N}-step{M}`), and `wait()` ends in a barrier, so no rank reads the
lineage before the COMMIT is stored. A state of plain tensors (the same
on every rank) is written by the chief alone, in the one-process format.
A state with sharded DTensor leaves (train/state.py `checkpoint_view`:
the params and the moments that mirror them) is written per rank, as the
JAX package's hosts each write their own shards:

  <storage_id>/metadata.json        the chief's
  <storage_id>/state/tree.pt        the chief's: the state's structure,
                                    `step`, `extra`, every replicated
                                    tensor, a placeholder per sharded one
  <storage_id>/state/rank{r}.pt     rank r's pieces: of each sharded leaf
                                    the piece it holds, when it is the
                                    lowest rank holding that piece
  <storage_id>/shards.json          the chief's, written at the commit:
                                    each sharded leaf's global shape,
                                    dtype, placements, `sharding.layout_of`
                                    layout (GPT-2's fused qkv in the tensor
                                    layout of the width that wrote it), and
                                    its pieces: offsets, sizes, the rank
                                    that wrote it, the ranks that held it,
                                    the sha256 of its bytes
  <storage_id>/manifest.json, COMMIT over every rank's files

Every rank snapshots and writes its own file (async, staged and uploaded
as above); `wait()` gathers each rank's outcome, file sizes and checksums
and piece checksums to the chief, which writes `shards.json`, the
manifest over all of them and the COMMIT. A restore reads into its
template's layout: a sharded template (a DTensor leaf) reads only the
pieces that overlap its own (`torch.load(mmap=True)`), checks each
piece's sha256 as it reads it, and converts a fused leaf whose layout
differs; a plain template assembles the full tensor. A one-process
checkpoint reads into either. `last_restore_bytes` counts the stored
bytes the newest restore read. `upload(shard=True)` is the
file-checkpoint route where each rank contributes its own files: the
storage id is broadcast from the chief, the gather of each rank's file
list doubles as the barrier, and the chief writes the manifest and COMMIT
over every rank's files and reports them merged.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Union

import torch

from determined_tpu_torch.common import faultpoint
from determined_tpu_torch.common import trace as trace_mod
from determined_tpu_torch.core import _integrity
from determined_tpu_torch.core._integrity import CorruptCheckpoint  # noqa: F401  (re-export)
from determined_tpu_torch.storage.base import (
    SharedFSStorageManager, StorageManager, iter_upload_files)

logger = logging.getLogger("determined_tpu_torch.core")

_STATE_SUBDIR = "state"
_STATE_FILE = "state.pt"
_METADATA_FILE = "metadata.json"
_SHARDS_FILE = "shards.json"
_TREE_FILE = f"{_STATE_SUBDIR}/tree.pt"
_PIECE = "__piece__"  # a sharded tensor's place in tree.pt


def _rank_file(rank: int) -> str:
    return f"{_STATE_SUBDIR}/rank{rank}.pt"

_STATE_ID_RE = re.compile(r"^trial(\d+)-step(\d+)$")


def state_id_step(storage_id: str) -> Optional[int]:
    """Step number encoded in a save_state id (None for other ids)."""
    m = _STATE_ID_RE.match(storage_id)
    return int(m.group(2)) if m else None


def _dir_files(src: str, names: Optional[List[str]]) -> Dict[str, int]:
    """rel path -> size for the files upload() pushed from `src` (the
    storage managers' own walk, storage/base.py)."""
    return {rel: os.path.getsize(p) for p, rel in iter_upload_files(src, names)}


def _map_tensors(tree: Any, fn) -> Any:
    """The same structure with `fn` applied to every tensor; dataclass
    states become dicts of their fields (the saved format)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "__dataclass_fields__"):
        return {"__dataclass__": type(tree).__name__,
                **{f: _map_tensors(getattr(tree, f), fn)
                   for f in tree.__dataclass_fields__}}
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _is_dtensor(t: Any) -> bool:
    return type(t).__name__ == "DTensor"


def _digest(t: torch.Tensor) -> str:
    """sha256 of a host tensor's bytes."""
    data = t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return hashlib.sha256(data).hexdigest()


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _has_shards(tree: Any) -> bool:
    from determined_tpu_torch.parallel import sharding

    found: List[bool] = []
    _map_tensors(tree, lambda t: found.append(
        _is_dtensor(t) and bool(sharding.shard_mesh_dims(t))))
    return any(found)


def _replicated(tree: Any) -> Any:
    """`tree` with each DTensor replaced by its local tensor: the whole
    value of a replicated leaf. A sharded one has no whole value here."""
    from determined_tpu_torch.parallel import sharding

    def leaf(t):
        if not _is_dtensor(t):
            return t
        if sharding.shard_mesh_dims(t):
            raise ValueError("a sharded DTensor in a one-process checkpoint")
        return sharding.local_value(t)

    return _map_tensors(tree, leaf)


def _split(tree: Any, rank: int):
    """(skeleton, owned, index) of a state with sharded DTensor leaves:
    the saved tree with a placeholder per sharded tensor (the replicated
    ones as their local tensors), {key: this rank's piece} of the sharded
    tensors it writes (it is the lowest rank holding that piece), and
    {key: global shape, dtype, placements, layout, pieces} for
    `shards.json`."""
    from determined_tpu_torch.parallel import sharding

    index: Dict[str, Any] = {}
    owned: Dict[str, torch.Tensor] = {}

    def leaf(t):
        if not _is_dtensor(t):
            return t.detach()
        if not sharding.shard_mesh_dims(t):
            return sharding.local_value(t).detach()
        key = str(len(index))
        holders: Dict[tuple, List[int]] = {}
        for r, off, size in sharding.regions(t):
            holders.setdefault((off, size), []).append(r)
        pieces = [{"rank": ranks[0], "holders": ranks, "offsets": list(off),
                   "sizes": list(size)}
                  for (off, size), ranks in holders.items()]
        index[key] = {
            "shape": list(t.shape),
            "dtype": str(t.dtype).replace("torch.", ""),
            "placements": [repr(p) for p in t.placements],
            "layout": [list(x) for x in sharding.layout_of(t)],
            "pieces": pieces}
        if any(p["rank"] == rank for p in pieces):
            owned[key] = sharding.local_value(t).detach()
        return {_PIECE: key}

    return _map_tensors(tree, leaf), owned, index


class _Source:
    """A stored tensor as pieces: its shape, dtype, the fused layout its
    pieces are in, and [(offsets, sizes, fetch, sha256 or None)], `fetch`
    giving the piece as a CPU tensor."""

    def __init__(self, shape, dtype, layout, pieces):
        self.shape, self.dtype = tuple(shape), dtype
        self.layout = tuple(tuple(x) for x in layout)
        self.pieces = pieces


class _Reader:
    """Reads stored tensors into regions of a template's layout, fetching
    only the pieces that overlap. A piece of a sharded checkpoint is
    checked against its sha256 at its first fetch; `bytes` counts what
    was read."""

    def __init__(self, storage_id: str, path: Optional[str] = None,
                 shards: Optional[Dict[str, Any]] = None):
        self._sid, self._path = storage_id, path
        self._leaves = (shards or {}).get("leaves", {})
        self._files: Dict[str, Any] = {}
        self._fetched: Dict[tuple, torch.Tensor] = {}
        self.bytes = 0

    def source(self, loaded: Any) -> _Source:
        if isinstance(loaded, torch.Tensor):
            return _Source(loaded.shape, loaded.dtype, (), [
                ((0,) * loaded.dim(), tuple(loaded.shape),
                 lambda: loaded, None)])
        key = loaded[_PIECE]
        entry = self._leaves.get(key)
        if entry is None:
            raise CorruptCheckpoint(self._sid, f"sharded tensor {key} is not "
                                    f"in {_SHARDS_FILE}")
        pieces = [(tuple(p["offsets"]), tuple(p["sizes"]),
                   (lambda p=p: self._piece(key, p)), p.get("sha256"))
                  for p in entry["pieces"]]
        return _Source(entry["shape"], _dtype(entry["dtype"]),
                       entry["layout"], pieces)

    def _piece(self, key: str, p: Dict[str, Any]) -> torch.Tensor:
        rel = _rank_file(p["rank"])
        if (rel, key) in self._fetched:
            return self._fetched[(rel, key)]
        if rel not in self._files:
            try:
                self._files[rel] = torch.load(
                    os.path.join(self._path, rel), map_location="cpu",
                    mmap=True, weights_only=False)["pieces"]
            except FileNotFoundError:
                raise CorruptCheckpoint(self._sid, f"missing file {rel!r}")
            except Exception as e:
                raise CorruptCheckpoint(self._sid,
                                        f"unreadable {rel!r}: {e}") from e
        t = self._files[rel].get(key)
        if t is None or list(t.shape) != list(p["sizes"]):
            raise CorruptCheckpoint(self._sid,
                                    f"piece {key} of {rel!r} missing or "
                                    "of the wrong shape")
        self.bytes += t.numel() * t.element_size()
        if p.get("sha256") and _digest(t) != p["sha256"]:
            raise CorruptCheckpoint(self._sid,
                                    f"checksum mismatch for piece {key} "
                                    f"of {rel!r}")
        self._fetched[(rel, key)] = t
        return t

    def read(self, src: _Source, offsets, sizes, layout, out: torch.Tensor
             ) -> None:
        """Write the region (offsets, sizes) of `src`, in `layout`, into
        `out`."""
        from determined_tpu_torch.parallel import sharding

        layout = tuple(tuple(x) for x in layout)
        if src.layout != layout:
            # Stored in another tensor layout (another tensor width): the
            # whole tensor, to the one-process layout, to `layout`.
            full = torch.empty(src.shape, dtype=src.dtype)
            self.read(src, (0,) * len(src.shape), src.shape, src.layout,
                      full)
            for dim, pieces, parts in reversed(src.layout):
                full = sharding.from_split_layout(full, dim, pieces, parts)
            for dim, pieces, parts in layout:
                full = sharding.to_split_layout(full, dim, pieces, parts)
            out.copy_(full[tuple(slice(o, o + n)
                                 for o, n in zip(offsets, sizes))])
            return
        for p_off, p_size, fetch, _ in src.pieces:
            lo = [max(a, b) for a, b in zip(p_off, offsets)]
            hi = [min(a + m, b + n) for a, m, b, n
                  in zip(p_off, p_size, offsets, sizes)]
            if any(h <= low for low, h in zip(lo, hi)):
                continue
            piece = fetch()
            src_sl = tuple(slice(a - o, b - o) for a, b, o in zip(lo, hi, p_off))
            dst_sl = tuple(slice(a - o, b - o)
                           for a, b, o in zip(lo, hi, offsets))
            out[dst_sl].copy_(piece[src_sl])


def _fill(template: Any, loaded: Any, reader: _Reader, into: bool) -> Any:
    """`loaded` (a saved tree: tensors, or placeholders of sharded ones)
    in the structure and layout of `template`: each template tensor's
    region of its stored tensor, on its device, with its dtype and
    requires_grad; a DTensor template gets its own piece. `into`: written
    into the template's tensors, which are returned."""
    from determined_tpu_torch.parallel import sharding

    if isinstance(template, torch.Tensor):
        src = reader.source(loaded)
        if tuple(template.shape) != src.shape:
            raise ValueError(f"checkpoint tensor of shape {src.shape} for a "
                             f"state tensor of {tuple(template.shape)}")
        with torch.no_grad():
            if _is_dtensor(template):
                local = sharding.local_value(template)
                mesh = template.device_mesh
                offsets, sizes = sharding.region(
                    template.shape, tuple(mesh.mesh.shape),
                    template.placements, mesh.get_coordinate())
                out = local if into else torch.empty(
                    local.shape, dtype=local.dtype, device=local.device)
                reader.read(src, offsets, sizes, sharding.layout_of(template),
                            out)
                if into:
                    return template
                from torch.distributed.tensor import DTensor

                d = DTensor.from_local(out, mesh, template.placements,
                                       run_check=False, shape=template.shape,
                                       stride=template.stride())
                d.fused_layout = sharding.layout_of(template)
                return d.requires_grad_(template.requires_grad)
            out = template if into else torch.empty(
                template.shape, dtype=template.dtype, device=template.device)
            reader.read(src, (0,) * template.dim(), tuple(template.shape), (),
                        out)
        return out if into else out.requires_grad_(template.requires_grad)
    if hasattr(template, "__dataclass_fields__"):
        return type(template)(**{f: _fill(getattr(template, f), loaded[f],
                                          reader, into)
                                 for f in template.__dataclass_fields__})
    if isinstance(template, dict):
        if set(template) != set(loaded) - {"__dataclass__"}:
            raise ValueError(
                f"checkpoint keys {sorted(loaded)} do not match the state's "
                f"{sorted(template)}")
        return {k: _fill(v, loaded[k], reader, into)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(loaded):
            raise ValueError("checkpoint and state structures differ")
        return type(template)(_fill(t, v, reader, into)
                              for t, v in zip(template, loaded))
    return loaded


def _assemble(loaded: Any, reader: _Reader) -> Any:
    """A saved tree with every sharded tensor whole, in the one-process
    layout (CPU tensors): what a one-process checkpoint holds."""
    if isinstance(loaded, dict) and _PIECE in loaded:
        src = reader.source(loaded)
        full = torch.empty(src.shape, dtype=src.dtype)
        reader.read(src, (0,) * len(src.shape), src.shape, (), full)
        return full
    if isinstance(loaded, dict):
        return {k: _assemble(v, reader) for k, v in loaded.items()}
    if isinstance(loaded, (list, tuple)):
        return type(loaded)(_assemble(v, reader) for v in loaded)
    return loaded


def _abstract(loaded: Any, leaves: Dict[str, Any]) -> Any:
    """A saved tree with each tensor, or placeholder, as a meta tensor of
    its global shape and dtype."""
    if isinstance(loaded, torch.Tensor):
        return torch.empty(loaded.shape, dtype=loaded.dtype, device="meta")
    if isinstance(loaded, dict) and _PIECE in loaded:
        entry = leaves[loaded[_PIECE]]
        return torch.empty(entry["shape"], dtype=_dtype(entry["dtype"]),
                           device="meta")
    if isinstance(loaded, dict):
        return {k: _abstract(v, leaves) for k, v in loaded.items()}
    if isinstance(loaded, (list, tuple)):
        return type(loaded)(_abstract(v, leaves) for v in loaded)
    return loaded


class _Snapshot:
    """Host copies of a state's tensors in buffers kept across saves."""

    def __init__(self):
        self._buffers: List[torch.Tensor] = []
        self._stream = None  # the side CUDA stream, made at first use

    def take(self, state: Any):
        """-> (host tree, CUDA event the copies end with or None). The
        compute stream waits on the event, so the next step cannot write
        a tensor the copy still reads; the caller must let the previous
        snapshot's write finish first (its buffers are reused)."""
        leaves: List[torch.Tensor] = []
        _map_tensors(state, leaves.append)
        cuda = [t for t in leaves if t.is_cuda]
        if cuda and self._stream is None:
            self._stream = torch.cuda.Stream(device=cuda[0].device)
        if cuda:
            self._stream.wait_stream(torch.cuda.current_stream(cuda[0].device))
        it = iter(range(len(leaves)))

        def copy(t: torch.Tensor) -> torch.Tensor:
            buf = self._buffer(next(it), t)
            src = t.detach()
            if t.is_cuda:
                with torch.cuda.stream(self._stream):
                    buf.copy_(src, non_blocking=True)
                src.record_stream(self._stream)
            else:
                buf.copy_(src)
            return buf

        host = _map_tensors(state, copy)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(self._stream)
            torch.cuda.current_stream(cuda[0].device).wait_event(event)
        return host, event

    def _buffer(self, i: int, t: torch.Tensor) -> torch.Tensor:
        if i < len(self._buffers):
            buf = self._buffers[i]
            if buf.shape == t.shape and buf.dtype == t.dtype:
                return buf
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        if i < len(self._buffers):
            self._buffers[i] = buf
        else:
            self._buffers.append(buf)
        return buf


class _Write:
    """One checkpoint's phase-1 write of one rank: its files (each written
    under a temporary name, fsync'd, renamed), on a thread or inline, then
    the manifest (`manifest`: the one-process format's, over the whole
    directory), or this rank's manifest entries and the sha256 of the
    pieces it wrote (`entries`, `digests`: a sharded checkpoint's, merged
    by the chief). Given a cloud `storage`, the staged directory is
    uploaded instead, and removed."""

    def __init__(self, path: str, host: Dict[str, Any], event,
                 background: bool, storage: Optional[StorageManager] = None,
                 storage_id: str = "", sharded: bool = False):
        self.path = path
        self.manifest: Optional[Dict] = None
        self.entries: Dict[str, Dict] = {}
        self.digests: Dict[str, str] = {}
        self.error: Optional[BaseException] = None
        self._host, self._event = host, event
        self._storage, self._storage_id = storage, storage_id
        self._sharded = sharded
        self._thread = None
        if background:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="checkpoint-writer")
            self._thread.start()
        else:
            self._run()

    def _run(self) -> None:
        try:
            if self._event is not None:
                self._event.synchronize()  # the snapshot copies landed
            for rel, tree in self._host.items():
                if self._sharded and "pieces" in tree:
                    self.digests = {k: _digest(t)
                                    for k, t in tree["pieces"].items()}
                target = os.path.join(self.path, rel)
                with open(target + ".tmp", "wb") as f:
                    torch.save(tree, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(target + ".tmp", target)
            if self._storage is not None:
                self._storage.upload(self.path, self._storage_id)
            elif self._sharded:
                self.entries = _integrity.file_entries(self.path,
                                                       list(self._host))
            else:
                self.manifest = _integrity.write_manifest(self.path)
        except BaseException as e:  # raised to the caller of wait()
            self.error = e
        finally:
            self._host = None
            if self._storage is not None:
                shutil.rmtree(self.path, ignore_errors=True)

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()


def _manager(storage: Union[StorageManager, str]) -> StorageManager:
    """A storage manager; a path is a `shared_fs` storage rooted there."""
    if isinstance(storage, StorageManager):
        return storage
    return SharedFSStorageManager(storage)


class CheckpointContext:
    def __init__(self, storage: Union[StorageManager, str], trial_id: int = 0,
                 session=None, allocation_id: Optional[str] = None,
                 async_save: bool = False, distributed=None):
        self._storage = _manager(storage)
        self._dist = distributed
        self._trial_id = trial_id
        self._session = session
        self._allocation_id = allocation_id
        self._async = async_save
        self._snapshot = _Snapshot()
        # (storage_id, metadata, write) of the save whose phase 2 (COMMIT,
        # the COMPLETED report) is pending.
        self._pending: Optional[tuple] = None
        self._pending_sync_ms = 0.0
        # Observed durable-save cost of the newest checkpoint: the part of
        # save_state the loop paid plus the blocking part of the wait that
        # committed it (the Trainer's preemption budget). Under async
        # overlap it underestimates a cold synchronous save; the budget's
        # safety factor covers that.
        self.last_save_ms: Optional[float] = None
        # The stored bytes the newest restore read (`_read`): a sharded
        # restore reads only the pieces its template's layout overlaps.
        self.last_restore_bytes = 0
        self.local_reported: List[Dict[str, Any]] = []
        self.tracer = None  # set by core.init

    def _span(self, name: str, start_us: int, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.emit(name, start_us, trace_mod.now_us(), attrs)

    def _is_chief(self) -> bool:
        return self._dist is None or self._dist.is_chief

    def _shared(self) -> bool:
        return self._dist is not None and self._dist.size > 1

    def _staged(self) -> bool:
        """True for a cloud backend: files reach it from a local staging
        directory."""
        return self._storage.requires_staging

    # -- train-state checkpoints ---------------------------------------

    def save_state(self, state: Any, steps_completed: int,
                   metadata: Optional[Dict[str, Any]] = None) -> str:
        """Snapshot `state` (tensors anywhere) as checkpoint
        `trial{N}-step{steps_completed}`, reported PARTIAL; it is committed
        and reported COMPLETED at the next `wait()`, `save_state` or
        `close()` (before this returns when `async_save` is off). Returns
        the storage id. Several processes: every rank calls it (a
        collective); a state of plain tensors is the chief's to write, a
        state with sharded DTensors every rank's (the module docstring)."""
        self.wait()  # never two pending: the buffers are reused
        # Deterministic id so all ranks agree without a broadcast.
        storage_id = f"trial{self._trial_id}-step{steps_completed}"
        sharded = self._shared() and _has_shards(state)
        if not sharded:
            state = _replicated(state)
        if not sharded and not self._is_chief():
            self._pending = (storage_id, None, None, None)
            if not self._async:
                self.wait()
            return storage_id
        path = self._storage.path_for(storage_id)
        if sharded and self._staged() and not self._is_chief():
            path += f".rank{self._dist.rank}"  # a staging of its own
        if self._staged():  # never upload an older staging's leftovers
            shutil.rmtree(path, ignore_errors=True)
        os.makedirs(os.path.join(path, _STATE_SUBDIR), exist_ok=True)
        md = None
        if self._is_chief():
            md = dict(metadata or {})
            md.update({"steps_completed": steps_completed,
                       "trial_id": self._trial_id,
                       "format": "torch-sharded" if sharded else "torch",
                       "time": time.time()})
            with open(os.path.join(path, _METADATA_FILE), "w") as f:
                json.dump(md, f)
            # Reported before the write starts, so the report lists what
            # the JAX package's lists: the metadata, never the manifest.
            self._report(storage_id, md, state="PARTIAL")
        index = None
        if sharded:
            skeleton, owned, index = _split(state, self._dist.rank)
            files: Dict[str, Any] = {_rank_file(self._dist.rank):
                                     {"pieces": owned}}
            if self._is_chief():
                files[_TREE_FILE] = skeleton
        else:
            files = {f"{_STATE_SUBDIR}/{_STATE_FILE}": state}
        t0 = time.monotonic()
        t0_us = trace_mod.now_us()
        host, event = self._snapshot.take(files)
        write = _Write(path, host, event, background=self._async,
                       storage=self._storage if self._staged() else None,
                       storage_id=storage_id, sharded=sharded)
        self._pending_sync_ms = (time.monotonic() - t0) * 1000.0
        # Phase 1 on the trace: the part of the save the loop paid for.
        self._span("harness.checkpoint.save", t0_us, storage_id=storage_id,
                   steps_completed=steps_completed)
        self._pending = (storage_id, md, write, index)
        if not self._async:
            self.wait()
        return storage_id

    def wait(self) -> None:
        """Block until the pending save is written and committed (COMMIT
        marker stored, COMPLETED reported). Raises the write's error, if
        it failed (a sharded save: any rank's, on every rank); the
        checkpoint then stays PARTIAL. Several processes: every rank calls
        it, and it ends in a barrier."""
        if self._pending is None:
            return
        storage_id, md, write, index = self._pending
        self._pending = None
        if write is None:  # a rank other than the chief
            self._dist.barrier("checkpoint.commit")
            return
        t0 = time.monotonic()
        t0_us = trace_mod.now_us()
        write.join()
        if index is not None:
            self._commit_sharded(storage_id, write, index)
        elif write.error is not None:
            raise RuntimeError(
                f"checkpoint {storage_id}: the state write failed") \
                from write.error
        elif self._staged():
            self._commit_remote(storage_id)
        else:
            _integrity.commit(write.path, storage_id, write.manifest)
        if self._is_chief():
            self._report(storage_id, md, state="COMPLETED")
            self.last_save_ms = self._pending_sync_ms + \
                (time.monotonic() - t0) * 1000.0
            # Phase 2 on the trace: the wait for the write, COMMIT and
            # report.
            self._span("harness.checkpoint.commit", t0_us,
                       storage_id=storage_id)
        if self._shared():
            self._dist.barrier("checkpoint.commit")

    def _commit_sharded(self, storage_id: str, write: _Write,
                        index: Dict[str, Any]) -> None:
        """Phase 2 of a sharded save, on every rank: each rank's outcome,
        manifest entries and piece checksums to every rank (one
        allgather); any failure raises everywhere. The chief writes
        `shards.json`, the manifest over every rank's files and the
        COMMIT."""
        error = None if write.error is None else repr(write.error)
        outcomes = self._dist.allgather((error, write.entries, write.digests))
        failed = [r for r, (e, _, _) in enumerate(outcomes) if e]
        if failed:
            raise RuntimeError(
                f"checkpoint {storage_id}: the state write of rank(s) "
                f"{failed} failed: {outcomes[failed[0]][0]}") from write.error
        if not self._is_chief():
            return
        for key, leaf in index.items():
            for piece in leaf["pieces"]:
                piece["sha256"] = outcomes[piece["rank"]][2][key]
        shards = json.dumps({"version": 1, "world": self._dist.size,
                             "leaves": index}, sort_keys=True)
        if self._staged():
            self._upload_small_files(storage_id, {_SHARDS_FILE: shards})
            self._commit_remote(storage_id)
            return
        path = self._storage.path_for(storage_id)
        _integrity._atomic_write(os.path.join(path, _SHARDS_FILE),
                                 shards.encode())
        files: Dict[str, Dict] = {}
        for _, entries, _ in outcomes:
            files.update(entries)
        files.update(_integrity.file_entries(
            path, [_METADATA_FILE, _SHARDS_FILE]))
        _integrity.commit(path, storage_id,
                          _integrity.write_manifest(path, files))

    def _commit_remote(self, storage_id: str) -> None:
        """Phase 2 on a cloud backend: the manifest (each stored file's
        size, from the bucket's listing: checksums would download every
        file again), then the COMMIT marker, uploaded last."""
        listing = {rel: size
                   for rel, size in self._storage.list_files(storage_id).items()
                   if rel not in (_integrity.MANIFEST_FILE,
                                  _integrity.COMMIT_FILE)}
        manifest = {"version": 1,
                    "files": {rel: {"size": size}
                              for rel, size in sorted(listing.items())}}
        files = {_integrity.MANIFEST_FILE: json.dumps(manifest, sort_keys=True)}
        if faultpoint.fire(_integrity.FAULT_COMMIT_DROP) is \
                faultpoint.Action.NONE:
            files[_integrity.COMMIT_FILE] = json.dumps(
                {"storage_id": storage_id, "n_files": len(listing)})
        self._upload_small_files(storage_id, files)

    def _upload_small_files(self, storage_id: str,
                            files: Dict[str, str]) -> None:
        """Upload name -> content strings into checkpoint `storage_id`, in
        the order given."""
        with tempfile.TemporaryDirectory() as td:
            for name, content in files.items():
                with open(os.path.join(td, name), "w") as f:
                    f.write(content)
            self._storage.upload(td, storage_id, list(files))

    def close(self) -> None:
        self.wait()

    def _state_file(self, path: str, storage_id: str) -> str:
        """The checkpoint's state entry: `shards.json` of a sharded one,
        else `state/state.pt`. FileNotFoundError without either."""
        for rel in (_SHARDS_FILE, os.path.join(_STATE_SUBDIR, _STATE_FILE)):
            state_file = os.path.join(path, rel)
            if os.path.exists(state_file):
                return state_file
        raise FileNotFoundError(f"checkpoint {storage_id} not found at {path}")

    def verify(self, storage_id: str) -> bool:
        """Verify checkpoint `storage_id` without reading its state: True
        when its manifest verified, False for a checkpoint that predates
        the integrity protocol. A cloud backend's listing is held to the
        manifest's sizes. Raises FileNotFoundError when it does not exist
        and CorruptCheckpoint when it fails verification."""
        if self._staged():
            return self._verify_remote(storage_id)
        path = self._storage.path_for(storage_id)
        self._state_file(path, storage_id)
        return _integrity.verify(path, storage_id)

    def _verify_remote(self, storage_id: str) -> bool:
        listing = self._storage.list_files(storage_id)
        if not listing:
            raise FileNotFoundError(f"checkpoint {storage_id} not found")
        manifest = None
        with tempfile.TemporaryDirectory() as td:
            self._storage.download(
                storage_id, td,
                selector=lambda rel: rel == _integrity.MANIFEST_FILE)
            mf = os.path.join(td, _integrity.MANIFEST_FILE)
            if os.path.exists(mf):
                try:
                    with open(mf) as f:
                        manifest = json.load(f)
                except (OSError, ValueError):
                    manifest = None
        return _integrity.verify_listing(listing, manifest, storage_id)

    def _read(self, storage_id: str, fn) -> Any:
        """fn(saved tree, reader) on checkpoint `storage_id`, verified (a
        cloud one once downloaded): the one-process format's tree as
        loaded (mmap), or a sharded one's `tree.pt` with a reader over its
        pieces. Sets `last_restore_bytes`."""
        with self._storage.restore_path(storage_id) as path:
            state_file = self._state_file(path, storage_id)
            if not state_file.endswith(_SHARDS_FILE):
                _integrity.verify(path, storage_id)
                reader = _Reader(storage_id)
                loaded = torch.load(state_file, map_location="cpu",
                                    mmap=True, weights_only=False)
                reader.bytes = os.path.getsize(state_file)
            else:
                # The small files whole; the rank files' pieces are
                # checked as they are read.
                small = [_METADATA_FILE, _SHARDS_FILE, _TREE_FILE]
                _integrity.verify(path, storage_id, checksummed=small)
                try:
                    with open(state_file) as f:
                        shards = json.load(f)
                    loaded = torch.load(os.path.join(path, _TREE_FILE),
                                        map_location="cpu",
                                        weights_only=False)
                except Exception as e:
                    raise CorruptCheckpoint(storage_id, f"unreadable state: "
                                            f"{e}") from e
                reader = _Reader(storage_id, path, shards)
                reader.bytes = sum(os.path.getsize(os.path.join(path, rel))
                                   for rel in small
                                   if os.path.exists(os.path.join(path, rel)))
            out = fn(loaded, reader)
            self.last_restore_bytes = reader.bytes
            return out

    def restore_state(self, storage_id: str, template: Any,
                      into: bool = False) -> Any:
        """Read checkpoint `storage_id` back in the structure, devices,
        dtypes and layout of `template` (e.g. a freshly initialised
        TrainState, or its `checkpoint_view`): a DTensor leaf of the
        template gets this rank's piece, read from the pieces that overlap
        it. `into`: written into the template's own tensors (a template
        made with `torch.empty` for the purpose). Raises as `verify` does."""
        return self._read(storage_id,
                          lambda loaded, reader: _fill(template, loaded,
                                                       reader, into))

    def abstract_state(self, storage_id: str) -> Any:
        """The saved tree of checkpoint `storage_id` with each tensor as a
        meta tensor of its global shape and dtype, read from its structure
        alone (no tensor data): what a template for it is built from.
        Raises FileNotFoundError, or CorruptCheckpoint for a state that
        does not load."""
        with self._storage.restore_path(storage_id) as path:
            state_file = self._state_file(path, storage_id)
            try:
                if not state_file.endswith(_SHARDS_FILE):
                    return _abstract(torch.load(
                        state_file, map_location="cpu", mmap=True,
                        weights_only=False), {})
                with open(state_file) as f:
                    leaves = json.load(f)["leaves"]
                return _abstract(torch.load(
                    os.path.join(path, _TREE_FILE), map_location="cpu",
                    mmap=True, weights_only=False), leaves)
            except Exception as e:
                raise CorruptCheckpoint(storage_id, f"unreadable state: {e}"
                                        ) from e

    def restore_params(self, storage_id: str) -> Any:
        """The `params` subtree of checkpoint `storage_id` (CPU tensors,
        whole and in the one-process layout, whichever format it was
        written in), without a template: what a serve replica restores,
        having no optimizer to build a TrainState from. Raises as `verify`
        does, and ValueError for a checkpoint without params."""
        def params_of(loaded, reader):
            params = loaded.get("params") if isinstance(loaded, dict) \
                else None
            return None if params is None else _assemble(params, reader)

        params = self._read(storage_id, params_of)
        if params is None:
            raise ValueError(
                f"checkpoint {storage_id} has no 'params' subtree — not a "
                "TrainState checkpoint")
        return params

    def lineage(self) -> List[str]:
        """This trial's COMPLETED checkpoints, newest first. Managed mode
        asks the master's registry, which marks a checkpoint COMPLETED only
        on the phase-2 report; without a master (or when the query fails)
        it is read from the in-process reports plus, on a filesystem
        storage, the committed `trial{N}-step{M}` directories (so a
        restarted process sees them)."""
        if self._session is not None:
            try:
                resp = self._session.get(
                    f"/api/v1/trials/{self._trial_id}/checkpoints",
                    params={"state": "COMPLETED"})
                return [c["uuid"] for c in resp.get("checkpoints", [])]
            except Exception:
                logger.warning("lineage query failed; falling back to a "
                               "storage scan", exc_info=True)
        steps: Dict[str, int] = {}
        for rec in self.local_reported:
            if rec.get("state", "COMPLETED") != "COMPLETED":
                continue
            m = _STATE_ID_RE.match(rec["uuid"])
            if m and int(m.group(1)) == self._trial_id:
                steps[rec["uuid"]] = int(m.group(2))
        base = self._storage.base_path
        if not self._staged() and os.path.isdir(base):
            for name in os.listdir(base):
                m = _STATE_ID_RE.match(name)
                if not m or int(m.group(1)) != self._trial_id or \
                        name in steps:
                    continue
                if os.path.exists(os.path.join(
                        base, name, _integrity.COMMIT_FILE)):
                    steps[name] = int(m.group(2))
        return sorted(steps, key=steps.__getitem__, reverse=True)

    # -- file checkpoints ----------------------------------------------

    @contextlib.contextmanager
    def store_path(self, metadata: Optional[Dict[str, Any]] = None
                   ) -> Iterator[tuple]:
        """Chief-only convenience: yield (path, storage_id); report on exit."""
        md = dict(metadata or {})
        with self._storage.store_path() as (storage_id, path):
            yield path, storage_id
            md.setdefault("time", time.time())
            if self._is_chief():
                with open(os.path.join(path, _METADATA_FILE), "w") as f:
                    json.dump(md, f)
        # Report after the storage context exits: a cloud backend uploads
        # on exit, so the report's listing sees the bucket's contents.
        self._report(storage_id, md)

    def upload(self, ckpt_dir: str, metadata: Optional[Dict[str, Any]] = None,
               shard: bool = False, selector=None) -> str:
        """Store the files of directory `ckpt_dir` as a checkpoint (a
        fresh uuid) and return its storage id, committed and reported.

        shard=True: every rank uploads its own files into the same storage
        id (rank-unique file names are the caller's contract); the chief
        draws the id and broadcasts it, each rank's file list is gathered
        to the chief (the gather is also the barrier after every upload),
        and the chief writes the manifest and COMMIT over all of them and
        reports the merged list. Otherwise only the chief uploads."""
        sharded = shard and self._shared()
        storage_id = self._storage.new_storage_id()
        if sharded:
            storage_id = self._dist.broadcast(storage_id)
        names = None
        if selector is not None:
            names = [n for n in os.listdir(ckpt_dir) if selector(n)]
        local_files: Dict[str, int] = {}
        if shard or self._is_chief():
            self._storage.upload(ckpt_dir, storage_id, names)
            local_files = _dir_files(ckpt_dir, names)
        md = dict(metadata or {})
        md.setdefault("time", time.time())
        resources: Optional[Dict[str, int]] = None
        if sharded:
            gathered = self._dist.gather(local_files)
            if gathered is not None:
                resources = {}
                for files in gathered:
                    resources.update(files)
        if self._is_chief():
            if self._staged():
                self._commit_remote(storage_id)
            else:
                path = self._storage.path_for(storage_id)
                os.makedirs(path, exist_ok=True)
                _integrity.commit(path, storage_id,
                                  _integrity.write_manifest(path))
            self._report(storage_id, md, resources=resources)
        return storage_id

    def download(self, storage_id: str, ckpt_dir: str, selector=None) -> None:
        self._storage.download(storage_id, ckpt_dir, selector)

    @contextlib.contextmanager
    def restore_path(self, storage_id: str) -> Iterator[str]:
        with self._storage.restore_path(storage_id) as path:
            yield path

    def delete(self, storage_id: str) -> None:
        if self._is_chief():
            self._storage.delete(storage_id)

    def load_metadata(self, storage_id: str) -> Dict[str, Any]:
        """The checkpoint's `metadata.json` ({} without one), fetched alone:
        restore_path on a cloud backend would download every file."""
        with tempfile.TemporaryDirectory() as td:
            self._storage.download(
                storage_id, td, selector=lambda rel: rel == _METADATA_FILE)
            md_file = os.path.join(td, _METADATA_FILE)
            if os.path.exists(md_file):
                with open(md_file) as f:
                    return json.load(f)
        # No metadata file: tell a checkpoint without metadata from a bad
        # storage id (download() is a no-op for missing ids).
        if not self._storage.list_files(storage_id):
            raise FileNotFoundError(f"checkpoint {storage_id} not found")
        return {}

    # -- master reporting ------------------------------------------------

    def _report(self, storage_id: str, metadata: Dict[str, Any],
                state: str = "COMPLETED",
                resources: Optional[Dict[str, int]] = None) -> None:
        if not self._is_chief():
            return
        record = {
            "uuid": storage_id,
            "trial_id": self._trial_id,
            "allocation_id": self._allocation_id,
            "metadata": metadata,
            "steps_completed": metadata.get("steps_completed", 0),
            "resources": resources or {},
            "state": state,
        }
        if self._session is None:
            # The COMPLETED report replaces the PARTIAL record in place: one
            # record per checkpoint, as the master's registry keeps it.
            for i, rec in enumerate(self.local_reported):
                if rec["uuid"] == storage_id:
                    self.local_reported[i] = record
                    return
            self.local_reported.append(record)
            return
        if resources is None:
            record["resources"] = self._storage.list_files(storage_id)
        # Idempotent: a retried report must not register the checkpoint
        # twice or move the trial's resume pointer again.
        self._session.post("/api/v1/checkpoints", body=record,
                           idempotent=True)
