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
same (full, gathered) state and step, so every rank names the checkpoint
alike without a broadcast (`trial{N}-step{M}`); the chief alone writes,
commits and reports it, and `wait()` ends in a barrier, so no rank reads
the lineage before the COMMIT is stored. `upload(shard=True)` is the
file-checkpoint route where each rank contributes its own files: the
storage id is broadcast from the chief, the gather of each rank's file
list doubles as the barrier, and the chief writes the manifest and COMMIT
over every rank's files and reports them merged.
"""

from __future__ import annotations

import contextlib
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


def _like(template: Any, loaded: Any) -> Any:
    """`loaded` in the structure of `template`: each tensor on the
    template's device with its dtype and requires_grad."""
    if isinstance(template, torch.Tensor):
        out = loaded.to(device=template.device, dtype=template.dtype)
        return out.requires_grad_(template.requires_grad)
    if hasattr(template, "__dataclass_fields__"):
        return type(template)(**{f: _like(getattr(template, f), loaded[f])
                                 for f in template.__dataclass_fields__})
    if isinstance(template, dict):
        if set(template) != set(loaded):
            raise ValueError(
                f"checkpoint keys {sorted(loaded)} do not match the state's "
                f"{sorted(template)}")
        return {k: _like(v, loaded[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(loaded):
            raise ValueError("checkpoint and state structures differ")
        return type(template)(_like(t, v) for t, v in zip(template, loaded))
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
    """One checkpoint's phase-1 write: the state file (written under a
    temporary name, fsync'd, renamed) and its manifest, on a thread or
    inline. Given a cloud `storage`, the staged directory is uploaded
    instead of manifested, and removed."""

    def __init__(self, path: str, host: Any, event, background: bool,
                 storage: Optional[StorageManager] = None,
                 storage_id: str = ""):
        self.path = path
        self.manifest: Optional[Dict] = None
        self.error: Optional[BaseException] = None
        self._host, self._event = host, event
        self._storage, self._storage_id = storage, storage_id
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
            target = os.path.join(self.path, _STATE_SUBDIR, _STATE_FILE)
            with open(target + ".tmp", "wb") as f:
                torch.save(self._host, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(target + ".tmp", target)
            if self._storage is None:
                self.manifest = _integrity.write_manifest(self.path)
            else:
                self._storage.upload(self.path, self._storage_id)
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
        the storage id. Several processes: every rank calls it with the same
        full state (a collective); the chief writes."""
        self.wait()  # never two pending: the buffers are reused
        # Deterministic id so all ranks agree without a broadcast.
        storage_id = f"trial{self._trial_id}-step{steps_completed}"
        if not self._is_chief():
            self._pending = (storage_id, None, None)
            if not self._async:
                self.wait()
            return storage_id
        path = self._storage.path_for(storage_id)
        if self._staged():  # never upload an older staging's leftovers
            shutil.rmtree(path, ignore_errors=True)
        os.makedirs(os.path.join(path, _STATE_SUBDIR), exist_ok=True)
        md = dict(metadata or {})
        md.update({"steps_completed": steps_completed,
                   "trial_id": self._trial_id, "format": "torch",
                   "time": time.time()})
        with open(os.path.join(path, _METADATA_FILE), "w") as f:
            json.dump(md, f)
        # Reported before the write starts, so the report lists what the
        # JAX package's lists: the metadata, never the manifest.
        self._report(storage_id, md, state="PARTIAL")
        t0 = time.monotonic()
        t0_us = trace_mod.now_us()
        host, event = self._snapshot.take(state)
        write = _Write(path, host, event, background=self._async,
                       storage=self._storage if self._staged() else None,
                       storage_id=storage_id)
        self._pending_sync_ms = (time.monotonic() - t0) * 1000.0
        # Phase 1 on the trace: the part of the save the loop paid for.
        self._span("harness.checkpoint.save", t0_us, storage_id=storage_id,
                   steps_completed=steps_completed)
        self._pending = (storage_id, md, write)
        if not self._async:
            self.wait()
        return storage_id

    def wait(self) -> None:
        """Block until the pending save is written and committed (COMMIT
        marker stored, COMPLETED reported). Raises the write's error, if
        it failed; the checkpoint then stays PARTIAL. Several processes:
        every rank calls it, and it ends in a barrier."""
        if self._pending is None:
            return
        storage_id, md, write = self._pending
        self._pending = None
        if write is None:  # a rank other than the chief
            self._dist.barrier("checkpoint.commit")
            return
        t0 = time.monotonic()
        t0_us = trace_mod.now_us()
        write.join()
        if write.error is not None:
            raise RuntimeError(
                f"checkpoint {storage_id}: the state write failed") \
                from write.error
        if self._staged():
            self._commit_remote(storage_id)
        else:
            _integrity.commit(write.path, storage_id, write.manifest)
        self._report(storage_id, md, state="COMPLETED")
        self.last_save_ms = self._pending_sync_ms + \
            (time.monotonic() - t0) * 1000.0
        # Phase 2 on the trace: the wait for the write, COMMIT and report.
        self._span("harness.checkpoint.commit", t0_us, storage_id=storage_id)
        if self._shared():
            self._dist.barrier("checkpoint.commit")

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
        state_file = os.path.join(path, _STATE_SUBDIR, _STATE_FILE)
        if not os.path.exists(state_file):
            raise FileNotFoundError(
                f"checkpoint {storage_id} not found at {path}")
        return state_file

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

    def _load(self, storage_id: str) -> Any:
        """The saved tree of checkpoint `storage_id` (CPU tensors), read
        after the checkpoint verified (a cloud one once downloaded)."""
        with self._storage.restore_path(storage_id) as path:
            state_file = self._state_file(path, storage_id)
            _integrity.verify(path, storage_id)
            return torch.load(state_file, map_location="cpu",
                              weights_only=False)

    def restore_state(self, storage_id: str, template: Any) -> Any:
        """Read checkpoint `storage_id` back in the structure, devices and
        dtypes of `template` (e.g. a freshly initialised TrainState).
        Raises as `verify` does."""
        return _like(template, self._load(storage_id))

    def restore_params(self, storage_id: str) -> Any:
        """The `params` subtree of checkpoint `storage_id` as saved (CPU
        tensors), without a template: what a serve replica restores, having
        no optimizer to build a TrainState from. Raises as `verify` does,
        and ValueError for a checkpoint without params."""
        loaded = self._load(storage_id)
        params = loaded.get("params") if isinstance(loaded, dict) else None
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
