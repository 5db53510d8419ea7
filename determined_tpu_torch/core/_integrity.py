"""Checkpoint integrity — the two-phase commit protocol.

The port's copy of determined_tpu/core/_integrity.py.

The platform's whole fault-tolerance story ("restart from the latest
checkpoint") is only as good as the checkpoint it restarts from: a process
killed mid-async-save leaves a directory that *looks* like a checkpoint but
is missing shards, and nothing in the seed verified any of it. CheckFreq
(FAST '21) separates the snapshot from its durability commit; we adopt the
same shape:

  1. the state file is written (phase 1; `torch.save` in the port);
  2. after the save is durable, a ``manifest.json`` records every file's
     size + sha256 (tmp-write + rename, so it is itself atomic);
  3. a ``COMMIT`` marker (tmp-write + rename) is the single atomic bit that
     flips the checkpoint from PARTIAL to COMPLETED.

Restore verifies the other direction: a missing COMMIT (crash between
phases) or a manifest mismatch (torn write, bit rot, truncation) raises the
typed :class:`CorruptCheckpoint`, which the Trainer treats as "walk the
lineage back to the last good checkpoint" — never as "start fresh".

Checkpoints written before this protocol existed (no manifest AND no
COMMIT) verify as legacy: restore proceeds, integrity unknown. A manifest
without a COMMIT, or vice versa, is always corrupt.

Chaos fault points (docs/chaos.md):
  ``checkpoint.write.truncate``  truncate the largest data file after the
                                 manifest is written — models a torn/partial
                                 shard write that the COMMIT raced past
  ``checkpoint.commit.drop``     skip the COMMIT marker — models a crash
                                 between phase 1 and phase 2
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict, Optional

from determined_tpu_torch.common import faultpoint

logger = logging.getLogger("determined_tpu_torch.core")

MANIFEST_FILE = "manifest.json"
COMMIT_FILE = "COMMIT"

FAULT_WRITE_TRUNCATE = "checkpoint.write.truncate"
FAULT_COMMIT_DROP = "checkpoint.commit.drop"

# Files that are part of the protocol itself, never of the manifest.
_PROTOCOL_FILES = (MANIFEST_FILE, COMMIT_FILE)


class CorruptCheckpoint(RuntimeError):
    """A checkpoint that exists but must not be restored from.

    Raised on integrity verification failure: missing COMMIT marker
    (interrupted commit), missing/unreadable manifest, or file
    size/checksum mismatch. Distinct from FileNotFoundError (checkpoint
    gone entirely) so callers can treat both as "fall back through the
    lineage" while still re-raising genuine programming errors.
    """

    def __init__(self, storage_id: str, reason: str):
        super().__init__(f"checkpoint {storage_id!r} failed integrity "
                         f"verification: {reason}")
        self.storage_id = storage_id
        self.reason = reason


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    """tmp-write + fsync + rename: the file either exists complete or not
    at all — a crash can never leave a half-written protocol file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _walk_files(path: str) -> Dict[str, str]:
    """rel path -> abs path for every non-protocol file under `path`."""
    out: Dict[str, str] = {}
    for root, _, files in os.walk(path):
        for f in files:
            full = os.path.join(root, f)
            rel = os.path.relpath(full, path)
            if rel in _PROTOCOL_FILES or rel.endswith(".tmp"):
                continue
            out[rel] = full
    return out


def build_manifest(path: str, checksums: bool = True) -> Dict:
    """Manifest of every file under `path` (sizes, and sha256 when
    `checksums`). Remote backends that can only list sizes pass
    checksums=False and get presence/size verification."""
    files: Dict[str, Dict] = {}
    for rel, full in sorted(_walk_files(path).items()):
        entry: Dict = {"size": os.path.getsize(full)}
        if checksums:
            entry["sha256"] = _sha256(full)
        files[rel] = entry
    return {"version": 1, "files": files}


def file_entries(path: str, rels) -> Dict[str, Dict]:
    """rel -> {size, sha256} for the files `rels` under `path`: a rank's
    own share of a manifest that the chief merges (a sharded
    checkpoint's rank files)."""
    out: Dict[str, Dict] = {}
    for rel in rels:
        full = os.path.join(path, rel)
        out[rel] = {"size": os.path.getsize(full), "sha256": _sha256(full)}
    return out


def write_manifest(path: str, files: Optional[Dict[str, Dict]] = None
                   ) -> Dict:
    """Checksum every file under `path` into manifest.json (atomic) and
    return the manifest; or, given `files` (rel -> entry, as
    `file_entries` makes them), record those. A manifest without a COMMIT
    is still PARTIAL."""
    manifest = build_manifest(path) if files is None else \
        {"version": 1, "files": dict(sorted(files.items()))}
    _atomic_write(
        os.path.join(path, MANIFEST_FILE),
        json.dumps(manifest, sort_keys=True).encode(),
    )
    return manifest


def commit(path: str, storage_id: str, manifest: Dict) -> None:
    """Phase 2: write the COMMIT marker (atomic) for a checkpoint whose
    `manifest` was written by `write_manifest`.

    Must only be called after the phase-1 save and its manifest are
    durable (the caller's ``wait()``). The ordering is the protocol: a
    COMMIT implies a valid manifest implies verified data.
    """
    if faultpoint.fire(FAULT_WRITE_TRUNCATE) is not faultpoint.Action.NONE:
        # Torn-write chaos: corrupt the largest data file AFTER its
        # checksum was recorded, so only integrity verification — not the
        # happy path — can catch it.
        files = _walk_files(path)
        if files:
            victim = max(files.values(), key=os.path.getsize)
            size = os.path.getsize(victim)
            with open(victim, "r+b") as f:
                f.truncate(max(0, size // 2))
            logger.error("faultpoint: %s truncated %s (%d -> %d bytes)",
                         FAULT_WRITE_TRUNCATE, victim, size, size // 2)

    if faultpoint.fire(FAULT_COMMIT_DROP) is not faultpoint.Action.NONE:
        logger.error("faultpoint: %s dropped COMMIT for %s",
                     FAULT_COMMIT_DROP, storage_id)
        return

    _atomic_write(
        os.path.join(path, COMMIT_FILE),
        json.dumps({"storage_id": storage_id,
                    "n_files": len(manifest["files"])}).encode(),
    )


def verify(path: str, storage_id: str, checksummed=None) -> bool:
    """Verify a local checkpoint directory against its manifest.

    Returns True when verified, False for legacy checkpoints (written
    before the protocol existed — no manifest AND no COMMIT). Raises
    CorruptCheckpoint on any integrity failure. `checksummed`: the files
    whose sha256 is checked (every file by default); the others are held
    to their presence and size (a sharded checkpoint's rank files, whose
    pieces the reader checks one by one).
    """
    manifest_path = os.path.join(path, MANIFEST_FILE)
    commit_path = os.path.join(path, COMMIT_FILE)
    has_manifest = os.path.exists(manifest_path)
    has_commit = os.path.exists(commit_path)
    if not has_manifest and not has_commit:
        logger.warning(
            "checkpoint %s predates the integrity protocol (no manifest); "
            "restoring unverified", storage_id)
        return False
    if not has_commit:
        raise CorruptCheckpoint(
            storage_id, "no COMMIT marker — the save never finished "
            "committing (process died between write and commit)")
    if not has_manifest:
        raise CorruptCheckpoint(storage_id, "COMMIT present but manifest "
                                "missing")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CorruptCheckpoint(storage_id, f"unreadable manifest: {e}")
    verify_against_manifest(path, manifest, storage_id, checksummed)
    return True


def verify_against_manifest(path: str, manifest: Dict, storage_id: str,
                            checksummed=None) -> None:
    """Check every manifest entry: present, right size, and right sha256
    (of the entries in `checksummed`, or all of them)."""
    files = manifest.get("files")
    if not isinstance(files, dict):
        raise CorruptCheckpoint(storage_id, "manifest has no file table")
    for rel, entry in files.items():
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            raise CorruptCheckpoint(storage_id, f"missing file {rel!r}")
        size = os.path.getsize(full)
        if size != entry.get("size"):
            raise CorruptCheckpoint(
                storage_id, f"size mismatch for {rel!r}: manifest says "
                f"{entry.get('size')}, found {size}")
        want = entry.get("sha256")
        if checksummed is not None and rel not in checksummed:
            continue
        if want and _sha256(full) != want:
            raise CorruptCheckpoint(storage_id,
                                    f"checksum mismatch for {rel!r}")


def verify_listing(listing: Dict[str, int], manifest: Optional[Dict],
                   storage_id: str) -> bool:
    """Presence/size verification from a remote file listing (rel -> size),
    for backends where downloading every file just to checksum it would
    defeat the point. Same legacy/corrupt semantics as `verify`."""
    has_commit = COMMIT_FILE in listing
    has_manifest = MANIFEST_FILE in listing
    if not has_commit and not has_manifest:
        logger.warning(
            "checkpoint %s predates the integrity protocol (no manifest); "
            "restoring unverified", storage_id)
        return False
    if not has_commit:
        raise CorruptCheckpoint(
            storage_id, "no COMMIT marker — the save never finished "
            "committing (process died between write and commit)")
    if manifest is None:
        raise CorruptCheckpoint(storage_id, "COMMIT present but manifest "
                                "missing or unreadable")
    files = manifest.get("files")
    if not isinstance(files, dict):
        raise CorruptCheckpoint(storage_id, "manifest has no file table")
    for rel, entry in files.items():
        if rel not in listing:
            raise CorruptCheckpoint(storage_id, f"missing file {rel!r}")
        if listing[rel] != entry.get("size"):
            raise CorruptCheckpoint(
                storage_id, f"size mismatch for {rel!r}: manifest says "
                f"{entry.get('size')}, found {listing[rel]}")
    return True
