"""Storage manager ABC + filesystem backends.

The port's copy of determined_tpu/storage/base.py (reference:
harness/determined/common/storage/base.py, shared.py, directory.py).
Cloud backends live in cloud.py.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import uuid
from typing import Any, Dict, Iterator, List, Optional


def default_checkpoint_dir() -> str:
    """Where checkpoints go when nothing names a place."""
    return os.path.join(tempfile.gettempdir(), "determined_tpu_torch",
                        "checkpoints")


def iter_upload_files(src: str, paths: Optional[List[str]] = None):
    """Yield (local_path, rel_key) for every file upload() pushes from src.

    Shared by the cloud upload walks and the sharded-checkpoint resource
    reporting so the registry's file list always matches what was uploaded.
    """
    names = paths if paths is not None else os.listdir(src)
    for name in names:
        full = os.path.join(src, name)
        if os.path.isdir(full):
            for root, _, files in os.walk(full):
                for f in files:
                    p = os.path.join(root, f)
                    yield p, os.path.relpath(p, src)
        else:
            yield full, name


class StorageManager:
    """Checkpoints are directories keyed by UUID under a storage root."""

    # Cloud managers stage files in a local directory and copy them to the
    # bucket (cloud.py); filesystem managers write in place.
    requires_staging = False

    def __init__(self, base_path: str):
        self.base_path = os.path.abspath(base_path)

    # -- core API ------------------------------------------------------

    def new_storage_id(self) -> str:
        return str(uuid.uuid4())

    def path_for(self, storage_id: str) -> str:
        return os.path.join(self.base_path, storage_id)

    @contextlib.contextmanager
    def store_path(self, storage_id: Optional[str] = None) -> Iterator[tuple]:
        """Yield (storage_id, writable_dir); commit on exit. Filesystem
        backends write in place, with no staging copy."""
        storage_id = storage_id or self.new_storage_id()
        path = self.path_for(storage_id)
        os.makedirs(path, exist_ok=True)
        yield storage_id, path

    @contextlib.contextmanager
    def restore_path(self, storage_id: str) -> Iterator[str]:
        path = self.path_for(storage_id)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"checkpoint {storage_id} not found at {path}")
        yield path

    def delete(self, storage_id: str, globs: Optional[List[str]] = None) -> Dict[str, Any]:
        """Delete a checkpoint (or matching files). Returns remaining resources."""
        import glob as globlib

        path = self.path_for(storage_id)
        if not os.path.isdir(path):
            return {}
        if globs:
            for g in globs:
                for f in globlib.glob(os.path.join(path, g), recursive=True):
                    if os.path.isdir(f):
                        shutil.rmtree(f, ignore_errors=True)
                    else:
                        with contextlib.suppress(OSError):
                            os.unlink(f)
            if not os.listdir(path):
                shutil.rmtree(path, ignore_errors=True)
                return {}
            return self.list_files(storage_id)
        shutil.rmtree(path, ignore_errors=True)
        return {}

    def list_files(self, storage_id: str) -> Dict[str, int]:
        path = self.path_for(storage_id)
        out: Dict[str, int] = {}
        for root, _, files in os.walk(path):
            for f in files:
                full = os.path.join(root, f)
                out[os.path.relpath(full, path)] = os.path.getsize(full)
        return out

    # upload/download between a local working dir and storage ----------

    def upload(self, src: str, storage_id: str, paths: Optional[List[str]] = None) -> None:
        dst = self.path_for(storage_id)
        os.makedirs(dst, exist_ok=True)
        names = paths if paths is not None else os.listdir(src)
        for name in names:
            s, d = os.path.join(src, name), os.path.join(dst, name)
            os.makedirs(os.path.dirname(d), exist_ok=True)
            if os.path.isdir(s):
                shutil.copytree(s, d, dirs_exist_ok=True)
            else:
                shutil.copy2(s, d)

    def download(self, storage_id: str, dst: str, selector=None) -> None:
        src = self.path_for(storage_id)
        os.makedirs(dst, exist_ok=True)
        for rel in self.list_files(storage_id):
            if selector is not None and not selector(rel):
                continue
            s, d = os.path.join(src, rel), os.path.join(dst, rel)
            os.makedirs(os.path.dirname(d), exist_ok=True)
            shutil.copy2(s, d)


class SharedFSStorageManager(StorageManager):
    """`shared_fs`: a path visible to all hosts (NFS and the like)."""


class DirectoryStorageManager(StorageManager):
    """`directory`: a container-local path (persisted by bind-mount)."""


def from_config(config: Optional[Dict[str, Any]],
                default_base: Optional[str] = None) -> StorageManager:
    """Build a manager from an expconf `checkpoint_storage` block; without
    one, `shared_fs` at `default_base` (default: `default_checkpoint_dir()`).
    A cloud type whose SDK does not import raises, naming the package."""
    default_base = default_base or default_checkpoint_dir()
    config = dict(config or {"type": "shared_fs", "host_path": default_base})
    stype = config.get("type", "shared_fs")
    if stype == "shared_fs":
        base = config.get("host_path", default_base)
        if config.get("storage_path"):
            base = os.path.join(base, config["storage_path"])
        return SharedFSStorageManager(base)
    if stype == "directory":
        return DirectoryStorageManager(config.get("container_path", default_base))
    if stype in ("gcs", "s3", "azure"):
        from determined_tpu_torch.storage.cloud import cloud_from_config

        return cloud_from_config(stype, config)
    raise ValueError(f"unknown checkpoint storage type {stype!r}")
