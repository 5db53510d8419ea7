"""Cloud storage backends: GCS / S3 / Azure.

The port's copy of determined_tpu/storage/cloud.py (reference
harness/determined/common/storage/{gcs,s3,azure}.py), in its staged-copy
mode: `store_path` yields a local staging directory and uploads it on
exit; `restore_path` downloads into a fresh staging directory first. The
port writes every checkpoint as files (`torch.save`), so it has no use
for the JAX package's tensorstore URLs (`url_for`).

GCS and S3 import their SDKs lazily; a manager whose SDK does not import
raises when it is built, naming the package. Azure speaks the Blob REST
protocol on the standard library (azure.py).
"""

from __future__ import annotations

import contextlib
import fnmatch
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, List, Optional

from determined_tpu_torch.storage.base import StorageManager, iter_upload_files


class CloudStorageManager(StorageManager):
    requires_staging = True

    def __init__(self, bucket: str, prefix: str = ""):
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        # local staging area for upload/download-style use
        super().__init__(os.path.join(tempfile.gettempdir(),
                                      "determined_tpu_torch", "cloud_staging"))

    def _key(self, storage_id: str, rel: str) -> str:
        parts = [p for p in (self.prefix, storage_id, rel) if p]
        return "/".join(parts)

    def _list_prefix(self, storage_id: str) -> str:
        key = self._key(storage_id, "")
        return key + "/" if key and not key.endswith("/") else key

    # -- staged file checkpoints --------------------------------------

    @contextlib.contextmanager
    def store_path(self, storage_id: Optional[str] = None) -> Iterator[tuple]:
        """Stage locally, upload to the bucket on exit. Staging is removed
        after the upload so periodic checkpointing doesn't fill /tmp."""
        storage_id = storage_id or self.new_storage_id()
        path = self.path_for(storage_id)
        os.makedirs(path, exist_ok=True)
        try:
            yield storage_id, path
            self.upload(path, storage_id)
        finally:
            shutil.rmtree(path, ignore_errors=True)

    @contextlib.contextmanager
    def restore_path(self, storage_id: str) -> Iterator[str]:
        """Download into a FRESH staging dir of this call's own (stale or
        partial staging from an earlier save on this host must never
        shadow the bucket, and the ranks of a run on one host restore the
        same checkpoint side by side), raise FileNotFoundError like the
        base class when the id doesn't exist, and clean staging up
        afterwards."""
        os.makedirs(self.base_path, exist_ok=True)
        path = tempfile.mkdtemp(prefix=f"{storage_id}.restore.",
                                dir=self.base_path)
        try:
            self.download(storage_id, path)
            if not os.listdir(path):
                raise FileNotFoundError(
                    f"checkpoint {storage_id} not found in {type(self).__name__}"
                )
            yield path
        finally:
            shutil.rmtree(path, ignore_errors=True)


class GCSStorageManager(CloudStorageManager):
    def __init__(self, bucket: str, prefix: str = ""):
        try:
            from google.cloud import storage
        except ImportError as e:
            raise RuntimeError(
                "google-cloud-storage is not installed; the gcs checkpoint "
                "storage needs it (package google-cloud-storage)") from e
        super().__init__(bucket, prefix)
        self._sdk = storage

    def _bucket(self):
        client = self._sdk.Client()
        return client, client.bucket(self.bucket)

    def upload(self, src: str, storage_id: str, paths: Optional[List[str]] = None) -> None:
        _, bucket = self._bucket()
        for path, rel in iter_upload_files(src, paths):
            bucket.blob(self._key(storage_id, rel)).upload_from_filename(path)

    def download(self, storage_id: str, dst: str, selector=None) -> None:
        client, bucket = self._bucket()
        prefix = self._list_prefix(storage_id)
        for blob in client.list_blobs(bucket, prefix=prefix):
            rel = blob.name[len(prefix):]
            if selector is not None and not selector(rel):
                continue
            out = os.path.join(dst, rel)
            os.makedirs(os.path.dirname(out) or dst, exist_ok=True)
            blob.download_to_filename(out)

    def list_files(self, storage_id: str) -> Dict[str, int]:
        client, bucket = self._bucket()
        prefix = self._list_prefix(storage_id)
        return {b.name[len(prefix):]: b.size or 0
                for b in client.list_blobs(bucket, prefix=prefix)}

    def delete(self, storage_id: str, globs: Optional[List[str]] = None) -> Dict[str, Any]:
        client, bucket = self._bucket()
        prefix = self._list_prefix(storage_id)
        remaining: Dict[str, int] = {}
        for blob in client.list_blobs(bucket, prefix=prefix):
            rel = blob.name[len(prefix):]
            if globs is not None and not any(fnmatch.fnmatch(rel, g) for g in globs):
                remaining[rel] = blob.size or 0
                continue
            blob.delete()
        return remaining


class S3StorageManager(CloudStorageManager):
    def __init__(self, bucket: str, prefix: str = ""):
        try:
            import boto3
        except ImportError as e:
            raise RuntimeError(
                "boto3 is not installed; the s3 checkpoint storage needs it "
                "(package boto3)") from e
        super().__init__(bucket, prefix)
        self._boto3 = boto3

    def _client(self):
        return self._boto3.client("s3")

    def upload(self, src: str, storage_id: str, paths: Optional[List[str]] = None) -> None:
        s3 = self._client()
        for path, rel in iter_upload_files(src, paths):
            s3.upload_file(path, self.bucket, self._key(storage_id, rel))

    def _objects(self, s3, storage_id: str):
        prefix = self._list_prefix(storage_id)
        paginator = s3.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self.bucket, Prefix=prefix):
            for obj in page.get("Contents", []):
                yield obj["Key"], obj["Key"][len(prefix):], obj["Size"]

    def download(self, storage_id: str, dst: str, selector=None) -> None:
        s3 = self._client()
        for key, rel, _ in self._objects(s3, storage_id):
            if selector is not None and not selector(rel):
                continue
            out = os.path.join(dst, rel)
            os.makedirs(os.path.dirname(out) or dst, exist_ok=True)
            s3.download_file(self.bucket, key, out)

    def list_files(self, storage_id: str) -> Dict[str, int]:
        return {rel: size
                for _, rel, size in self._objects(self._client(), storage_id)}

    def delete(self, storage_id: str, globs: Optional[List[str]] = None) -> Dict[str, Any]:
        s3 = self._client()
        remaining: Dict[str, int] = {}
        doomed: List[str] = []
        for key, rel, size in self._objects(s3, storage_id):
            if globs is not None and not any(fnmatch.fnmatch(rel, g) for g in globs):
                remaining[rel] = size
                continue
            doomed.append(key)
        # A sharded checkpoint may hold thousands of files: batch deletes
        # (1000 keys a request is the S3 API's limit).
        for i in range(0, len(doomed), 1000):
            s3.delete_objects(
                Bucket=self.bucket,
                Delete={"Objects": [{"Key": k} for k in doomed[i : i + 1000]]},
            )
        return remaining


class AzureStorageManager(CloudStorageManager):
    """Azure Blob backend over the stdlib REST client (storage/azure.py) —
    no SDK dependency. `bucket` is the container name."""

    def __init__(self, container: str, connection_string: str = "", prefix: str = ""):
        super().__init__(container, prefix)
        from determined_tpu_torch.storage.azure import AzureBlobClient

        self._client = AzureBlobClient(connection_string or None)

    def upload(self, src: str, storage_id: str, paths: Optional[List[str]] = None) -> None:
        for path, rel in iter_upload_files(src, paths):
            self._client.put_blob_from_file(
                self.bucket, self._key(storage_id, rel), path
            )

    def download(self, storage_id: str, dst: str, selector=None) -> None:
        prefix = self._list_prefix(storage_id)
        for name, _size in self._client.list_blobs(self.bucket, prefix):
            rel = name[len(prefix):]
            if selector is not None and not selector(rel):
                continue
            out = os.path.join(dst, rel)
            os.makedirs(os.path.dirname(out) or dst, exist_ok=True)
            self._client.get_blob_to_file(self.bucket, name, out)

    def list_files(self, storage_id: str) -> Dict[str, int]:
        prefix = self._list_prefix(storage_id)
        return {
            name[len(prefix):]: size
            for name, size in self._client.list_blobs(self.bucket, prefix)
        }

    def delete(self, storage_id: str, globs: Optional[List[str]] = None) -> Dict[str, Any]:
        prefix = self._list_prefix(storage_id)
        remaining: Dict[str, int] = {}
        for name, size in self._client.list_blobs(self.bucket, prefix):
            rel = name[len(prefix):]
            if globs is not None and not any(fnmatch.fnmatch(rel, g) for g in globs):
                remaining[rel] = size
                continue
            self._client.delete_blob(self.bucket, name)
        return remaining


def cloud_from_config(stype: str, config: Dict[str, Any]) -> StorageManager:
    if stype == "gcs":
        return GCSStorageManager(config["bucket"], config.get("prefix", ""))
    if stype == "s3":
        return S3StorageManager(config["bucket"], config.get("prefix", ""))
    if stype == "azure":
        if not config.get("container"):
            raise ValueError(
                "checkpoint_storage.container is required for azure storage"
            )
        return AzureStorageManager(
            config["container"],
            config.get("connection_string", ""),
            config.get("prefix", ""),
        )
    raise ValueError(stype)
