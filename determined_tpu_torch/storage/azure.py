"""Azure Blob storage backend — stdlib-only REST client.

The port's copy of determined_tpu/storage/azure.py (reference:
harness/determined/common/storage/azure.py, which uses
azure-storage-blob). It needs no SDK: it implements the Blob service REST
protocol directly (PUT/GET/DELETE blob + List Blobs) with Shared Key
authorization (HMAC-SHA256 over the canonical string-to-sign). Works
against real Azure endpoints and local emulators (Azurite / the fake
server in tests) via the `BlobEndpoint` connection-string key.
"""

from __future__ import annotations

import base64
import email.utils
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

_API_VERSION = "2021-08-06"


def parse_connection_string(cs: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in cs.split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        k, v = part.split("=", 1)
        out[k] = v
    return out


class AzureBlobClient:
    """Minimal Blob-service client: shared-key signed PUT/GET/DELETE/LIST."""

    def __init__(self, connection_string: Optional[str] = None):
        cs = connection_string or os.environ.get("AZURE_STORAGE_CONNECTION_STRING", "")
        if not cs:
            raise ValueError(
                "azure storage needs a connection_string (config key or "
                "AZURE_STORAGE_CONNECTION_STRING)"
            )
        parts = parse_connection_string(cs)
        self.account = parts.get("AccountName", "")
        key = parts.get("AccountKey", "")
        self.key = base64.b64decode(key) if key else b""
        if "BlobEndpoint" in parts:
            self.endpoint = parts["BlobEndpoint"].rstrip("/")
        else:
            proto = parts.get("DefaultEndpointsProtocol", "https")
            suffix = parts.get("EndpointSuffix", "core.windows.net")
            if not self.account:
                raise ValueError("connection string missing AccountName")
            self.endpoint = f"{proto}://{self.account}.blob.{suffix}"

    # -- signing -------------------------------------------------------

    def _canonicalized_resource(self, path: str, query: Dict[str, str]) -> str:
        res = f"/{self.account}{path}"
        for k in sorted(query):
            res += f"\n{k.lower()}:{query[k]}"
        return res

    def _sign(self, verb: str, path: str, query: Dict[str, str],
              headers: Dict[str, str], content_length: int) -> str:
        cl = str(content_length) if content_length else ""
        ms_headers = sorted(
            (k.lower(), v) for k, v in headers.items() if k.lower().startswith("x-ms-")
        )
        canon_headers = "".join(f"{k}:{v}\n" for k, v in ms_headers)
        string_to_sign = "\n".join(
            [
                verb,
                headers.get("Content-Encoding", ""),
                headers.get("Content-Language", ""),
                cl,
                headers.get("Content-MD5", ""),
                headers.get("Content-Type", ""),
                "",  # Date (we send x-ms-date instead)
                headers.get("If-Modified-Since", ""),
                headers.get("If-Match", ""),
                headers.get("If-None-Match", ""),
                headers.get("If-Unmodified-Since", ""),
                headers.get("Range", ""),
            ]
        ) + "\n" + canon_headers + self._canonicalized_resource(path, query)
        sig = base64.b64encode(
            hmac.new(self.key, string_to_sign.encode("utf-8"), hashlib.sha256).digest()
        ).decode()
        return f"SharedKey {self.account}:{sig}"

    def _open(
        self,
        verb: str,
        path: str,
        query: Optional[Dict[str, str]] = None,
        body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
        timeout: int = 60,
    ):
        """Signed request returning the open response (caller closes).
        Raises urllib.error.HTTPError on non-2xx."""
        query = dict(query or {})
        headers = dict(headers or {})
        headers["x-ms-date"] = email.utils.formatdate(usegmt=True)
        headers["x-ms-version"] = _API_VERSION
        # Sign the percent-encoded path — Azure canonicalizes the request
        # URL's encoded form, so signing the raw path 403s on names needing
        # escaping (spaces etc).
        qpath = urllib.parse.quote(path)
        if self.key:
            headers["Authorization"] = self._sign(
                verb, qpath, query, headers, len(body) if body else 0
            )
        qs = urllib.parse.urlencode(query)
        url = self.endpoint + qpath + ("?" + qs if qs else "")
        req = urllib.request.Request(url, data=body, method=verb, headers=headers)
        return urllib.request.urlopen(req, timeout=timeout)

    def _request(
        self,
        verb: str,
        path: str,
        query: Optional[Dict[str, str]] = None,
        body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, bytes]:
        try:
            with self._open(verb, path, query, body, headers) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    # -- blob ops ------------------------------------------------------

    # Single-put limit is far higher, but chunking keeps peak memory bounded
    # for multi-GB checkpoint shards (one block in flight at a time).
    BLOCK_SIZE = 64 * 1024 * 1024

    def put_blob_from_file(self, container: str, name: str, path: str) -> None:
        """Upload a file; large files go through Put Block / Put Block List
        so at most one BLOCK_SIZE chunk is in memory."""
        size = os.path.getsize(path)
        if size <= self.BLOCK_SIZE:
            with open(path, "rb") as fh:
                self.put_blob(container, name, fh.read())
            return
        block_ids: List[str] = []
        with open(path, "rb") as fh:
            idx = 0
            while True:
                chunk = fh.read(self.BLOCK_SIZE)
                if not chunk:
                    break
                block_id = base64.b64encode(f"block-{idx:08d}".encode()).decode()
                status, body = self._request(
                    "PUT",
                    f"/{container}/{name}",
                    query={"comp": "block", "blockid": block_id},
                    body=chunk,
                    headers={"Content-Type": "application/octet-stream"},
                )
                if status not in (200, 201):
                    raise RuntimeError(
                        f"azure put block {name}#{idx}: HTTP {status}: {body[:200]!r}"
                    )
                block_ids.append(block_id)
                idx += 1
        xml_body = (
            "<?xml version='1.0' encoding='utf-8'?><BlockList>"
            + "".join(f"<Latest>{b}</Latest>" for b in block_ids)
            + "</BlockList>"
        ).encode()
        status, body = self._request(
            "PUT",
            f"/{container}/{name}",
            query={"comp": "blocklist"},
            body=xml_body,
            headers={"Content-Type": "application/xml"},
        )
        if status not in (200, 201):
            raise RuntimeError(f"azure put blocklist {name}: HTTP {status}: {body[:200]!r}")

    def get_blob_to_file(self, container: str, name: str, out_path: str) -> None:
        """Download a blob, streaming to disk in 1 MiB chunks."""
        try:
            with self._open(
                "GET", f"/{container}/{name}", timeout=300
            ) as resp, open(out_path, "wb") as fh:
                while True:
                    chunk = resp.read(1024 * 1024)
                    if not chunk:
                        break
                    fh.write(chunk)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise FileNotFoundError(f"azure blob {container}/{name}") from e
            raise RuntimeError(f"azure get {name}: HTTP {e.code}") from e

    def put_blob(self, container: str, name: str, data: bytes) -> None:
        status, body = self._request(
            "PUT",
            f"/{container}/{name}",
            body=data,
            headers={"x-ms-blob-type": "BlockBlob",
                     "Content-Type": "application/octet-stream"},
        )
        if status not in (200, 201):
            raise RuntimeError(f"azure put {name}: HTTP {status}: {body[:200]!r}")

    def get_blob(self, container: str, name: str) -> bytes:
        status, body = self._request("GET", f"/{container}/{name}")
        if status == 404:
            raise FileNotFoundError(f"azure blob {container}/{name}")
        if status != 200:
            raise RuntimeError(f"azure get {name}: HTTP {status}: {body[:200]!r}")
        return body

    def delete_blob(self, container: str, name: str) -> None:
        status, body = self._request("DELETE", f"/{container}/{name}")
        if status not in (200, 202, 404):
            raise RuntimeError(f"azure delete {name}: HTTP {status}: {body[:200]!r}")

    def list_blobs(self, container: str, prefix: str = "") -> List[Tuple[str, int]]:
        """Return [(name, size)] under prefix, following continuation markers."""
        out: List[Tuple[str, int]] = []
        marker = ""
        while True:
            query = {"restype": "container", "comp": "list", "prefix": prefix}
            if marker:
                query["marker"] = marker
            status, body = self._request("GET", f"/{container}", query=query)
            if status != 200:
                raise RuntimeError(f"azure list: HTTP {status}: {body[:200]!r}")
            root = ET.fromstring(body)
            for blob in root.iter("Blob"):
                name_el = blob.find("Name")
                size_el = blob.find(".//Content-Length")
                if name_el is not None and name_el.text:
                    size = int(size_el.text) if (size_el is not None and size_el.text) else 0
                    out.append((name_el.text, size))
            nm = root.find("NextMarker")
            marker = nm.text if (nm is not None and nm.text) else ""
            if not marker:
                return out
