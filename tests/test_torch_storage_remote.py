"""The port's cloud storage backends against local fake servers, on the CPU.

The fakes are this file's own copies of tests/test_storage_gcs.py's JSON-API
service (the google-cloud-storage SDK pointed at it by
`STORAGE_EMULATOR_HOST`) and tests/test_storage_azure.py's Blob service
(which recomputes the SharedKey signature of every request). Through
both backends:

  - upload, list, download with a selector, delete with globs, names that
    need percent-encoding, and Azure's block upload of a large file;
  - `store_path` uploads on exit and `restore_path` downloads into fresh
    staging, both cleaned up after;
  - `CheckpointContext.save_state` -> `wait` -> `verify` ->
    `restore_state` bitwise, in the background and inline: the staged
    files go up first, then the manifest, then COMMIT, and no staging is
    left behind;
  - a torn upload (no COMMIT, or a file missing) refused by `verify` and
    by `restore_state`;
  - the file-checkpoint calls through the port's and the JAX package's
    contexts leave the same objects in the bucket;
  - a serve replica's restore downloads a remote checkpoint;
  - s3 raises naming boto3 (absent here), gcs names its SDK when it does
    not import.
"""

import base64
import builtins
import hashlib
import hmac
import http.server
import json
import os
import threading
import urllib.parse
import xml.etree.ElementTree as ET

import pytest
import torch

from determined_tpu.core._checkpoint import CheckpointContext as JCheckpoint
from determined_tpu.storage import cloud as jcloud
from determined_tpu_torch.common import faultpoint
from determined_tpu_torch.core import _integrity
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.storage import cloud, from_config
from determined_tpu_torch.storage.azure import AzureBlobClient

ACCOUNT = "testacct"
KEY = base64.b64encode(b"0123456789abcdef0123456789abcdef").decode()


# ---------------------------------------------------------------- fake GCS


class FakeGCSService(http.server.BaseHTTPRequestHandler):
    """The JSON-API subset google-cloud-storage uses: multipart upload,
    list with a prefix, `alt=media` download, delete."""

    store = {}  # (bucket, name) -> bytes
    requests = []  # (method, path, object name)

    def log_message(self, *a):
        pass

    def _json(self, status, obj):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if not parsed.path.startswith("/upload/storage/v1/b/") or \
                query.get("uploadType") != "multipart":
            self._json(400, {"error": "only multipart upload supported"})
            return
        bucket = parsed.path.split("/")[5]
        # multipart/related: part 1 = metadata JSON, part 2 = content; the
        # boundary is the body's first line.
        boundary = body.split(b"\r\n", 1)[0]
        parts = [p for p in body.split(boundary) if p.strip(b"-\r\n")]
        meta = json.loads(parts[0].split(b"\r\n\r\n", 1)[1])
        content = parts[1].split(b"\r\n\r\n", 1)[1]
        if content.endswith(b"\r\n"):
            content = content[:-2]
        name = meta.get("name") or query.get("name")
        FakeGCSService.requests.append(("POST", parsed.path, name))
        FakeGCSService.store[(bucket, name)] = content
        self._json(200, {"name": name, "bucket": bucket,
                         "size": str(len(content))})

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        FakeGCSService.requests.append(("GET", parsed.path, None))
        if parsed.path.startswith("/download/storage/v1/b/"):
            segs = parsed.path.split("/")
            data = FakeGCSService.store.get(
                (segs[5], urllib.parse.unquote(segs[7])))
            if data is None or query.get("alt") != "media":
                self._json(404, {"error": {"code": 404,
                                           "message": "No such object"}})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        if parsed.path.startswith("/storage/v1/b/") and \
                parsed.path.endswith("/o"):
            bucket = parsed.path.split("/")[4]
            prefix = query.get("prefix", "")
            items = [{"name": n, "bucket": b, "size": str(len(data))}
                     for (b, n), data in sorted(FakeGCSService.store.items())
                     if b == bucket and n.startswith(prefix)]
            self._json(200, {"kind": "storage#objects", "items": items})
            return
        self._json(404, {"error": {"code": 404, "message": "not found"}})

    def do_DELETE(self):
        parsed = urllib.parse.urlparse(self.path)
        segs = parsed.path.split("/")
        key = (segs[4], urllib.parse.unquote(segs[6]))
        FakeGCSService.requests.append(("DELETE", parsed.path, key[1]))
        if key not in FakeGCSService.store:
            self._json(404, {"error": {"code": 404,
                                       "message": "No such object"}})
            return
        del FakeGCSService.store[key]
        self.send_response(204)
        self.send_header("Content-Length", "0")
        self.end_headers()


# ------------------------------------------------------------- fake Azure


class FakeBlobService(http.server.BaseHTTPRequestHandler):
    """Put/Get/Delete Blob, Put Block / Put Block List and List Blobs, with
    every request's SharedKey signature recomputed."""

    store = {}  # (container, name) -> bytes
    blocks = {}  # (container, name, block_id) -> bytes
    auth_failures = []
    puts = []  # blob names in the order their content was committed

    def log_message(self, *a):
        pass

    def _check_auth(self, content_length: int):
        parsed = urllib.parse.urlparse(self.path)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        canon_res = f"/{ACCOUNT}{parsed.path}"
        for k in sorted(query):
            canon_res += f"\n{k.lower()}:{query[k]}"
        ms = sorted((k.lower(), v.strip()) for k, v in self.headers.items()
                    if k.lower().startswith("x-ms-"))
        sts = "\n".join([
            self.command,
            self.headers.get("Content-Encoding", ""),
            self.headers.get("Content-Language", ""),
            str(content_length) if content_length else "",
            self.headers.get("Content-MD5", ""),
            self.headers.get("Content-Type", ""),
            "",
            self.headers.get("If-Modified-Since", ""),
            self.headers.get("If-Match", ""),
            self.headers.get("If-None-Match", ""),
            self.headers.get("If-Unmodified-Since", ""),
            self.headers.get("Range", ""),
        ]) + "\n" + "".join(f"{k}:{v}\n" for k, v in ms) + canon_res
        want = base64.b64encode(hmac.new(
            base64.b64decode(KEY), sts.encode(), hashlib.sha256).digest()
        ).decode()
        if self.headers.get("Authorization", "") != \
                f"SharedKey {ACCOUNT}:{want}":
            FakeBlobService.auth_failures.append(
                f"bad-sig {self.command} {self.path}")

    def _parse(self):
        path = urllib.parse.urlparse(self.path).path
        container, _, name = path.strip("/").partition("/")
        return container, urllib.parse.unquote(name)

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        self._check_auth(length)
        body = self.rfile.read(length)
        container, name = self._parse()
        query = dict(urllib.parse.parse_qsl(
            urllib.parse.urlparse(self.path).query))
        if query.get("comp") == "block":
            FakeBlobService.blocks[(container, name, query["blockid"])] = body
        else:
            if query.get("comp") == "blocklist":
                ids = [el.text for el in ET.fromstring(body).iter("Latest")]
                body = b"".join(FakeBlobService.blocks.pop(
                    (container, name, i)) for i in ids)
            FakeBlobService.store[(container, name)] = body
            FakeBlobService.puts.append(name)
        self.send_response(201)
        self.end_headers()

    def do_GET(self):
        self._check_auth(0)
        parsed = urllib.parse.urlparse(self.path)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        if query.get("comp") == "list":
            container = parsed.path.strip("/")
            prefix = query.get("prefix", "")
            blobs = "".join(
                f"<Blob><Name>{n}</Name><Properties><Content-Length>{len(b)}"
                "</Content-Length></Properties></Blob>"
                for (c, n), b in sorted(FakeBlobService.store.items())
                if c == container and n.startswith(prefix))
            body = ("<?xml version='1.0'?><EnumerationResults>"
                    f"<Blobs>{blobs}</Blobs><NextMarker/>"
                    "</EnumerationResults>").encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        data = FakeBlobService.store.get(self._parse())
        if data is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_DELETE(self):
        self._check_auth(0)
        FakeBlobService.store.pop(self._parse(), None)
        self.send_response(202)
        self.end_headers()


def _serve(handler):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def conn_str(endpoint):
    return f"AccountName={ACCOUNT};AccountKey={KEY};BlobEndpoint={endpoint}"


@pytest.fixture(params=["gcs", "azure"])
def backend(request, monkeypatch, tmp_path):
    """(make(prefix) -> a port manager on the fake, the fake's objects as
    {(bucket, name): bytes}, the JAX package's manager class's maker)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    if request.param == "gcs":
        FakeGCSService.store, FakeGCSService.requests = {}, []
        srv, url = _serve(FakeGCSService)
        monkeypatch.setenv("STORAGE_EMULATOR_HOST", url)
        yield ("gcs", lambda prefix="": cloud.GCSStorageManager("ckpts", prefix),
               FakeGCSService.store,
               lambda prefix="": jcloud.GCSStorageManager("ckpts", prefix))
    else:
        FakeBlobService.store, FakeBlobService.blocks = {}, {}
        FakeBlobService.auth_failures, FakeBlobService.puts = [], []
        srv, url = _serve(FakeBlobService)
        yield ("azure",
               lambda prefix="": cloud.AzureStorageManager(
                   "ckpts", conn_str(url), prefix),
               FakeBlobService.store,
               lambda prefix="": jcloud.AzureStorageManager(
                   "ckpts", conn_str(url), prefix))
        assert FakeBlobService.auth_failures == []
    srv.shutdown()
    srv.server_close()


def _uploaded_names(kind):
    """Object names in the order the fake stored their content."""
    if kind == "gcs":
        return [n for m, _, n in FakeGCSService.requests if m == "POST"]
    return list(FakeBlobService.puts)


def test_upload_list_download_delete(backend, tmp_path):
    kind, make, store, _ = backend
    mgr = make("exp1")
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "model.bin").write_bytes(b"weights" * 100)
    (src / "sub" / "meta.json").write_text("{}")
    (src / "my model.bin").write_bytes(b"mm")  # needs percent-encoding
    mgr.upload(str(src), "ck-1")
    assert mgr.list_files("ck-1") == {
        "model.bin": 700, "sub/meta.json": 2, "my model.bin": 2}
    assert ("ckpts", "exp1/ck-1/model.bin") in store  # the prefix is kept
    dst = tmp_path / "dst"
    mgr.download("ck-1", str(dst))
    assert (dst / "model.bin").read_bytes() == b"weights" * 100
    assert (dst / "sub" / "meta.json").read_text() == "{}"
    assert (dst / "my model.bin").read_bytes() == b"mm"
    sel = tmp_path / "sel"
    mgr.download("ck-1", str(sel), selector=lambda rel: rel.endswith(".json"))
    assert sorted(os.listdir(sel)) == ["sub"]
    assert mgr.delete("ck-1", globs=["*.bin"]) == {"sub/meta.json": 2}
    assert mgr.list_files("ck-1") == {"sub/meta.json": 2}
    assert mgr.delete("ck-1") == {}
    assert mgr.list_files("ck-1") == {}


def test_azure_block_upload_of_a_large_file(monkeypatch, tmp_path):
    FakeBlobService.store, FakeBlobService.blocks = {}, {}
    FakeBlobService.auth_failures, FakeBlobService.puts = [], []
    srv, url = _serve(FakeBlobService)
    try:
        monkeypatch.setattr(AzureBlobClient, "BLOCK_SIZE", 1024)
        mgr = cloud.AzureStorageManager("ckpts", conn_str(url))
        src = tmp_path / "src"
        src.mkdir()
        payload = bytes(range(256)) * 20 + b"tail"  # 5 blocks and a bit
        (src / "shard.bin").write_bytes(payload)
        mgr.upload(str(src), "ck-big")
        dst = tmp_path / "dst"
        mgr.download("ck-big", str(dst))
        assert (dst / "shard.bin").read_bytes() == payload
        assert FakeBlobService.blocks == {}  # every block committed
        assert FakeBlobService.auth_failures == []
    finally:
        srv.shutdown()
        srv.server_close()


def test_store_path_and_restore_path_stage_and_clean_up(backend):
    kind, make, store, _ = backend
    mgr = make()
    with mgr.store_path() as (sid, path):
        with open(os.path.join(path, "state.pt"), "wb") as f:
            f.write(b"K" * 64)
    assert mgr.list_files(sid) == {"state.pt": 64}
    assert not os.path.exists(mgr.path_for(sid))  # staging removed
    with mgr.restore_path(sid) as rpath:
        with open(os.path.join(rpath, "state.pt"), "rb") as f:
            assert f.read() == b"K" * 64
    assert not os.path.exists(mgr.path_for(sid))
    with pytest.raises(FileNotFoundError):
        with mgr.restore_path("no-such-checkpoint"):
            pass


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(64, 33, generator=g),
                       "b": torch.randn(33, generator=g).to(torch.bfloat16)},
            "step": torch.tensor(7)}


@pytest.mark.parametrize("async_save", [True, False], ids=["async", "inline"])
def test_save_state_verify_restore_bitwise(backend, async_save):
    kind, make, store, _ = backend
    mgr = make("runs")
    ctx = CheckpointContext(mgr, trial_id=9, async_save=async_save)
    state = _state()
    sid = ctx.save_state(state, steps_completed=7)
    assert sid == "trial9-step7"
    ctx.wait()
    names = _uploaded_names(kind)
    prefix = "runs/trial9-step7/"
    assert names[-2:] == [prefix + _integrity.MANIFEST_FILE,
                          prefix + _integrity.COMMIT_FILE]
    assert sorted(names[:-2]) == [prefix + "metadata.json",
                                  prefix + "state/state.pt"]
    assert not os.path.exists(mgr.path_for(sid))  # no staging left
    assert ctx.local_reported[-1]["state"] == "COMPLETED"
    assert ctx.verify(sid) is True
    manifest = json.loads(store[("ckpts", prefix + "manifest.json")])
    assert manifest["files"] == {
        rel: {"size": size} for rel, size in mgr.list_files(sid).items()
        if rel not in (_integrity.MANIFEST_FILE, _integrity.COMMIT_FILE)}
    template = {"params": {"w": torch.zeros(64, 33),
                           "b": torch.zeros(33, dtype=torch.bfloat16)},
                "step": torch.tensor(0)}
    fresh = CheckpointContext(make("runs"), trial_id=9)
    got = fresh.restore_state(sid, template)
    for k in ("w", "b"):
        assert torch.equal(got["params"][k], state["params"][k])
        assert got["params"][k].dtype == state["params"][k].dtype
    assert int(got["step"]) == 7
    assert torch.equal(fresh.restore_params(sid)["w"], state["params"]["w"])
    assert fresh.load_metadata(sid)["steps_completed"] == 7
    assert not os.path.exists(mgr.path_for(sid))


def test_torn_uploads_are_refused(backend):
    kind, make, store, _ = backend
    mgr = make()
    ctx = CheckpointContext(mgr, trial_id=2)
    faultpoint.arm(_integrity.FAULT_COMMIT_DROP, "drop", count=1)
    try:
        torn = ctx.save_state(_state(), steps_completed=1)
    finally:
        faultpoint.disarm(_integrity.FAULT_COMMIT_DROP)
    assert _integrity.COMMIT_FILE not in mgr.list_files(torn)
    assert _integrity.MANIFEST_FILE in mgr.list_files(torn)
    with pytest.raises(_integrity.CorruptCheckpoint, match="COMMIT"):
        ctx.verify(torn)
    with pytest.raises(_integrity.CorruptCheckpoint, match="COMMIT"):
        ctx.restore_state(torn, _state())
    # A committed checkpoint whose state file went missing afterwards.
    sid = ctx.save_state(_state(), steps_completed=2)
    mgr.delete(sid, globs=["state/*"])
    with pytest.raises(_integrity.CorruptCheckpoint, match="missing file"):
        ctx.verify(sid)
    with pytest.raises(FileNotFoundError):
        ctx.verify("trial2-step99")


def test_file_checkpoints_leave_the_jax_packages_objects(backend, tmp_path):
    """store_path, upload with a selector, download with a selector,
    load_metadata and delete through both contexts, each into its own
    prefix of one bucket: the same objects, apart from the port's
    manifest and COMMIT on its upload (ids and times masked)."""
    kind, make, store, jmake = backend
    out = {}
    for pkg in ("jax", "torch"):
        ctx = (JCheckpoint(None, jmake(pkg), trial_id=1) if pkg == "jax"
               else CheckpointContext(make(pkg), trial_id=1))
        with ctx.store_path({"steps_completed": 4}) as (path, sid1):
            with open(os.path.join(path, "w.pt"), "wb") as f:
                f.write(b"w" * 40)
        src = tmp_path / pkg
        src.mkdir()
        (src / "keep.bin").write_bytes(b"k" * 9)
        (src / "drop.txt").write_text("x")
        sid2 = ctx.upload(str(src), selector=lambda n: n.endswith(".bin"))
        dst = tmp_path / f"{pkg}-dst"
        ctx.download(sid1, str(dst), selector=lambda rel: rel == "w.pt")
        assert os.listdir(dst) == ["w.pt"]
        assert ctx.load_metadata(sid1)["steps_completed"] == 4
        with ctx.restore_path(sid2) as p:
            assert open(os.path.join(p, "keep.bin"), "rb").read() == b"k" * 9
        objects = {}
        for (bucket, name), data in store.items():
            if not name.startswith(pkg + "/"):
                continue
            rel = name[len(pkg) + 1:].replace(sid1, "ID1").replace(sid2, "ID2")
            if rel.endswith("metadata.json"):
                data = {k: v for k, v in json.loads(data).items()
                        if k != "time"}
            objects[rel] = data
        ctx.delete(sid2)
        assert ctx._storage.list_files(sid2) == {}
        out[pkg] = objects
    assert sorted(set(out["torch"]) - set(out["jax"])) == [
        "ID2/COMMIT", "ID2/manifest.json"]
    assert {k: v for k, v in out["torch"].items() if k in out["jax"]} == \
        out["jax"]
    assert sorted(out["jax"]) == ["ID1/metadata.json", "ID1/w.pt",
                                  "ID2/keep.bin"]


def test_serve_replica_restores_a_remote_checkpoint(backend):
    from determined_tpu_torch.serve import task

    kind, make, store, _ = backend
    state = _state()
    CheckpointContext(make(), trial_id=3).save_state(state, 5)
    params = task._restore("trial3-step5", make(), 3)
    assert torch.equal(params["w"], state["params"]["w"])


def test_s3_names_boto3():
    with pytest.raises(RuntimeError, match="boto3"):
        from_config({"type": "s3", "bucket": "b"})


def test_gcs_names_its_sdk_when_it_does_not_import(monkeypatch):
    real = builtins.__import__

    def no_gcs(name, globals=None, locals=None, fromlist=(), level=0):
        if name.startswith("google.cloud") or (
                name == "google" and fromlist and "cloud" in fromlist):
            raise ImportError(f"No module named {name!r}")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_gcs)
    with pytest.raises(RuntimeError, match="google-cloud-storage"):
        from_config({"type": "gcs", "bucket": "b"})


def test_azure_needs_a_container():
    with pytest.raises(ValueError, match="container"):
        from_config({"type": "azure", "connection_string": conn_str("x")})
