"""Compile-farm worker of the port: one background build job
(docs/compile-farm-torch.md).

Counterpart of determined_tpu/compile/worker.py, with its environment
contract and its requests to the master. The worker:

  1. downloads the experiment's model-def context and instantiates the trial
     (the port's preflight loader), and resolves its `CompileConfig`;
  2. fingerprints what the artifacts depend on (the kernel libraries'
     source-and-flags hashes and the runtime tag); if an already-DONE job
     has the same fingerprint it LINKS that job's artifacts to this
     signature and exits without building;
  3. otherwise builds every library under ops/csrc/ with `nvcc` (the
     target arch is fixed by the flags, so no card is needed), uploads them
     to `POST /api/v1/compile_cache/{signature}` and marks the job DONE.

The libraries are also left in this node's kernel directory
(`ops._build.kernel_dir()`), so the compiling node itself is warm.

Environment contract (set by the master's dispatch, master_compile.cc):
  DET_MASTER, DET_SESSION_TOKEN, DET_COMPILE_SIGNATURE,
  DET_COMPILE_HPARAMS (json), DET_COMPILE_SLOTS, DET_EXPERIMENT_ID,
  DET_EXPERIMENT_CONFIG (json).
"""

from __future__ import annotations

import base64
import concurrent.futures
import io
import json
import logging
import os
import sys
import tarfile
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

logger = logging.getLogger("determined_tpu_torch.compile.worker")


def _extract_model_def(b64: str, workdir: str) -> None:
    raw = base64.b64decode(b64)
    with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
        for member in tar.getmembers():
            target = os.path.realpath(os.path.join(workdir, member.name))
            if not target.startswith(os.path.realpath(workdir)):
                raise RuntimeError(
                    f"unsafe path in context tar: {member.name}")
        tar.extractall(workdir)


def _load_trial(workdir: str, hparams: Dict[str, Any], slots: int):
    from determined_tpu_torch.analysis._preflight import (
        find_trial_classes,
        load_trial,
    )

    classes = find_trial_classes(workdir)
    if not classes:
        raise RuntimeError("no TorchTrial subclass in the model definition; "
                           "only Trainer-based trials are farm-compilable")
    path, class_name = classes[0]
    return load_trial(path, class_name, hparams, slots)


def build_libraries() -> Tuple[Dict[str, float], Dict[str, bytes]]:
    """`nvcc` every library under ops/csrc/ into a scratch directory, one
    process a source, all started together, and copy each into this node's
    kernel directory; -> ({name: build seconds}, {artifact name: bytes})."""
    from determined_tpu_torch.ops import _build

    files: Dict[str, bytes] = {}
    with tempfile.TemporaryDirectory(prefix="det-kernels-") as tmp:
        outs = {n: Path(tmp) / _build.library_path(n).name
                for n in _build.SOURCES}
        with concurrent.futures.ThreadPoolExecutor(len(outs)) as pool:
            secs = dict(zip(outs, pool.map(
                lambda n: _build.compile_library(n, outs[n]), outs)))
        for name, out in outs.items():
            data = out.read_bytes()
            files[_build.artifact_name(name)] = data
            if not _build.library_path(name).exists():
                _build.write_atomic(_build.library_path(name), data)
    return secs, files


def run_job(session, signature: str, hparams: Dict[str, Any], slots: int,
            experiment_id: int, config: Dict[str, Any],
            workdir: Optional[str] = None) -> Dict[str, Any]:
    """Execute one compile job; returns a summary dict. Raises on failure
    (the caller reports FAILED)."""
    from determined_tpu_torch.compile.bucketing import CompileConfig
    from determined_tpu_torch.compile.runtime import FarmClient
    from determined_tpu_torch.compile.signature import step_fingerprint

    t_start = time.time()
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="det-compile-")
        resp = session.get(f"/api/v1/experiments/{experiment_id}/model_def")
        b64 = (resp or {}).get("b64_tgz") or ""
        if not b64:
            raise RuntimeError(
                f"experiment {experiment_id} has no model definition")
        _extract_model_def(b64, workdir)

    trial = _load_trial(workdir, hparams, slots)
    cfg = CompileConfig.resolve(trial, config)
    client = FarmClient(session, signature)

    # Fingerprint first: it is a few hashes, and the same libraries may
    # already be built under another signature.
    fingerprint, detail = step_fingerprint()
    try:
        done = session.get("/api/v1/compile_jobs",
                           params={"state": "DONE",
                                   "fingerprint": fingerprint})
    except Exception:
        done = {}
    for job in (done or {}).get("jobs", []):
        other = job.get("signature", "")
        if other and other != signature:
            session.post(f"/api/v1/compile_jobs/{signature}/link",
                         body={"from": other, "fingerprint": fingerprint},
                         idempotent=True)
            return {"signature": signature, "linked_from": other,
                    "fingerprint": fingerprint,
                    "wall_s": round(time.time() - t_start, 2)}

    t0 = time.time()
    secs, files = build_libraries()
    compile_ms = (time.time() - t0) * 1000.0
    client.upload(files, compile_ms=compile_ms, fingerprint=fingerprint)
    session.post(f"/api/v1/compile_jobs/{signature}",
                 body={"state": "DONE", "fingerprint": fingerprint,
                       "compile_ms": compile_ms},
                 idempotent=True)
    return {"signature": signature, "fingerprint": fingerprint,
            "compile_ms": round(compile_ms, 1), "artifacts": len(files),
            "bytes": sum(len(b) for b in files.values()),
            "build_seconds": {n: round(s, 3) for n, s in secs.items()},
            "runtime_tag": detail["runtime_tag"],
            "bucket_batch_sizes": cfg.bucket_batch_sizes,
            "wall_s": round(time.time() - t_start, 2)}


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    from determined_tpu_torch.common.api import Session

    master = os.environ.get("DET_MASTER", "")
    token = os.environ.get("DET_SESSION_TOKEN", "")
    signature = os.environ.get("DET_COMPILE_SIGNATURE", "")
    if not master or not signature:
        print("compile worker: DET_MASTER and DET_COMPILE_SIGNATURE required",
              file=sys.stderr)
        return 2
    hparams = json.loads(os.environ.get("DET_COMPILE_HPARAMS", "{}"))
    slots = int(os.environ.get("DET_COMPILE_SLOTS", "1"))
    experiment_id = int(os.environ.get("DET_EXPERIMENT_ID", "0"))
    config = json.loads(os.environ.get("DET_EXPERIMENT_CONFIG", "{}"))
    session = Session(master, token)
    try:
        summary = run_job(session, signature, hparams, slots, experiment_id,
                          config)
    except Exception as e:
        logger.exception("compile job %s failed", signature[:12])
        try:
            session.post(f"/api/v1/compile_jobs/{signature}",
                         body={"state": "FAILED",
                               "error": f"{type(e).__name__}: {e}"},
                         idempotent=True)
        except Exception:
            pass
        return 1
    print(json.dumps(summary))
    return 0
