"""Task prep: context download + rendezvous.

Counterpart of determined_tpu/exec/prep.py: downloads the experiment's
model-definition tarball into the workdir, performs the rendezvous
against the master (every host of the allocation up), writes
``$DET_RUN_DIR/info/rendezvous.json`` for `_info.get_cluster_info()` and
exports DET_CHIEF_IP for the launch layer. The coordinator address is the
chief host and the torch.distributed port the launcher's workers
rendezvous on (`TORCH_COORDINATOR_PORT`, DET_TORCH_MASTER_PORT's
default), where the JAX package names jax.distributed's.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import tarfile
from typing import Optional

from determined_tpu_torch.common.api import Session

logger = logging.getLogger("determined_tpu_torch.exec")

TORCH_COORDINATOR_PORT = 29400


def download_context(session: Session, task_id: str, workdir: str) -> None:
    """Extract the experiment's model-def tarball into the workdir."""
    resp = session.get(f"/api/v1/tasks/{task_id}/context")
    b64 = (resp or {}).get("b64_tgz") or ""
    if not b64:
        logger.info("no context directory for task %s", task_id)
        return
    raw = base64.b64decode(b64)
    with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
        for member in tar.getmembers():
            # refuse path escapes
            target = os.path.realpath(os.path.join(workdir, member.name))
            if not target.startswith(os.path.realpath(workdir)):
                raise RuntimeError(f"unsafe path in context tar: {member.name}")
        tar.extractall(workdir)
    logger.info("extracted context (%d bytes) into %s", len(raw), workdir)


def rendezvous(session: Session, allocation_id: str, run_dir: str) -> dict:
    """Block until every host of the allocation is up; persist the result."""
    resp = session.get(
        f"/api/v1/allocations/{allocation_id}/rendezvous",
        params={"timeout_seconds": 600},
        timeout=630.0,
    )
    addrs = resp["addresses"]
    rank = int(os.environ.get("DET_NODE_RANK", "0"))
    raw = os.environ.get("DET_SLOT_IDS", "[]").strip() or "[]"
    slot_ids = json.loads(raw) if raw.startswith("[") else \
        [int(s) for s in raw.split(",") if s]
    info = {
        "container_addrs": addrs,
        "container_rank": rank,
        "slot_ids": slot_ids,
        "coordinator_addr": f"{addrs[0]}:{TORCH_COORDINATOR_PORT}",
    }
    info_dir = os.path.join(run_dir, "info")
    os.makedirs(info_dir, exist_ok=True)
    with open(os.path.join(info_dir, "rendezvous.json"), "w") as f:
        json.dump(info, f)
    os.environ["DET_CHIEF_IP"] = addrs[0]
    return info


def prep(session: Optional[Session] = None) -> Optional[dict]:
    """Full prep flow; returns rendezvous info (None outside a cluster)."""
    master = os.environ.get("DET_MASTER")
    if not master:
        return None
    session = session or Session(master, os.environ.get("DET_SESSION_TOKEN"))
    workdir = os.environ.get("DET_WORKDIR", os.getcwd())
    run_dir = os.environ.get("DET_RUN_DIR", workdir)
    task_id = os.environ.get("DET_TASK_ID", "")
    allocation_id = os.environ.get("DET_ALLOCATION_ID", "")
    if task_id:
        download_context(session, task_id, workdir)
    if allocation_id:
        return rendezvous(session, allocation_id, run_dir)
    return None
