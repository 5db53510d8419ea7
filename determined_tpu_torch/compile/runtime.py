"""Run-time side of the port's compile farm (docs/compile-farm-torch.md).

Counterpart of determined_tpu/compile/runtime.py. The port's artifact is a
built kernel library, `aot-kernel_<name>-<hash>-<runtime_tag>.bin`, stored
under one signature in the master's content-addressed blob store. A CUDA
graph cannot be serialised and there is no XLA cache, so neither is an
artifact.

`FarmClient` has the JAX client's surface and HTTP calls. It resolves
artifacts local-first (the agent prewarms `DET_COMPILE_AOT_DIR/<signature>/`
with every `aot-` file before the container starts) and falls back to
`GET /api/v1/compile_cache/{sig}`. Fresh builds upload in a background
thread, never on the step path. A failure here costs a build, never a
trial: the farm is an accelerator, not a dependency.
"""

from __future__ import annotations

import base64
import logging
import os
import threading
from typing import Any, Dict, List, Optional

from determined_tpu_torch.compile.signature import runtime_tag

logger = logging.getLogger("determined_tpu_torch.compile")

AOT_PREFIX = "aot-"


def aot_artifact_name(executable: str) -> str:
    return f"{AOT_PREFIX}{executable}-{runtime_tag()}.bin"


class FarmClient:
    """Fetch/upload compile artifacts for ONE signature.

    `signature` comes from DET_COMPILE_SIGNATURE (master-minted) in managed
    mode; local runs pass their own. A falsy signature disables the client
    (every method becomes a cheap no-op)."""

    def __init__(
        self,
        session: Any = None,
        signature: Optional[str] = None,
        aot_dir: Optional[str] = None,
    ):
        self.signature = signature if signature is not None else \
            os.environ.get("DET_COMPILE_SIGNATURE", "")
        self._session = session
        self.aot_dir = aot_dir if aot_dir is not None else \
            os.environ.get("DET_COMPILE_AOT_DIR", "")
        self._threads: List[threading.Thread] = []

    @property
    def enabled(self) -> bool:
        return bool(self.signature)

    # -- fetch ---------------------------------------------------------

    def _local_path(self, name: str) -> Optional[str]:
        if not self.aot_dir or not self.signature:
            return None
        path = os.path.join(self.aot_dir, self.signature, name)
        return path if os.path.isfile(path) else None

    def fetch(self, name: str) -> Optional[bytes]:
        """Artifact bytes: agent-prewarmed local dir first, then master."""
        if not self.enabled:
            return None
        path = self._local_path(name)
        if path is not None:
            try:
                with open(path, "rb") as f:
                    return f.read()
            except OSError:
                pass
        if self._session is None:
            return None
        try:
            resp = self._session.get(
                f"/api/v1/compile_cache/{self.signature}",
                params={"name": name})
        except Exception:
            logger.debug("compile_cache fetch failed", exc_info=True)
            return None
        for f in (resp or {}).get("files", []):
            if f.get("name") == name and f.get("b64"):
                return base64.b64decode(f["b64"])
        return None

    # -- upload --------------------------------------------------------

    def upload(self, files: Dict[str, bytes],
               compile_ms: Optional[float] = None,
               fingerprint: str = "") -> bool:
        if not self.enabled or self._session is None or not files:
            return False
        body: Dict[str, Any] = {
            "files": {n: base64.b64encode(b).decode()
                      for n, b in files.items()},
        }
        if compile_ms is not None:
            body["compile_ms"] = float(compile_ms)
        if fingerprint:
            body["fingerprint"] = fingerprint
        try:
            self._session.post(
                f"/api/v1/compile_cache/{self.signature}", body=body,
                idempotent=True)
            return True
        except Exception:
            # Best-effort by contract, like span flushes: a dead artifact
            # sink must never hurt the trial.
            logger.warning("compile artifact upload failed", exc_info=True)
            return False

    def upload_async(self, files: Dict[str, bytes],
                     compile_ms: Optional[float] = None) -> None:
        t = threading.Thread(
            target=self.upload, args=(files,),
            kwargs={"compile_ms": compile_ms},
            name="det-compile-upload", daemon=True)
        t.start()
        self._threads.append(t)

    def save_local(self, files: Dict[str, bytes]) -> bool:
        """Write artifacts into the node-local AOT dir (the same place the
        agent prewarms into), so the NEXT process on this node finds them
        without a master round-trip. Best-effort like upload."""
        if not self.signature or not self.aot_dir or not files:
            return False
        try:
            d = os.path.join(self.aot_dir, self.signature)
            os.makedirs(d, exist_ok=True)
            for name, data in files.items():
                tmp = os.path.join(d, name + ".tmp")
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, os.path.join(d, name))
            return True
        except OSError:
            logger.debug("local AOT save failed", exc_info=True)
            return False

    def wait(self, timeout: float = 30.0) -> None:
        """Join outstanding uploads (tests + clean trial exit)."""
        for t in self._threads:
            t.join(timeout)
        self._threads = [t for t in self._threads if t.is_alive()]
