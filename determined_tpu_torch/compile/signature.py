"""Compile-farm keys of the port (docs/compile-farm-torch.md).

Counterpart of determined_tpu/compile/signature.py, with two levels:

- **config signature**: computed from (entrypoint, model-def hash, slots,
  the full hparam set with `global_batch_size` bucketed), without running
  anything. `canonical_hparams` and `config_signature` are the JAX
  package's, string for string, so the native master's key
  (native/master/master_compile.cc) names the same trial for both
  packages. It is the compile job's queue key and the artifact store's
  address.

- **step fingerprint**: what the artifacts depend on. The port runs its
  steps eagerly: the only compiled code is the kernel libraries, built by
  `nvcc` from ops/csrc/. So the fingerprint hashes each library's
  source-and-flags hash (`ops._build.digest`) and the runtime tag, and
  nothing of the trial: an lr sweep, or any two trials on one checkout,
  build once and link the rest. (The JAX fingerprint hashes the traced
  jaxpr of the train step, since XLA compiles the whole step.)

`runtime_tag()` names the platform a library loads on: the torch and CUDA
versions, the target arch of the nvcc flags, and the host's machine and
OS. It is computed without `nvcc` and without a card, so a warm node can
name its artifacts.
"""

from __future__ import annotations

import hashlib
import json
import platform
import sys
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from determined_tpu_torch.compile.bucketing import CompileConfig, bucket_size
from determined_tpu_torch.ops import _build

SIGNATURE_VERSION = "det-compile-v1"


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def runtime_tag() -> str:
    """Short tag of the platform a built library loads on: a library built
    under another tag is never offered to this process."""
    return _sha("|".join([
        torch.__version__, str(torch.version.cuda), _build.TARGET_ARCH,
        platform.machine(), sys.platform]))[:12]


def canonical_hparams(hparams: Dict[str, Any],
                      cfg: Optional[CompileConfig] = None) -> str:
    """Sorted `k=<json>` rendering of the hparam dict, with
    global_batch_size replaced by its bucket when bucketing is on. The
    native master builds the identical string (master_compile.cc) — keep
    the two in lockstep."""
    cfg = cfg or CompileConfig()
    parts = []
    for k in sorted(hparams or {}):
        v = hparams[k]
        if k == "global_batch_size" and cfg.bucket_batch_sizes and \
                isinstance(v, int) and not isinstance(v, bool):
            v = bucket_size(v, cfg.buckets)
        parts.append(f"{k}={json.dumps(v, sort_keys=True)}")
    return ";".join(parts)


def config_signature(
    hparams: Dict[str, Any],
    entrypoint: Any = "",
    model_def_hash: str = "",
    slots: int = 1,
    cfg: Optional[CompileConfig] = None,
) -> str:
    """The compile-farm grouping key for one trial (mirrors the native
    master's compile_signature_locked)."""
    ep = entrypoint if isinstance(entrypoint, str) else json.dumps(entrypoint)
    return _sha("|".join([
        SIGNATURE_VERSION, ep, model_def_hash or "", str(int(slots)),
        canonical_hparams(hparams, cfg),
    ]))


def step_fingerprint(libraries: Sequence[str] = _build.SOURCES
                     ) -> Tuple[str, Dict[str, Any]]:
    """(fingerprint hex, detail) over what the farm's artifacts depend on:
    each kernel library's source-and-flags hash and the runtime tag."""
    detail = {
        "libraries": {name: _build.digest(name) for name in libraries},
        "runtime_tag": runtime_tag(),
    }
    return _sha(json.dumps(detail, sort_keys=True)), detail
