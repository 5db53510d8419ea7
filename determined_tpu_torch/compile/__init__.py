"""Compile farm of the port (docs/compile-farm-torch.md).

Counterpart of determined_tpu/compile/. The pieces:
  - `signature` — config signatures (the farm's queue/store key, mirrored
    by the native master) and step fingerprints (the kernel libraries'
    source-and-flags hashes and the runtime tag);
  - `bucketing` — batch-size shape canonicalization, applied by the
    Trainer to every training and validation batch;
  - `runtime` — the artifact FarmClient through which ops/_build.py
    resolves the kernel libraries on warm nodes;
  - `worker` — the background compile job, `python -m
    determined_tpu_torch.compile`.
"""

from determined_tpu_torch.compile.bucketing import (  # noqa: F401
    CompileConfig,
    bucket_size,
    bucketed_batch,
    bucketed_iter,
    pad_batch,
)
from determined_tpu_torch.compile.runtime import (  # noqa: F401
    FarmClient,
    aot_artifact_name,
)
from determined_tpu_torch.compile.signature import (  # noqa: F401
    config_signature,
    runtime_tag,
    step_fingerprint,
)
