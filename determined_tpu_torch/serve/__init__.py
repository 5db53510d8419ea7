"""GPT-2 serving on PyTorch and CUDA: paged KV, continuous batching, HTTP.

Counterpart of determined_tpu/serve/, MoE models included (warm AOT is
not ported yet; ROADMAP.md).

Layout:
  model.py      prefill / decode steps over the paged KV block pool or the
                dense slot lanes, with per-lane adapter tables
  kv_cache.py   KV block manager: paged admission accounting, refcounted
                prefix caching, copy-on-write
  engine.py     params + adapters + cache on the device; decode, every
                prefill bucket and the block copy captured as CUDA graphs;
                checkpoint restore through the integrity lineage
  scheduler.py  bounded admission queue + the continuous batcher
  tracing.py    per-request span trees (RequestTracer)
  http.py       HTTP front-end (generate/stats/metrics/health)
  task.py       replica entry point (`python -m determined_tpu_torch.serve`):
                local, or attached to a master (heartbeat, span sink)

Decode attention runs the hand-written CUDA kernel in
ops/csrc/paged_attention.cu (ops/paged_attention.py).
"""

from determined_tpu_torch.serve.engine import (
    ServingEngine, load_checkpoint_params)
from determined_tpu_torch.serve.kv_cache import BlockManager, KVBlockError
from determined_tpu_torch.serve.scheduler import (
    AdmissionQueue,
    ContinuousBatcher,
    Draining,
    QueueFull,
    Request,
)

__all__ = [
    "AdmissionQueue",
    "BlockManager",
    "ContinuousBatcher",
    "Draining",
    "KVBlockError",
    "QueueFull",
    "Request",
    "ServingEngine",
    "load_checkpoint_params",
]
