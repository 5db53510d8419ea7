"""GPT-2 serving on PyTorch and CUDA: paged KV, continuous batching, HTTP.

Counterpart of determined_tpu/serve/ for the paged layout.

Layout:
  model.py      paged prefill / decode steps over the KV block pool
  kv_cache.py   KV block manager: paged admission accounting, refcounted
                prefix caching, copy-on-write
  engine.py     params + pool + block tables on the device, warm-up
  scheduler.py  bounded admission queue + the continuous batcher
  http.py       HTTP front-end (generate/stats/metrics/health)
  task.py       local entry point (`python -m determined_tpu_torch.serve`)

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
