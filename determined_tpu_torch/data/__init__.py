"""determined_tpu_torch.data — the input pipeline (counterpart of
determined_tpu/data/): a background thread stages each host batch on the
device ahead of the step that uses it (prefetch.py). The Trainer wires it
in by default; a trial opts out with `prefetch = False` or the
experiment config's `prefetch:` block."""

from determined_tpu_torch.data.prefetch import (  # noqa: F401
    FAULT_POINT_QUEUE,
    DevicePrefetcher,
    PrefetchConfig,
)
