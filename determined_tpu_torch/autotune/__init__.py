"""Autotune — the port's counterpart of determined_tpu/autotune/, the
analogue of DeepSpeed Autotune (dsat).

Reference: harness/determined/pytorch/dsat/_dsat_search_method.py — a
custom-searcher workflow that profiles a model then searches deployment
knobs (ZeRO stage, micro-batch size) for throughput. The knobs that matter
are the per-card batch size and rematerialisation: bigger batches
amortize the step's fixed costs until the card runs out of memory
(`torch.OutOfMemoryError` ends the trial); remat trades FLOPs for memory
and changes where that cliff sits.

`BatchSizeSearchMethod` drives trials through the custom-searcher API:
doubling the global batch size until a trial fails (the OOM cliff), then
narrowing with a binary search between the last good and first bad size,
ranking survivors by reported throughput (searcher metric
`samples_per_second`, larger is better).
"""

from determined_tpu_torch.autotune._batch_size import (  # noqa: F401
    BatchSizeSearchMethod,
)
