"""Compile-side helpers of the port.

Counterpart of determined_tpu/compile/: so far only `bucketing` (the
batch-size buckets DTL205 reads). The compile worker's trial loader is
ROADMAP.md Queue 1 item 9.
"""
