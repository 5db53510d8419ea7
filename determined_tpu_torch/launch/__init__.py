"""Launch layers: one worker process per GPU slot
(counterpart of determined_tpu/launch/)."""
