"""Task entry points run by the agent (counterpart of
determined_tpu/exec/)."""
