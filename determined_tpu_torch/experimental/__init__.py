"""Experimental APIs (counterpart of determined_tpu/experimental/): the
unmanaged-run Core API, `core_v2`."""
