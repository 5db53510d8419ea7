"""Experimental APIs (counterpart of determined_tpu/experimental/): the
Python SDK client (reference: determined.experimental.client) and the
unmanaged-run Core API, `core_v2`."""

from determined_tpu_torch.experimental.client import (  # noqa: F401
    Checkpoint,
    Determined,
    Experiment,
    Model,
    ModelVersion,
    Trial,
    create_experiment,
    login,
)
