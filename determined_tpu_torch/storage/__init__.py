"""Checkpoint storage backends (counterpart of determined_tpu/storage/).

A StorageManager maps a `checkpoint_storage` block to where checkpoints
live and how files get there: `shared_fs` and `directory` write in place;
`gcs` and `s3` go through their SDKs, imported lazily (a missing SDK
raises and names its package); `azure` speaks the Blob REST protocol on
the standard library (storage/azure.py). The cloud backends stage each
checkpoint in a local directory and copy it to the bucket.
"""

from determined_tpu_torch.storage.base import (  # noqa: F401
    StorageManager,
    default_checkpoint_dir,
    from_config,
)
