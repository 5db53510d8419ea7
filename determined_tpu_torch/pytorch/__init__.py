"""PyTorchTrial and DeepSpeedTrial on the port's core (counterpart of
determined_tpu/pytorch/).

Class-based trials, as in the reference (harness/determined/pytorch/): the
user overrides `__init__`, `train_batch`, `evaluate_batch` and
`build_*_data_loader`, and the Trainer owns the run loop, driven by the
searcher's operations and the port's Core API (checkpoints through
`store_path` / `upload(shard=True)` and `restore_path`, into any storage
backend of storage/). Models run on CUDA unless the context is given
`device="cpu"`; launched across processes they are wrapped in DDP over
NCCL, or left to torch's FSDP when it shards them. `ZeroOneEngine` is a
ZeRO-1 engine for DeepSpeedTrial.
"""

from determined_tpu_torch.pytorch._trial import (  # noqa: F401
    DataLoader,
    PyTorchTrial,
    PyTorchTrialContext,
    Trainer,
    TorchData,
)
from determined_tpu_torch.pytorch.deepspeed import (  # noqa: F401
    DeepSpeedTrial,
    DeepSpeedTrialContext,
    DeepSpeedTrainer,
    ModelParallelUnit,
)
from determined_tpu_torch.pytorch.zero import ZeroOneEngine  # noqa: F401
