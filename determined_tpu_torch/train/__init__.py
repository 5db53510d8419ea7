"""Training: the trial API, the step, the optimizer and the Trainer
(counterpart of determined_tpu/train/)."""

from determined_tpu_torch.train.state import TrainState, create_train_state  # noqa: F401
from determined_tpu_torch.train.step import make_eval_step, make_train_step  # noqa: F401
from determined_tpu_torch.train.trainer import Trainer  # noqa: F401
from determined_tpu_torch.train.trial import TorchTrial, TrialContext  # noqa: F401
