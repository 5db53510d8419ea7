"""Diffusion finetune trial on CUDA devices — the PyTorch port's
counterpart of examples/diffusion/model_def.py (the "Stable Diffusion
finetune + adaptive_asha" workload, here the DDPM UNet of
determined_tpu_torch/models/diffusion.py).

The same hparams (`model_size`, `global_batch_size`, `learning_rate`,
`grad_clip`, `weight_decay`, `pretrained_path`, `data_path`), the same
data (an `.npz` with `images` [N, H, W, 3] in [-1, 1], a tail slice held
out, else the same procedural set), the same optimizer chain
(clip_by_global_norm, then adamw with weight decay) and the same
evaluation: the validation noise comes from a generator pinned to seed
1234 at every batch, so that ASHA ranks trials on a comparable metric.

Finetune contract: `hyperparameters.pretrained_path` names a params
pickle written by `pretrain.py` or by `save_params`, in the JAX layout
(a tree of numpy arrays, HWIO kernels, levels as lists), which is also
what the JAX example's `pretrain.py` writes: either package's file
loads in the other. A set-but-missing path is an error, and so is a
checkpoint directory. It imports only the port. Launched with the
`DET_*` variables an agent sets (finetune_asha.yaml), `python3
model_def.py` is a managed trial on CUDA; in local mode `core.init()`
needs a `max_length`. A `mesh` hparam may set `tensor` (the UNet's
convs, time projections and attention split by channels,
models/diffusion.py) and `context` (computed replicated) beside `data`
and `fsdp`.
"""

import os
import pickle

import numpy as np
import torch

from determined_tpu_torch import core
from determined_tpu_torch.models import diffusion
from determined_tpu_torch.parallel.mesh import batch_shard
from determined_tpu_torch.train import TorchTrial, Trainer, optim
from determined_tpu_torch.train.trial import TrialContext

# The validation noise's seed (the JAX example pins PRNGKey(1234)).
EVAL_SEED = 1234


def synthetic_images(n, size, seed=0):
    """[-1,1] float32 [n, size, size, 3]: colored disks and squares over
    smooth two-color gradients — learnable low-frequency structure."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        c0, c1 = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
        grad = yy[..., None] * c0 + (1 - yy)[..., None] * c1
        cx, cy = rng.uniform(0.25, 0.75, 2)
        r = rng.uniform(0.1, 0.3)
        col = rng.uniform(-1, 1, 3).astype(np.float32)
        if rng.random() < 0.5:
            mask = ((xx - cx) ** 2 + (yy - cy) ** 2) < r * r
        else:
            mask = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
        img = np.where(mask[..., None], col, grad)
        imgs[i] = np.clip(img, -1, 1)
    return imgs


def load_params(path):
    """The params pickle at `path` as a tree of numpy arrays in the JAX
    layout (`diffusion.params_from_numpy` makes the port's tree of it)."""
    if os.path.isdir(path):
        raise ValueError(
            f"pretrained_path must be a params pickle (pretrain.py --out), "
            f"not a checkpoint directory: {path}. To fine-tune from a "
            f"platform checkpoint, resume the experiment instead, or export "
            f"its params with save_params().")
    with open(path, "rb") as f:
        return pickle.load(f)


def save_params(params, path):
    """Pickle the port's params in the JAX layout (numpy arrays)."""
    with open(path, "wb") as f:
        pickle.dump(diffusion.params_to_numpy(params), f)


class DiffusionTrial(TorchTrial):
    def __init__(self, context: TrialContext):
        super().__init__(context)
        hp = context.hparams
        size = {"tiny": diffusion.Config.tiny(),
                "base": diffusion.Config()}[hp.get("model_size", "base")]
        self.cfg = size
        self.pretrained_path = hp.get("pretrained_path")
        if self.pretrained_path and not os.path.exists(self.pretrained_path):
            raise FileNotFoundError(
                f"pretrained_path set but missing: {self.pretrained_path} — "
                f"refusing to silently train from scratch")
        self._pretrained = None  # loaded once, cached across init calls
        self._eval_draws = {}  # the pinned validation draws, by shape
        data_path = hp.get("data_path")
        if data_path and os.path.exists(data_path):
            with np.load(data_path) as d:
                images = d["images"].astype(np.float32)
            # Hold out a tail slice: ASHA ranks on validation_loss, so the
            # metric must come from the data actually being trained on.
            n_val = max(32, len(images) // 10)
            self.images = images[:-n_val]
            self.val_images = images[-n_val:]
        else:
            self.images = synthetic_images(2048, self.cfg.image_size)
            self.val_images = synthetic_images(
                256, self.cfg.image_size, seed=7)

    def init_params(self, rng):
        if self.pretrained_path:
            if self._pretrained is None:
                self._pretrained = load_params(self.pretrained_path)
            return diffusion.params_from_numpy(self._pretrained, rng.device)
        return diffusion.init(rng, self.cfg)

    def loss(self, params, batch, rng):
        return diffusion.loss_fn(params, batch, self.cfg, rng)

    def param_logical_axes(self):
        return diffusion.param_logical_axes(self.cfg)

    def optimizer(self):
        lr = float(self.context.get_hparam("learning_rate", 1e-4))
        clip = float(self.context.get_hparam("grad_clip", 1.0))
        return optim.chain(
            optim.clip_by_global_norm(clip),
            optim.adamw(lr, weight_decay=float(
                self.context.get_hparam("weight_decay", 0.0))),
        )

    def _rows(self, batch):
        """This rank's rows of a global batch; one process holds the
        whole batch."""
        d = self.context.distributed
        if d.size == 1:
            return batch
        i, count = batch_shard(self.mesh_config(), d.rank, d.size)
        n = len(batch["images"]) // count
        return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}

    def build_training_data(self):
        b = self.context.global_batch_size
        rng = np.random.default_rng(1)
        n = len(self.images)
        while True:
            idx = rng.integers(0, n, b)
            yield self._rows({"images": self.images[idx]})

    def build_validation_data(self):
        b = max(self.context.global_batch_size, 32)
        for i in range(0, len(self.val_images) - b + 1, b):
            yield self._rows({"images": self.val_images[i:i + b]})

    def evaluate(self, params, batch):
        # A pinned generator: the validation metric must be comparable
        # across steps and trials (ASHA ranks on it). Its draws are the
        # same at every call of a shape, so they are drawn once a shape
        # and kept: a captured eval step replays over them, where a
        # generator made inside the graph would draw anew each replay.
        x0 = batch["images"]
        key = (tuple(x0.shape), x0.device)
        if key not in self._eval_draws:
            gen = torch.Generator(device=x0.device).manual_seed(EVAL_SEED)
            t = torch.randint(0, self.cfg.timesteps, (x0.shape[0],),
                              generator=gen, device=x0.device)
            eps = torch.randn(x0.shape, generator=gen, device=x0.device)
            self._eval_draws[key] = (t, eps)
        loss, _ = diffusion.loss_from_noise(params, x0, *self._eval_draws[key],
                                            self.cfg)
        return {"validation_loss": loss}


if __name__ == "__main__":
    with core.init() as ctx:
        trial = DiffusionTrial(
            TrialContext(hparams=ctx.hparams, core_context=ctx,
                         n_devices=ctx.distributed.size)
        )
        Trainer(trial, core_context=ctx).fit(report_period=10)
