"""Preflight fixture for the port: the bad fixture's sharded, sync-free
twin, which every preflight rule passes. The 32 MiB embedding names its
logical axes and the mesh (`data` 2 x `fsdp` 4) shards its "embed" dim
four ways; the loss keeps its metrics on the device."""

import numpy as np
import torch

from determined_tpu_torch.train import TorchTrial


class CleanTrial(TorchTrial):
    def init_params(self, rng):
        return {
            "embedding": torch.randn(32768, 256, generator=rng,
                                     device=rng.device) * 0.02,
            "head": torch.randn(256, 8, generator=rng,
                                device=rng.device) * 0.02,
        }

    def param_logical_axes(self):
        return {"embedding": ("embed", None), "head": (None, None)}

    def loss(self, params, batch, rng):
        x = params["embedding"][batch["tokens"].long()]
        logits = x.mean(dim=1) @ params["head"]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, batch["labels"].long()[:, None])[:, 0]
        loss = nll.mean()
        return loss, {"loss_scalar": loss.detach()}

    def build_training_data(self):
        rng = np.random.default_rng(0)
        while True:
            yield {
                "tokens": rng.integers(0, 32768, (64, 16)),
                "labels": rng.integers(0, 8, (64,)).astype(np.int32),
            }
