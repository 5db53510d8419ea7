"""Produce a pretrained diffusion params file for the finetune example —
the PyTorch port's counterpart of examples/diffusion/pretrain.py.

Standalone (no master needed): trains the UNet for --steps with adamw
(lr 1e-4) on the synthetic set (or --data-path npz) and pickles the
params, in the JAX layout, to --out, which `finetune_asha.yaml` consumes
via `hyperparameters.pretrained_path`. From the root of a checkout:

    python -m examples.diffusion_cuda.pretrain --steps 500 --out pre.pkl

It runs on the first CUDA device unless `--device cpu` is given.
"""

import argparse

import numpy as np
import torch

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.models import diffusion
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.state import create_train_state
from determined_tpu_torch.train.step import make_train_step
from examples.diffusion_cuda.model_def import save_params, synthetic_images


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--model-size", default="base",
                    choices=["tiny", "base"])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--out", default="diffusion_pretrained.pkl")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = {"tiny": diffusion.Config.tiny(),
           "base": diffusion.Config()}[args.model_size]
    if args.data_path:
        with np.load(args.data_path) as d:
            images = d["images"].astype(np.float32)
    else:
        images = synthetic_images(2048, cfg.image_size)

    tx = optim.adamw(1e-4)
    state = create_train_state(
        lambda g: diffusion.init(g, cfg), tx,
        torch.Generator(device=device).manual_seed(0), device=device)
    step = make_train_step(
        lambda p, batch, rng: diffusion.loss_fn(p, batch, cfg, rng), tx)

    rng = np.random.default_rng(1)
    gen = torch.Generator(device=device).manual_seed(1)
    for i in range(args.steps):
        idx = rng.integers(0, len(images), args.batch)
        batch = {"images": torch.from_numpy(images[idx]).to(device)}
        state, metrics = step(state, batch, gen)
        if i % 50 == 0:
            print(f"step {i}: loss {float(metrics['loss']):.4f}", flush=True)
    save_params(state.params, args.out)
    print(f"saved pretrained params to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
