#!/usr/bin/env python3
"""How far chip_smoke.py's CIFAR ResNet-18 trial drifts from itself over
its first steps, on the CPU in fp32: split over `tensor: 2` (a gloo world
of two processes) against one process, and one process against itself
with the stem's kernel moved by one fp32 ulp (the head starts at zero).

    python3 tools/cifar_split_drift.py [--steps 10] [--batch 128]

chip_smoke.py's phase 18b reads the split world's report windows against
world 1 on two cards. The split computes the head as two products of
half the classes and sums their input gradients (Megatron's f), where
one process computes one product: the same function in another rounding.
This tool shows, at 18b's batch, optimizer and steps, what such a
rounding-level difference grows to: the nudged run starts one ulp away
and the split run starts from the same params. Prints one JSON object:
each run's loss and grad norm at every step, and each step's relative
difference from the one-process run. Writes only under `--dir`.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"one": 1, "split": 2, "nudged": 1}


def worker(kind: str, rank: int, world: int, workdir: str, steps: int,
           batch: int) -> None:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from determined_tpu_torch import core
    from determined_tpu_torch.core._distributed import DistributedContext
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    Cifar = chip_smoke.cifar_trial_class()

    class Trial(Cifar):
        def init_params(self, rng):
            params = super().init_params(rng)
            if kind == "nudged":
                k = params["stem"]["kernel"]
                params["stem"]["kernel"] = torch.nextafter(
                    k, torch.full_like(k, float("inf")))
            return params

    dist = None
    if world > 1:
        dist = DistributedContext.from_allocation(
            "file://" + os.path.join(workdir, f"store_{kind}"), world, rank,
            backend="gloo")
    ctx = core.init(max_length=steps, distributed=dist,
                    checkpoint_dir=os.path.join(workdir, f"ckpt_{kind}"))
    hparams = {"global_batch_size": batch, "dtype": "float32",
               "mesh": {"data": 1, "tensor": world}}
    Trainer(Trial(TrialContext(hparams=hparams, core_context=ctx,
                               global_batch_size=batch)),
            core_context=ctx, device="cpu").fit(report_period=1)
    ctx.checkpoint.wait()
    if rank == 0:
        metrics = [r["metrics"] for r in ctx.train.local_training_metrics]
        with open(os.path.join(workdir, f"{kind}.json"), "w") as f:
            json.dump({key: [m[key] for m in metrics]
                       for key in ("loss", "grad_norm")}, f)
    ctx.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dir", default=os.path.join(ROOT, "build",
                                                  "cifar_split_drift"))
    ap.add_argument("--worker", nargs=3, metavar=("KIND", "RANK", "WORLD"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        kind, rank, world = args.worker
        worker(kind, int(rank), int(world), args.dir, args.steps, args.batch)
        return 0
    shutil.rmtree(args.dir, ignore_errors=True)
    os.makedirs(args.dir)
    threads = str(max(1, (os.cpu_count() or 2) // 2))
    env = dict(os.environ, OMP_NUM_THREADS=threads,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = {}
    for kind, world in RUNS.items():
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--steps",
             str(args.steps), "--batch", str(args.batch), "--dir", args.dir,
             "--worker", kind, str(r), str(world)], env=env, cwd=ROOT)
            for r in range(world)]
        if any(p.wait() != 0 for p in procs):
            print(f"{kind}: a rank failed", file=sys.stderr)
            return 1
        with open(os.path.join(args.dir, f"{kind}.json")) as f:
            runs[kind] = json.load(f)
    one = runs["one"]
    drift = {kind: {key: [abs(a - b) / abs(b) for a, b in zip(
        runs[kind][key], one[key])] for key in one}
        for kind in ("split", "nudged")}
    print(json.dumps({"steps": args.steps, "batch": args.batch,
                      "runs": runs, "relative_to_one": drift}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
