"""ZeRO-1 engine: a deepspeed-engine-shaped optimizer-state-sharding
runtime for DeepSpeedTrial subclasses.

The port's copy of determined_tpu/pytorch/zero.py. Reference semantics:
deepspeed ZeRO stage 1 as used by `examples/deepspeed/gpt_neox/zero1.yaml`
(reference harness/determined/pytorch/deepspeed/_deepspeed_trial.py drives
the engine; the engine itself lives in the deepspeed library). The
partitioned update maps onto torch.distributed collectives on the process
group the run formed (NCCL between GPUs, gloo on the CPU):

  - gradients are averaged with flat-bucket all_reduces (at most 32 MiB a
    bucket, one bucket per (dtype, device));
  - each data-parallel rank owns a contiguous slice of the parameter list
    (balanced by numel) and keeps optimizer state ONLY for that slice —
    optimizer memory per device drops ~1/world;
  - after the owner applies its slice's update, updated parameters are
    rebroadcast from their owners (the all-gather leg of ZeRO-1), in
    buckets capped the same way.

Checkpoints are engine-sharded like deepspeed's: every rank writes its own
optimizer-state shard; the full module state is written by rank 0 only.
`DeepSpeedTrainer._save` uploads with `shard=True`, so all shards land in
one platform checkpoint.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

logger = logging.getLogger("determined_tpu_torch.pytorch.zero")


def _dist():
    """The process group the launch layer initialised, or None single-proc."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed
    return None


def _partition(params: List[torch.nn.Parameter], world: int) -> List[int]:
    """Greedy balanced assignment of params to ranks by numel; returns
    owner rank per param (ownership may interleave). The guarantee the
    collectives rely on is determinism: all ranks iterate the same module
    in the same order, so every rank computes the same assignment."""
    owners = [0] * len(params)
    loads = [0] * world
    # Stable greedy: walk params in order, give each to the lightest rank.
    # All ranks iterate the same module in the same order → same answer.
    for i, p in enumerate(params):
        r = loads.index(min(loads))
        owners[i] = r
        loads[r] += p.numel()
    return owners


class ZeroOneEngine:
    """Deepspeed-engine contract (train_micro_batch_size_per_gpu /
    gradient_accumulation_steps / __call__ / backward / step /
    save_checkpoint / load_checkpoint) with ZeRO-1 partitioned optimizer
    semantics over torch.distributed."""

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer_factory: Callable[[Iterable[torch.nn.Parameter]],
                                    torch.optim.Optimizer],
        *,
        micro_batch_size: int,
        gradient_accumulation: int = 1,
    ):
        self.module = model
        self._micro_bs = int(micro_batch_size)
        self._grad_accum = max(1, int(gradient_accumulation))
        self._micro_steps = 0

        dist = _dist()
        self._world = dist.get_world_size() if dist else 1
        self._rank = dist.get_rank() if dist else 0
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._owners = _partition(self._params, self._world)
        owned = [p for p, o in zip(self._params, self._owners)
                 if o == self._rank]
        # The optimizer only ever sees this rank's slice — that IS the
        # ZeRO-1 memory saving (state for ~1/world of the params).
        self.optimizer = optimizer_factory(owned if owned else
                                           [torch.nn.Parameter(torch.zeros(1))])
        self._owned = owned
        if self._world > 1:
            logger.info(
                "zero1: rank %d/%d owns %d/%d params (%d elems)",
                self._rank, self._world, len(owned), len(self._params),
                sum(p.numel() for p in owned))

    # -- deepspeed contract -------------------------------------------
    def train_micro_batch_size_per_gpu(self) -> int:
        return self._micro_bs

    def gradient_accumulation_steps(self) -> int:
        return self._grad_accum

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.module(*args, **kwargs)

    def backward(self, loss: torch.Tensor) -> None:
        (loss / self._grad_accum).backward()

    def step(self) -> None:
        """Advance one microbatch; at the accumulation boundary run the
        partitioned update (all_reduce grads → owner step → rebroadcast)."""
        self._micro_steps += 1
        if self._micro_steps % self._grad_accum != 0:
            return
        dist = _dist()
        if dist is not None and self._world > 1:
            self._allreduce_grads(dist)
        self.optimizer.step()
        for p in self._params:
            p.grad = None
        if dist is not None and self._world > 1:
            self._rebroadcast_params(dist)

    def _allreduce_grads(self, dist) -> None:
        """Flat-bucket gradient averaging: one collective per ~32MB bucket
        instead of one per tensor (launch latency dominates small
        collectives on both gloo and NCCL). Buckets group by (dtype,
        device) — mixed-precision models carry bf16 and fp32 grads and
        torch.cat refuses to mix them."""
        LIMIT = 32 << 20
        buckets: Dict[Any, List[torch.Tensor]] = {}
        sizes: Dict[Any, int] = {}

        def flush(key: Any) -> None:
            bucket = buckets.pop(key, [])
            sizes.pop(key, 0)
            if not bucket:
                return
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat)
            flat /= self._world
            off = 0
            for g in bucket:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            key = (p.grad.dtype, p.grad.device)
            buckets.setdefault(key, []).append(p.grad)
            sizes[key] = sizes.get(key, 0) + \
                p.grad.numel() * p.grad.element_size()
            if sizes[key] >= LIMIT:
                flush(key)
        for key in list(buckets):
            flush(key)

    def _rebroadcast_params(self, dist) -> None:
        """The all-gather leg of ZeRO-1: owners publish their updated
        params. Flat-bucketed per (owner, dtype, device) for the same
        launch-latency reason as the gradient path — one broadcast per
        parameter would dominate step time on a 290-tensor model.
        Buckets flush at the same ~32MB cap as _allreduce_grads: an
        uncapped torch.cat materializes a contiguous copy of ~1/world of
        ALL parameters per bucket every optimizer step (plus the
        copy-back), a transient spike of hundreds of MB at larger
        configs. Flush order is deterministic and identical on all ranks
        (same module walk, same sizes), which the collectives require."""
        LIMIT = 32 << 20
        with torch.no_grad():
            buckets: Dict[Any, List[torch.nn.Parameter]] = {}
            sizes: Dict[Any, int] = {}

            def flush(key: Any) -> None:
                ps = buckets.pop(key, [])
                sizes.pop(key, 0)
                if not ps:
                    return
                flat = torch.cat([p.data.reshape(-1) for p in ps])
                dist.broadcast(flat, src=key[0])
                off = 0
                for p in ps:
                    p.data.copy_(flat[off:off + p.numel()].view_as(p))
                    off += p.numel()

            for p, owner in zip(self._params, self._owners):
                key = (owner, p.dtype, p.device)
                buckets.setdefault(key, []).append(p)
                sizes[key] = sizes.get(key, 0) + p.numel() * p.element_size()
                if sizes[key] >= LIMIT:
                    flush(key)
            for key in sorted(list(buckets), key=str):
                flush(key)

    # -- engine-sharded checkpoints -----------------------------------
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None) -> None:
        tag = tag or "zero1"
        os.makedirs(save_dir, exist_ok=True)
        if self._rank == 0:
            torch.save(self.module.state_dict(),
                       os.path.join(save_dir, f"{tag}-model.pt"))
        torch.save(
            {"optimizer": self.optimizer.state_dict(),
             "world": self._world, "rank": self._rank},
            os.path.join(save_dir, f"{tag}-opt-rank{self._rank}.pt"))

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None) -> None:
        tag = tag or "zero1"
        model_path = os.path.join(load_dir, f"{tag}-model.pt")
        self.module.load_state_dict(
            torch.load(model_path, weights_only=False))
        shard = os.path.join(load_dir, f"{tag}-opt-rank{self._rank}.pt")
        if os.path.exists(shard):
            state = torch.load(shard, weights_only=False)
            if state.get("world") == self._world:
                self.optimizer.load_state_dict(state["optimizer"])
            else:
                # Elastic resume at a different world size: params are
                # restored exactly; momentum restarts (same policy as a
                # deepspeed universal-checkpoint-less reshard).
                logger.warning(
                    "zero1: world size changed %s -> %s; optimizer state "
                    "reset", state.get("world"), self._world)

    # -- introspection (memory claim must be testable) -----------------
    def optimizer_state_numel(self) -> int:
        """Elements held in optimizer state on THIS rank."""
        total = 0
        for group_state in self.optimizer.state.values():
            for v in group_state.values():
                if torch.is_tensor(v):
                    total += v.numel()
        return total
