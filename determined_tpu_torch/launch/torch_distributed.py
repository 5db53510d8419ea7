"""torch.distributed launch layer: one worker process per GPU slot.

Counterpart of determined_tpu/launch/torch_distributed.py. PyTorch on GPUs
runs one process per device, so the launcher starts one worker per slot
the agent gave the allocation (`DET_SLOT_IDS`, a JSON list such as
`[0, 1]` or a comma list), each seeing only its own card
(`CUDA_VISIBLE_DEVICES` = its slot id), and wires the rendezvous from the
master-provided environment:

  nnodes     = DET_NUM_NODES      (hosts in the allocation)
  node_rank  = DET_NODE_RANK
  chief addr = DET_CHIEF_IP       (master rendezvous; 127.0.0.1 alone)
  port       = DET_TORCH_MASTER_PORT (default 29400)
  nproc      = --nproc-per-node | the number of slots | DET_NPROC_PER_NODE

Each worker gets the torch.distributed contract (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) plus
DET_TORCH_BACKEND, which `core.init()` forms the process group with:
nccl on a host with CUDA; gloo, which runs on the CPU, only when
DET_TORCH_BACKEND names it. Without CUDA and without that name the
launcher refuses to start. Output lines are prefixed with the global rank,
SIGTERM and SIGINT are forwarded to every worker, and the first worker to
fail takes the others down (survivors would wait in a collective until
its timeout).

    python -m determined_tpu_torch.launch.torch_distributed [--nproc-per-node N] -- cmd ...
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional


def pick_backend(env=None) -> str:
    """DET_TORCH_BACKEND when set (nccl | gloo), else nccl, which needs a
    CUDA device: a CPU run must name gloo."""
    env = os.environ if env is None else env
    named = env.get("DET_TORCH_BACKEND")
    if named:
        if named not in ("nccl", "gloo"):
            raise ValueError(f"DET_TORCH_BACKEND={named!r}: use nccl or gloo")
        return named
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device on this host: the workers' process group would "
            "be nccl; set DET_TORCH_BACKEND=gloo to run them on the CPU")
    return "nccl"


def slot_ids(env=None) -> List[int]:
    """The allocation's GPU slots from DET_SLOT_IDS ("[0, 1]" or "0,1");
    [] when unset."""
    env = os.environ if env is None else env
    raw = (env.get("DET_SLOT_IDS") or "").strip()
    if not raw:
        return []
    if raw.startswith("["):
        return [int(s) for s in json.loads(raw)]
    return [int(s) for s in raw.split(",") if s.strip()]


def worker_env(
    base_env: dict,
    *,
    node_rank: int,
    nnodes: int,
    local_rank: int,
    nproc_per_node: int,
    master_addr: str,
    master_port: int,
    backend: str,
    slot: Optional[int] = None,
) -> dict:
    """One worker's environment: the base, the torch.distributed contract,
    DET_TORCH_BACKEND and, for a GPU slot, CUDA_VISIBLE_DEVICES."""
    env = dict(base_env)
    env.update(
        RANK=str(node_rank * nproc_per_node + local_rank),
        WORLD_SIZE=str(nnodes * nproc_per_node),
        LOCAL_RANK=str(local_rank),
        LOCAL_WORLD_SIZE=str(nproc_per_node),
        MASTER_ADDR=master_addr,
        MASTER_PORT=str(master_port),
        DET_TORCH_BACKEND=backend,
    )
    if slot is not None:
        # The worker sees its card alone, as cuda:0.
        env["CUDA_VISIBLE_DEVICES"] = str(slot)
    return env


def _stream_prefixed(pipe, rank: int, out) -> None:
    for line in iter(pipe.readline, b""):
        out.write(f"[rank={rank}] ".encode() + line)
        out.flush()


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    nproc = 0
    if argv and argv[0] == "--nproc-per-node":
        nproc = int(argv[1])
        argv = argv[2:]
    if argv and argv[0] == "--":
        argv = argv[1:]
    if not argv:
        print("usage: torch_distributed [--nproc-per-node N] -- cmd ...",
              file=sys.stderr)
        return 2

    backend = pick_backend()
    slots = slot_ids()
    if nproc <= 0:
        nproc = len(slots) or int(os.environ.get("DET_NPROC_PER_NODE", "1"))
    if slots and len(slots) != nproc:
        raise ValueError(f"--nproc-per-node {nproc} but DET_SLOT_IDS names "
                         f"{len(slots)} slots")
    node_rank = int(os.environ.get("DET_NODE_RANK", "0"))
    nnodes = int(os.environ.get("DET_NUM_NODES", "1"))
    chief = os.environ.get("DET_CHIEF_IP", "127.0.0.1")
    port = int(os.environ.get("DET_TORCH_MASTER_PORT", "29400"))

    procs: List[subprocess.Popen] = []
    streams: List[threading.Thread] = []
    for local_rank in range(nproc):
        env = worker_env(
            os.environ.copy(), node_rank=node_rank, nnodes=nnodes,
            local_rank=local_rank, nproc_per_node=nproc, master_addr=chief,
            master_port=port, backend=backend,
            slot=slots[local_rank] if slots else None)
        p = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        rank = node_rank * nproc + local_rank
        t = threading.Thread(target=_stream_prefixed,
                             args=(p.stdout, rank, sys.stdout.buffer),
                             daemon=True)
        t.start()
        procs.append(p)
        streams.append(t)

    def forward(signum, frame):
        for p in procs:
            try:
                p.send_signal(signum)
            except ProcessLookupError:
                pass

    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)

    rc = 0
    alive = list(procs)
    while alive:
        for p in list(alive):
            code = p.poll()
            if code is None:
                continue
            alive.remove(p)
            if code != 0 and rc == 0:
                rc = code
                print(f"worker pid={p.pid} exited {code}; terminating "
                      f"{len(alive)} remaining worker(s)", file=sys.stderr)
                for q in alive:
                    try:
                        q.terminate()
                    except ProcessLookupError:
                        pass
        if alive:
            time.sleep(0.2)
    for t in streams:
        t.join(timeout=5)
    return rc


if __name__ == "__main__":
    sys.exit(main())
