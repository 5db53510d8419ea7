#!/usr/bin/env python3
"""Which torch.distributed backend carries two ranks on ONE CUDA card,
and which collectives of the port's fsdp path it takes on CUDA tensors.

    python3 tools/two_ranks_one_card.py [--out build/two_ranks.json]

For each backend (nccl, gloo) two processes form a group over
tcp://127.0.0.1 on the same card (cuda:0) and try, on CUDA tensors, each
collective the fsdp train step runs: `all_reduce` (the metrics' mean,
the global norm's shard sums, DTensor's Partial -> Replicate),
`all_gather_into_tensor` (a sharded leaf gathered before use),
`reduce_scatter_tensor` (its gradient, Partial -> Shard), `broadcast`,
and the DTensor redistributions themselves (a gather of a dim-0 and of a
dim-1 shard, a reduce-scatter and an all-reduce of a Partial). Each op runs in a
fresh pair of processes, so one that crashes a process (gloo on CUDA
tensors may) does not hide the others. Prints one JSON object per
backend: {"backend", "ops": {op: "ok" | the error | the exit code and
the output's tail}}. A pair that hangs past the timeout is killed and
reported as such.
"""

import json
import os
import socket
import subprocess
import sys

TIMEOUT_S = 120


OPS = ("all_reduce", "broadcast", "all_gather_into_tensor",
       "reduce_scatter_tensor", "dtensor Shard(0)->Replicate",
       "dtensor Shard->Replicate",
       "dtensor Partial(avg)->Shard", "dtensor Partial(avg)->Replicate")


def _rank(backend: str, rank: int, port: int, op: str) -> str:
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    x = torch.full((8,), float(rank + 1), device=dev)
    try:
        if op == "all_reduce":
            dist.all_reduce(x)
        elif op == "broadcast":
            dist.broadcast(x, src=0)
        elif op == "all_gather_into_tensor":
            dist.all_gather_into_tensor(torch.empty(16, device=dev), x)
        elif op == "reduce_scatter_tensor":
            dist.reduce_scatter_tensor(torch.empty(4, device=dev), x)
        else:
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import (DTensor, Partial,
                                                  Replicate, Shard,
                                                  distribute_tensor)

            mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("fsdp",))
            if op.startswith("dtensor Shard"):
                # Shard(1): how a GPT-2 leaf is split (its "embed" dim).
                dim = 0 if op.startswith("dtensor Shard(0)") else 1
                p = distribute_tensor(torch.ones(4, 6, device=dev), mesh,
                                      [Shard(dim)])
                p.redistribute(mesh, [Replicate()]).to_local()
            else:
                part = DTensor.from_local(
                    torch.full((4, 6), float(rank + 1), device=dev), mesh,
                    [Partial("avg")])
                target = Shard(1) if op.endswith("Shard") else Replicate()
                part.redistribute(mesh, [target]).to_local()
        torch.cuda.synchronize()
        result = "ok"
    except Exception as e:  # noqa: BLE001 - what refuses is the finding
        result = f"{type(e).__name__}: {e}"[:300]
    dist.destroy_process_group()
    return result


def _pair(backend: str, op: str) -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", backend, str(r), str(port), op],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0] + "\n[killed at the timeout]")
    line = [ln for ln in logs[0].splitlines() if ln.startswith("RESULT ")]
    if line:
        return line[0][7:]
    return (f"no result: exit codes {[p.returncode for p in procs]}, "
            f"rank 0 output tail {logs[0][-600:]!r}")


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        backend, rank, port = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
        res = _rank(backend, rank, port, sys.argv[5])
        if rank == 0:
            print("RESULT " + res, flush=True)
        return 0
    out_path = None
    if len(sys.argv) > 2 and sys.argv[1] == "--out":
        out_path = sys.argv[2]
    results = []
    for backend in ("nccl", "gloo"):
        ops = {op: _pair(backend, op) for op in OPS}
        res = {"backend": backend, "ops": ops}
        results.append(res)
        print(json.dumps(res), flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
