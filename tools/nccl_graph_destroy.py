#!/usr/bin/env python3
"""Does a live CUDA graph that captured NCCL collectives hang
`destroy_process_group`? Needs two cards.

    python3 tools/nccl_graph_destroy.py [--timeout 40]

Each case starts a fresh NCCL world of 2 processes (cards 0 and 1), makes
a subgroup over both ranks as a mesh axis does, captures an all-reduce
over it in a CUDA graph (warm-up on a side stream, as the port's steps
capture), replays it, and then destroys the process group after:

  alive       the graph still alive;
  reset       `CUDAGraph.reset()` first;
  deleted     the graph deleted (and garbage collected) first;
  second      a first graph deleted, a second captured over the same
              communicators and still alive (an elastic 2 -> 1 -> 2 run's
              shape);
  port        the port's own shutdown (`DistributedContext.shutdown`),
              the graph held by a captured step that registered it
              (`parallel.mesh.hold_graph`) and still alive.

A rank that has not returned from the destroy after `--timeout` seconds
prints every thread's stack and exits 3. Prints one JSON line a case:
{"case", "returned" (both ranks), "destroy_s" by rank, "replayed_sum"}.
"""

import argparse
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("alive", "reset", "deleted", "second", "port")

RANK = r'''
import faulthandler, gc, json, os, sys, threading, time
import torch
import torch.distributed as dist
case, rank, port, timeout = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    float(sys.argv[4])
sys.path.insert(0, sys.argv[5])
torch.cuda.set_device(rank)
if case == "port":
    from determined_tpu_torch.core._distributed import DistributedContext
    from determined_tpu_torch.parallel import mesh as mesh_lib
    ctx = DistributedContext.from_allocation(
        f"tcp://127.0.0.1:{port}", 2, rank, backend="nccl", local_rank=rank)
else:
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            device_id=torch.device("cuda", rank))
group = dist.new_group([0, 1])
x = torch.ones(1 << 20, device="cuda")


def capture():
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dist.all_reduce(x, group=group)   # the warm-up makes the comm
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        dist.all_reduce(x, group=group)
    return g


class Held:
    """A captured step as train/step.py registers it."""
    def __init__(self, graph):
        self.graph = graph

    def release(self):
        self.graph.reset()


graph = capture()
graph.replay()
if case == "second":
    del graph
    gc.collect()
    x.fill_(1.0)
    graph = capture()
    graph.replay()
torch.cuda.synchronize()
total = float(x[0])
if case == "reset":
    graph.reset()
elif case == "deleted":
    del graph
    gc.collect()
elif case == "port":
    held = Held(graph)
    mesh_lib.hold_graph(held)


def stuck():
    print(f"rank {rank}: destroy_process_group has not returned after "
          f"{timeout} s", flush=True)
    faulthandler.dump_traceback(all_threads=True)
    sys.stdout.flush()
    os._exit(3)


timer = threading.Timer(timeout, stuck)
timer.daemon = True
timer.start()
t0 = time.monotonic()
if case == "port":
    ctx.shutdown()
else:
    dist.destroy_process_group()
took = time.monotonic() - t0
timer.cancel()
print("RESULT " + json.dumps({"rank": rank, "destroy_s": took,
                              "replayed_sum": total}), flush=True)
'''


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(case, timeout, script):
    port = str(free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, script, case, str(r), port, str(timeout), ROOT],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout + 120)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0] + "\n[killed]")
    results = {}
    for log in logs:
        for line in log.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[7:])
                results[r["rank"]] = r
    out = {"case": case, "returned": sorted(results) == [0, 1],
           "exit": [p.returncode for p in procs],
           "destroy_s": [results.get(r, {}).get("destroy_s") for r in (0, 1)],
           "replayed_sum": [results.get(r, {}).get("replayed_sum")
                            for r in (0, 1)]}
    return out, logs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=40.0)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--log-dir",
                    default=os.path.join(ROOT, "build", "nccl_graph_destroy"))
    args = ap.parse_args()
    import torch

    if torch.cuda.device_count() < 2:
        print(f"needs two cards, found {torch.cuda.device_count()}")
        return 1
    os.makedirs(args.log_dir, exist_ok=True)
    script = os.path.join(args.log_dir, "nccl_graph_destroy_rank.py")
    with open(script, "w") as f:
        f.write(RANK)
    for case in args.cases.split(","):
        out, logs = run(case, args.timeout, script)
        with open(os.path.join(args.log_dir,
                               f"nccl_graph_destroy_{case}.log"), "w") as f:
            f.write("\n".join(logs))
        if not out["returned"]:
            # The stuck rank's Python stack: where it waits.
            tail = [ln for log in logs for ln in log.splitlines()
                    if "File" in ln or "destroy" in ln][-12:]
            out["stack_tail"] = tail
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
