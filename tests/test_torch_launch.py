"""The port's GPU-slot launcher against the JAX package's launch layer, on
the CPU (gloo, named by DET_TORCH_BACKEND: the launcher refuses a host
without CUDA otherwise).

`worker_env` must give the JAX package's torch.distributed contract plus
each slot's CUDA_VISIBLE_DEVICES; launched workers see their slot, rank
and world, form the process group through `core.init()` from that
environment, and get the launcher's SIGTERM; and a failed worker takes
its survivors down (as tests/test_distributed_trials.py's torchrun-
semantics test for the JAX package's launcher).
"""

import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from determined_tpu.launch.torch_distributed import worker_env as j_worker_env
from determined_tpu_torch.exec import launch as exec_launch
from determined_tpu_torch.launch import torch_distributed as td

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launcher_env(**extra):
    env = dict(os.environ, DET_TORCH_BACKEND="gloo",
               DET_TORCH_MASTER_PORT=str(free_port()),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("WORLD_SIZE", "RANK", "DET_SLOT_IDS", "DET_MASTER"):
        env.pop(k, None)
    env.update(extra)
    return env


def launch(args, env, **kw):
    return subprocess.run(
        [sys.executable, "-m", "determined_tpu_torch.launch.torch_distributed",
         *args], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=TIMEOUT_S, **kw)


@pytest.mark.parametrize("slot", [None, 3])
def test_worker_env_is_the_jax_contract_plus_the_slot(slot):
    args = dict(node_rank=1, nnodes=2, local_rank=3, nproc_per_node=4,
                master_addr="10.0.0.1", master_port=29400, backend="nccl")
    ours = td.worker_env({"PATH": "/usr/bin"}, slot=slot, **args)
    theirs = j_worker_env({"PATH": "/usr/bin"}, **args)
    if slot is None:
        assert ours == theirs
    else:
        assert ours == dict(theirs, CUDA_VISIBLE_DEVICES="3")
    assert ours["RANK"] == "7" and ours["WORLD_SIZE"] == "8"


def test_slot_ids_and_backend():
    assert td.slot_ids({"DET_SLOT_IDS": "[0, 1]"}) == [0, 1]
    assert td.slot_ids({"DET_SLOT_IDS": "2,5"}) == [2, 5]
    assert td.slot_ids({}) == []
    assert td.pick_backend({"DET_TORCH_BACKEND": "gloo"}) == "gloo"
    with pytest.raises(ValueError):
        td.pick_backend({"DET_TORCH_BACKEND": "mpi"})
    with pytest.raises(RuntimeError, match="DET_TORCH_BACKEND=gloo"):
        td.pick_backend({})  # this host has no CUDA
    assert exec_launch.launch_command(["python3", "train.py"])[1:4] == \
        ["-m", "determined_tpu_torch.launch.torch_distributed", "--"]


def test_one_worker_per_slot_forms_the_process_group(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(
        "import os\n"
        "from determined_tpu_torch import core\n"
        f"ctx = core.init(max_length=1, checkpoint_dir={str(tmp_path)!r})\n"
        "d = ctx.distributed\n"
        "ranks = d.allgather(d.rank)\n"
        "print('slot', os.environ['CUDA_VISIBLE_DEVICES'], 'rank', d.rank,\n"
        "      'of', d.size, 'local', d.local_rank, 'backend', d.backend,\n"
        "      'ranks', ranks, flush=True)\n"
        "ctx.close()\n")
    r = launch(["--", sys.executable, str(script)],
               launcher_env(DET_SLOT_IDS="[2, 5]"))
    assert r.returncode == 0, (r.stdout, r.stderr)
    lines = sorted(line for line in r.stdout.splitlines() if "slot" in line)
    assert lines == [
        "[rank=0] slot 2 rank 0 of 2 local 0 backend gloo ranks [0, 1]",
        "[rank=1] slot 5 rank 1 of 2 local 1 backend gloo ranks [0, 1]"]


def test_failed_worker_kills_survivors(tmp_path):
    """rank 1 crashes -> rank 0 (sleeping) is terminated and the launcher
    exits with rank 1's code promptly."""
    script = tmp_path / "crashy.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['RANK'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(600)\n")
    t0 = time.monotonic()
    r = launch(["--nproc-per-node", "2", "--", sys.executable, str(script)],
               launcher_env())
    assert r.returncode == 3, (r.returncode, r.stdout, r.stderr)
    assert "terminating" in r.stderr
    assert time.monotonic() - t0 < 60


def test_sigterm_reaches_every_worker(tmp_path):
    script = tmp_path / "waits.py"
    script.write_text(
        "import os, signal, sys, time\n"
        "def stop(*a):\n"
        f"    open(os.path.join({str(tmp_path)!r}, 'term' + "
        "os.environ['RANK']), 'w').close()\n"
        "    sys.exit(0)\n"
        "signal.signal(signal.SIGTERM, stop)\n"
        f"open(os.path.join({str(tmp_path)!r}, 'up' + os.environ['RANK']),"
        " 'w').close()\n"
        "time.sleep(600)\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "determined_tpu_torch.launch.torch_distributed",
         "--nproc-per-node", "2", "--", sys.executable, str(script)],
        env=launcher_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while not all((tmp_path / f"up{r}").exists() for r in range(2)):
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert (tmp_path / "term0").exists() and (tmp_path / "term1").exists()
