"""The port's Ulysses attention against the JAX package's, on the CPU.

`determined_tpu_torch.ops.ulysses.ulysses_attention` runs in 4 gloo
processes (one worker per rank over a FileStore in the test's
directory; the worker imports only the port), each holding its rows
(`parallel.mesh.batch_shard`) and its sequence chunk (`seq_shard`) of q,
k, v and dO drawn from a numpy seed, at `data 2 x context 2`, causal and
not. The inner attention is the port's flash dispatcher (its plain
version on the CPU, the kernels on CUDA). Its outputs and q/k/v
gradients, pieced together, are held to
`determined_tpu.ops.ulysses.ulysses_attention` and `jax.grad` through it
on 4 of the 8 virtual CPU devices with the same mesh. At `tensor 2 x
context 2` both divisibility errors must read as the JAX ones, word for
word. At `data 4` (a context axis of 1) and without a mesh the function
is the port's `flash_attention`, bitwise, where the JAX one is its dense
`_inner_attention`: the two are held together.

Tolerance: fp32, the same attention after two exact exchanges, its sums
in another order: atol 2e-6, rtol 1e-5.
"""

import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.parallel.mesh import MeshConfig as JMeshConfig
from determined_tpu.parallel.mesh import create_mesh as jcreate_mesh
from determined_tpu_torch.parallel.mesh import MeshConfig, batch_shard, \
    seq_shard

ul = importlib.import_module("determined_tpu_torch.ops.ulysses")
jul = importlib.import_module("determined_tpu.ops.ulysses")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B, S, H, D = 4, 16, 4, 8
MESH = {"data": 2, "context": 2}
ONE_MESH = {"data": 4}  # a context axis of 1
SPLIT_MESH = {"data": 1, "tensor": 2, "context": 2}
# (global head count, the q a rank holds): n_head 3 does not divide over
# tensor 2; n_head 2 leaves 1 head a rank, which context 2 cannot split.
BAD_HEADS = (3, 2)
ATOL, RTOL = 2e-6, 1e-5
TIMEOUT_S = 120

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from determined_tpu_torch.ops import ulysses_attention
from determined_tpu_torch.ops.flash_attention import flash_attention
from determined_tpu_torch.parallel.mesh import (
    MeshConfig, batch_shard, create_mesh, seq_shard)

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sizes, one_sizes, split_sizes, bad = (json.loads(a) for a in sys.argv[4:8])
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    out, "store"), rank=rank, world_size=world)
with np.load(os.path.join(out, "inputs.npz")) as f:
    q, k, v, do = (torch.from_numpy(f[n]) for n in ("q", "k", "v", "do"))
cfg = MeshConfig(**sizes)
mesh = create_mesh(cfg, "cpu")
i, n = batch_shard(cfg, rank, world)
s0, s1 = seq_shard(cfg, rank, world, q.shape[1])
rows = slice(i * q.shape[0] // n, (i + 1) * q.shape[0] // n)
res = {}
for causal in (True, False):
    ql, kl, vl = (t[rows, s0:s1].clone().requires_grad_() for t in (q, k, v))
    o = ulysses_attention(ql, kl, vl, causal=causal, mesh=mesh)
    grads = torch.autograd.grad(o, (ql, kl, vl), do[rows, s0:s1])
    for tname, t in zip(("o", "dq", "dk", "dv"), (o, *grads)):
        res[f"{int(causal)}.{tname}"] = t.detach().numpy()
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
# A context axis of 1: flash_attention on the rank's rows, bitwise.
one = create_mesh(MeshConfig(**one_sizes), "cpu")
i, n = batch_shard(MeshConfig(**one_sizes), rank, world)
rows = slice(i * q.shape[0] // n, (i + 1) * q.shape[0] // n)
same = [bool(torch.equal(ulysses_attention(q[rows], k[rows], v[rows],
                                           causal=causal, mesh=one),
                         flash_attention(q[rows], k[rows], v[rows],
                                         causal=causal)))
        for causal in (True, False)]
# The divisibility errors, over tensor 2 x context 2.
split = create_mesh(MeshConfig(**split_sizes), "cpu")
errors = []
for n_head in bad:
    x = torch.zeros(1, 8, max(1, n_head // 2), 8)
    try:
        ulysses_attention(x, x, x, mesh=split, n_head=n_head)
        errors.append(None)
    except ValueError as e:
        errors.append(str(e))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump({"errors": errors, "context_one": same}, f)
dist.destroy_process_group()
'''


def run_world(tmp, script, args, world=WORLD):
    """Run `script` in `world` processes (rank, world, dir, *args); every
    one must exit 0."""
    path = tmp / "worker.py"
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(path), str(r), str(world), str(tmp), *args],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    return {n: rng.normal(size=(B, S, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "do")}


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    """The port's Ulysses in one world of 4 -> ({key: full array pieced
    from the ranks}, each rank's {"errors": its divisibility errors,
    "context_one": whether context 1 was flash_attention, by mask})."""
    out = tmp_path_factory.mktemp("ulysses_world")
    np.savez(out / "inputs.npz", **inputs)
    run_world(out, WORKER, [json.dumps(MESH), json.dumps(ONE_MESH),
                            json.dumps(SPLIT_MESH), json.dumps(BAD_HEADS)])
    pieces = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    cfg = MeshConfig(**MESH)
    full = {}
    for key in pieces[0]:
        arr = np.zeros((B, S, H, D), np.float32)
        for r in range(WORLD):
            i, n = batch_shard(cfg, r, WORLD)
            s0, s1 = seq_shard(cfg, r, WORLD, S)
            arr[i * B // n:(i + 1) * B // n, s0:s1] = pieces[r][key]
        full[key] = arr
    meta = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(WORLD)]
    return full, meta


def jax_mesh(sizes, devices):
    return jcreate_mesh(JMeshConfig(**sizes).resolve(WORLD), devices[:WORLD])


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax(world, inputs, devices, causal):
    full, _ = world
    mesh = jax_mesh(MESH, devices)
    q, k, v, do = (jnp.asarray(inputs[n]) for n in ("q", "k", "v", "do"))

    def f(q, k, v):
        return jul.ulysses_attention(q, k, v, causal=causal, inner="flash")

    with jax.sharding.set_mesh(mesh):
        o, vjp = jax.vjp(jax.jit(f), q, k, v)
        want = (o, *vjp(do))
    for tname, w in zip(("o", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(full[f"{int(causal)}.{tname}"],
                                   np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=f"causal={causal} {tname}")


def test_context_one_is_flash_attention(world):
    _, meta = world
    # Every rank, both masks: the output of flash_attention, bitwise.
    assert [m["context_one"] for m in meta] == [[True, True]] * WORLD, meta


def test_divisibility_errors_match_jax(world, devices):
    _, meta = world
    errors = [m["errors"] for m in meta]
    mesh = jax_mesh(SPLIT_MESH, devices)
    want = []
    for n_head in BAD_HEADS:
        x = jnp.zeros((2, 8, n_head, 8), jnp.float32)
        with jax.sharding.set_mesh(mesh):
            with pytest.raises(ValueError) as e:
                jax.jit(lambda a: jul.ulysses_attention(a, a, a))(x)
        want.append(str(e.value))
    assert "divisible by the tensor axis size" in want[0]
    assert "per-shard head count" in want[1]
    assert errors == [want] * WORLD


def test_without_a_mesh_is_the_dense_attention(inputs):
    from determined_tpu_torch.ops import flash_attention as fa

    q, k, v = (inputs[n] for n in ("q", "k", "v"))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for causal in (True, False):
        got = ul.ulysses_attention(tq, tk, tv, causal=causal)
        assert torch.equal(got, fa.flash_attention(tq, tk, tv,
                                                   causal=causal))
        want = jul.ulysses_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                     causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
