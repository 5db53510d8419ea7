"""The port's ring attention against the JAX package's, on the CPU.

`determined_tpu_torch.ops.ring_attention` runs in 4 gloo processes (one
worker per rank over a FileStore in the test's directory; the worker
imports only the port), each holding its rows (`parallel.mesh.
batch_shard`) and its sequence chunk (`seq_shard`) of q, k, v and dO
drawn from a numpy seed, over three meshes: `data 2 x context 2`,
`context 4`, and `data 4` (a context axis of 1: the fallback to
`flash_attention`). Its outputs and q/k/v gradients, pieced together,
are held to `determined_tpu.ops.ring_attention.ring_attention` and
`jax.grad` through it on 4 of the 8 virtual CPU devices with the same
mesh, causal and not. The per-block steps (`block_forward`, `_combine`,
`finish`, `block_causal`) are held to the JAX functions in this process.

Tolerance: fp32, the same blockwise arithmetic in the same block order,
sums inside a block in another order: atol 2e-6, rtol 1e-5. The fallback
is the port's own `flash_attention`, bitwise.
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

ra = importlib.import_module("determined_tpu_torch.ops.ring_attention")
jra = importlib.import_module("determined_tpu.ops.ring_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B, S, H, D = 4, 16, 2, 8
MESHES = {"data2_context2": {"data": 2, "context": 2},
          "context4": {"data": 1, "context": 4},
          "data4": {"data": 4}}
ATOL, RTOL = 2e-6, 1e-5
TIMEOUT_S = 120

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from determined_tpu_torch.ops import flash_attention as fa
from determined_tpu_torch.ops import ring_attention
from determined_tpu_torch.parallel.mesh import (
    MeshConfig, batch_shard, create_mesh, seq_shard)

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
meshes = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    out, "store"), rank=rank, world_size=world)
with np.load(os.path.join(out, "inputs.npz")) as f:
    q, k, v, do = (torch.from_numpy(f[n]) for n in ("q", "k", "v", "do"))
res, meta = {}, {}
for name, sizes in meshes.items():
    cfg = MeshConfig(**sizes)
    mesh = create_mesh(cfg, "cpu")
    i, n = batch_shard(cfg, rank, world)
    s0, s1 = seq_shard(cfg, rank, world, q.shape[1])
    rows = slice(i * q.shape[0] // n, (i + 1) * q.shape[0] // n)
    for causal in (True, False):
        ql, kl, vl = (t[rows, s0:s1].clone().requires_grad_()
                      for t in (q, k, v))
        o = ring_attention(ql, kl, vl, causal=causal, mesh=mesh)
        grads = torch.autograd.grad(o, (ql, kl, vl), do[rows, s0:s1])
        key = f"{name}.{int(causal)}"
        for tname, t in zip(("o", "dq", "dk", "dv"), (o, *grads)):
            res[f"{key}.{tname}"] = t.detach().numpy()
        if sizes.get("context", 1) == 1:
            want = fa.flash_attention(ql.detach(), kl.detach(), vl.detach(),
                                      causal=causal)
            meta[key] = bool(torch.equal(o.detach(), want))
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(meta, f)
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
    rng = np.random.default_rng(0)
    return {n: rng.normal(size=(B, S, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "do")}


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    """Every case of the port's ring in one world of 4 -> {key: full
    array pieced from the ranks}, {key: the fallback bitwise}."""
    out = tmp_path_factory.mktemp("ring_world")
    np.savez(out / "inputs.npz", **inputs)
    run_world(out, WORKER, [json.dumps(MESHES)])
    pieces = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    full, meta = {}, {}
    for key in pieces[0]:
        cfg = MeshConfig(**MESHES[key.split(".")[0]])
        arr = np.zeros((B, S, H, D), np.float32)
        for r in range(WORLD):
            i, n = batch_shard(cfg, r, WORLD)
            s0, s1 = seq_shard(cfg, r, WORLD, S)
            arr[i * B // n:(i + 1) * B // n, s0:s1] = pieces[r][key]
        full[key] = arr
    for r in range(WORLD):
        meta.update({f"{k}.rank{r}": v for k, v in json.loads(
            (out / f"rank{r}.json").read_text()).items()})
    return full, meta


def jax_ring(inputs, sizes, causal, devices):
    """(o, dq, dk, dv) of the JAX ring on `sizes` over 4 devices."""
    mesh = jcreate_mesh(JMeshConfig(**sizes).resolve(WORLD),
                        devices[:WORLD])
    q, k, v, do = (jnp.asarray(inputs[n]) for n in ("q", "k", "v", "do"))

    def f(q, k, v):
        return jra.ring_attention(q, k, v, causal=causal, mesh=mesh)

    with jax.sharding.set_mesh(mesh):
        o, vjp = jax.vjp(jax.jit(f), q, k, v)
        grads = vjp(do)
    return [np.asarray(t) for t in (o, *grads)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", ["data2_context2", "context4", "data4"])
def test_ring_matches_jax(world, inputs, devices, name, causal):
    full, _ = world
    want = jax_ring(inputs, MESHES[name], causal, devices)
    for tname, w in zip(("o", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(full[f"{name}.{int(causal)}.{tname}"], w,
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} causal={causal} {tname}")


def test_context_one_is_flash_attention(world):
    _, meta = world
    # Every rank, both masks: the output of flash_attention, bitwise.
    assert len(meta) == 2 * WORLD and all(meta.values()), meta


def test_no_mesh_is_flash_attention(inputs):
    from determined_tpu_torch.ops import flash_attention as fa

    q, k, v = (torch.from_numpy(inputs[n]) for n in ("q", "k", "v"))
    for causal in (True, False):
        assert torch.equal(ra.ring_attention(q, k, v, causal=causal),
                           fa.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("masked", [True, False])
def test_block_forward_and_combine_match_jax(inputs, masked):
    q, k, v = (inputs[n][:, :8] for n in ("q", "k", "v"))
    k2, v2 = inputs["k"][:, 8:], inputs["v"][:, 8:]
    scale = 1.0 / np.sqrt(D)
    mask = np.tril(np.ones((8, 8), bool)) if masked else None
    jm, jl, jo = jra._block_attend(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v),
                                   None if mask is None else jnp.asarray(mask),
                                   scale)
    tq, tk, tv, tk2, tv2 = (torch.from_numpy(t) for t in (q, k, v, k2, v2))
    part = ra.block_forward(tq, tk, tv, masked)
    for got, want in zip(part, (jm, jl, jo)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    other = ra.block_forward(tq, tk2, tv2, False)
    jother = jra._block_attend(jnp.asarray(q), jnp.asarray(k2),
                               jnp.asarray(v2), None, scale)
    got = ra._combine(*part, *other)
    want = jra._combine(jm, jl, jo, *jother)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)
    # finish: the normalised output and the row's logsumexp.
    out, lse = ra.finish(*got, torch.float32)
    m, l, o = (np.asarray(t) for t in want)
    np.testing.assert_allclose(out.numpy(),
                               o / l.transpose(0, 2, 1)[..., None],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), (m + np.log(l)).reshape(
        B * H, 8), atol=ATOL, rtol=RTOL)


def test_block_rule_is_the_jax_one():
    for me in range(4):
        for src in range(4):
            want = None if src > me else (src == me)
            assert ra.block_causal(src, me, True) == want
            assert ra.block_causal(src, me, False) is False
