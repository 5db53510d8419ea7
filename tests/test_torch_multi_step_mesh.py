"""`make_multi_step` over a mesh of several processes, on the CPU.

One gloo world of 2 processes (a FileStore in the test's directory, one
worker process per rank) runs every case; the JAX side runs while it
does.

  - Parity: `make_multi_step` (the plain route: 2 windows of 3 steps) at
    `fsdp: 2` and at `tensor: 2` against the JAX package's
    `make_multi_step` with the same mesh on 2 of the 8 virtual CPU
    devices, a tiny fp32 GPT-2 with numpy-drawn params (wider than
    N(0, 0.02), whose logits are near-uniform at this size). Window means
    rtol 1e-5, params atol 1e-5, the key bias (gradient 0 in exact
    arithmetic, fp32 noise that Adam turns into steps of about lr) within
    2 x lr x steps. At `fsdp: 2` a window that rank 1 alone refuses (a
    wrong leading axis) is refused on both ranks.
  - Capture safety, one case for each axis the card's phase 20b runs
    (at `fsdp` both gather routes, sync and `overlap_allgather`'s async):
    two consecutive steps of what `make_multi_step` captures on CUDA (the
    step with the optimizer's floats as a tensor), each under a
    `TorchDispatchMode` that records every collective (c10d and
    functional: kind, group, shape, dtype, peer) and every host read of
    a tensor (`aten._local_scalar_dense`, `aten.equal`, `.tolist()`,
    `.cpu()`, `.numpy()`; left out: the DeviceMesh's own rank table,
    host data, and `F.one_hot`'s class-value check, which reads the host
    on the CPU only). A CUDA graph holds neither a host read nor a sequence
    that changes between replays, and the two ranks' collectives must
    pair up: the same sequence over each group, every send met by a
    receive of the same shape and dtype in the same order.
  - The detector has teeth: it refuses a loss that calls `.item()` and a
    collective that only the second step issues.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.parallel.mesh import MeshConfig as JMeshConfig
from determined_tpu.parallel.mesh import create_mesh as jcreate_mesh
from determined_tpu.train.state import create_train_state as j_create_state
from determined_tpu.train.step import make_multi_step as j_make_multi_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab_size=64, n_positions=32, d_model=32, n_layer=2, n_head=2)
WORLD, GLOBAL_BATCH, SEQ, N, CALLS, LR = 2, 4, 17, 3, 2, 1e-3
TIMEOUT_S = 120
PARITY = {"fsdp": {"fsdp": 2}, "tensor": {"data": 1, "tensor": 2}}
# The capture-safety cases: (mesh, model, attention_impl), phase 20b's.
SAFETY = {
    "fsdp": ({"fsdp": 2}, "gpt2", "flash"),
    "data": ({"data": 2}, "gpt2", "flash"),
    "tensor": ({"data": 1, "tensor": 2}, "gpt2", "flash"),
    "context_ring": ({"data": 1, "context": 2}, "gpt2", "ring"),
    "context_ulysses": ({"data": 1, "context": 2}, "gpt2", "ulysses"),
    "expert": ({"data": 1, "expert": 2}, "moe", "flash"),
    "pipeline": ({"data": 1, "pipeline": 2}, "gpt2", "flash"),
    "resnet_tensor": ({"data": 1, "tensor": 2}, "resnet", None),
}

# One rank: written to the test's directory and run as `python worker.py
# RANK WORLD DIR CONSTANTS_JSON`. Imports only the port.
WORKER = r'''
import json, os, sys
from unittest import mock
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import gpt2, resnet
from determined_tpu_torch.parallel.mesh import (
    MeshConfig, batch_shard, create_mesh)
from determined_tpu_torch.train import optim
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train.step import make_multi_step

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
C = json.loads(sys.argv[4])
DIMS, N, LR, B, SEQ = C["dims"], C["n"], C["lr"], C["batch"], C["seq"]
with np.load(os.path.join(out, "params.npz")) as f:
    FLAT = {k: f[k] for k in f.files}
with np.load(os.path.join(out, "batches.npz")) as f:
    TOKENS = f["tokens"]                     # [CALLS, N, B, SEQ]
COLLECTIVE_NS = ("c10d", "_c10d_functional", "_c10d_functional_autograd")
NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
HOST_READS = {"_local_scalar_dense", "equal"}


def group_of(args):
    """(group name, group size) of a collective's arguments."""
    for a in args:
        try:
            pg = torch._C._distributed_c10d.ProcessGroup.unbox(a)
        except Exception:
            continue
        return pg.group_name, pg.size()
    name = [a for a in args if isinstance(a, str)][-1]
    return name, dist.get_world_size(
        dist.distributed_c10d._resolve_process_group(name))


def first_tensor(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, (list, tuple)) and a and \
                isinstance(a[0], torch.Tensor):
            return a[0]


def host_data():
    """True inside the DeviceMesh, whose rank table is host data."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("device_mesh.py"):
            return True
        f = f.f_back
    return False


class Detector(TorchDispatchMode):
    """Records, per step, every collective and every host read."""

    def __init__(self):
        super().__init__()
        self.steps = []
        self.cpu_only = 0

    def record(self, what):
        if not self.cpu_only:
            self.steps[-1]["host_reads"].append(what)

    def one_hot(self, orig):
        """`F.one_hot`, whose class-value check reads the host on the CPU
        only (on CUDA the scatter's device assert stands for it)."""
        def wrapped(*a, **k):
            self.cpu_only += 1
            try:
                return orig(*a, **k)
            finally:
                self.cpu_only -= 1
        return wrapped

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ns, name = func.namespace, func.__name__.split(".")[0]
        if ns in COLLECTIVE_NS and name not in NOT_COLLECTIVES:
            group, size = group_of(args)
            t = first_tensor(args)
            entry = {"kind": f"{ns}.{name}", "group": group, "size": size,
                     "shape": list(t.shape), "dtype": str(t.dtype)}
            if name in ("send", "recv_", "recv_any_source_"):
                pg = dist.distributed_c10d._resolve_process_group(group)
                entry["peer"] = dist.get_global_rank(pg, args[2])
            self.steps[-1]["collectives"].append(entry)
        elif ns == "aten" and name in HOST_READS and not host_data():
            self.record(f"aten.{name}")
        return func(*args, **(kwargs or {}))

    def run(self, fn):
        """fn() as one step under the detector."""
        self.steps.append({"collectives": [], "host_reads": []})
        patches = []
        for meth in ("tolist", "cpu", "numpy"):
            orig = getattr(torch.Tensor, meth)

            def wrapped(t, *a, _orig=orig, _meth=meth, **k):
                if not host_data():
                    self.record(f"Tensor.{_meth}")
                return _orig(t, *a, **k)
            patches.append(mock.patch.object(torch.Tensor, meth, wrapped))
        patches.append(mock.patch.object(
            F, "one_hot", self.one_hot(F.one_hot)))
        for p in patches:
            p.start()
        try:
            with self:
                return fn()
        finally:
            for p in patches:
                p.stop()


def gpt2_params(cfg, numpy_drawn=True):
    if not numpy_drawn:
        return gpt2.init(torch.Generator().manual_seed(0), cfg)
    return gpt2.params_from_numpy(gpt2._unflatten(dict(FLAT)))


def port_tx():
    sched = optim.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
    return optim.chain(optim.clip_by_global_norm(1.0),
                       optim.adamw(sched, b2=0.95, weight_decay=0.1))


def rows_of(mc, x, dim):
    """This rank's rows of a global batch `x` whose rows are dim `dim`."""
    i, n = batch_shard(mc, rank, world)
    rows = x.shape[dim] // n
    return x.narrow(dim, i * rows, rows)


def build(sizes, model, impl, numpy_drawn=False, overlap=False):
    """(mesh config, mesh, state, tx, loss, stateful, this rank's batches
    [N, rows, ...] of two windows)."""
    mc = MeshConfig(**sizes).resolve(world)
    mesh = create_mesh(mc, "cpu")
    tx = port_tx()
    if model == "resnet":
        cfg = resnet.Config(stage_sizes=(1, 1), num_filters=8, n_classes=6,
                            dtype=torch.float32)
        gen = torch.Generator().manual_seed(0)
        tx = optim.sgd(0.1, momentum=0.9)
        state = state_mod.create_train_state(
            lambda g: resnet.init(g, cfg)[0], tx, gen, extra=resnet.init_stats(cfg), mesh=mesh,
            param_logical_axes=resnet.param_logical_axes(cfg))
        rng = np.random.default_rng(3)
        wins = [{"images": torch.from_numpy(rng.normal(
                     size=(N, B, 8, 8, 3)).astype(np.float32)),
                 "labels": torch.from_numpy(rng.integers(
                     0, 6, (N, B)).astype(np.int32))} for _ in range(2)]
        wins = [{k: rows_of(mc, v, 1) for k, v in w.items()} for w in wins]

        def loss(p, extra, batch, r):
            return resnet.loss_fn(p, extra, batch, r, cfg)
        return mc, mesh, state, tx, loss, True, wins
    moe = {"num_experts": 4, "moe_top_k": 2} if model == "moe" else {}
    cfg = gpt2.Config(**DIMS, dtype=torch.float32, attention_impl=impl,
                      overlap_allgather=overlap, **moe)
    state = state_mod.create_train_state(
        lambda g: gpt2_params(cfg, numpy_drawn), tx, torch.Generator(),
        mesh=mesh, param_logical_axes=gpt2.param_logical_axes(cfg))
    if mc.pipeline > 1:
        def loss(p, b, r):
            return gpt2.loss_fn_pipelined(p, b, cfg, mesh)
    else:
        def loss(p, b, r):
            return gpt2.loss_fn(p, b, cfg)
    wins = [{"tokens": rows_of(mc, torch.from_numpy(w), 1)} for w in TOKENS]
    return mc, mesh, state, tx, loss, False, wins


def hyper_of(tx, state):
    return torch.tensor(tx.hyper(state.opt_state)[0], dtype=torch.float32)


def two_steps(step, tx, state, wins):
    """Two consecutive captured-route steps under the detector."""
    det = Detector()
    for i in range(2):
        batch = {k: v[i] for k, v in wins[0].items()}
        det.run(lambda: step(state, batch, None, hyper=hyper_of(tx, state)))
    return det.steps


report = {"parity": {}, "safety": {}, "planted": {}, "refusal": None}
dist_ctx = DistributedContext.from_allocation(
    "file://" + os.path.join(out, "store"), world, rank, backend="gloo")

for name, sizes in C["parity"].items():
    mc, mesh, state, tx, loss, _, wins = build(sizes, "gpt2", "flash",
                                               numpy_drawn=True)
    multi = make_multi_step(loss, tx, N, mesh=mesh)
    means = []
    for w in wins:
        state, m = multi(state, w, None)
        means.append({k: float(v) for k, v in m.items()})
    full = state_mod.unshard_state(state)
    if rank == 0:
        np.savez(os.path.join(out, f"parity_{name}.npz"),
                 **gpt2._flatten(gpt2.params_to_numpy(full.params)))
    report["parity"][name] = {"means": means, "step": state.step}
    if name == "fsdp":
        # Rank 1 alone hands in a wrong leading axis: both ranks refuse.
        bad = {"tokens": torch.cat([wins[0]["tokens"]] * 2)[:N + rank]}
        try:
            multi(state, bad, None)
        except (ValueError, RuntimeError) as e:
            report["refusal"] = {"kind": type(e).__name__,
                                 "message": str(e), "step": state.step}

safety = [(name, case, False) for name, case in C["safety"].items()]
# The fsdp step again with `overlap_allgather`: the async gathers.
safety.append(("fsdp_overlap", C["safety"]["fsdp"], True))
for name, (sizes, model, impl), overlap in safety:
    _, mesh, state, tx, loss, stateful, wins = build(sizes, model, impl,
                                                     overlap=overlap)
    multi = make_multi_step(loss, tx, N, mesh=mesh, stateful=stateful)
    report["safety"][name] = two_steps(multi._step, tx, state, wins)

# The planted faults, on the fsdp model.
_, mesh, state, tx, loss, _, wins = build({"fsdp": 2}, "gpt2", "flash")
calls = []


def reads_host(p, b, r):
    value = loss(p, b, r)
    value.item()
    return value


def late_collective(p, b, r):
    value = loss(p, b, r)
    calls.append(1)
    if len(calls) == 2:
        dist.all_reduce(torch.ones(1))
    return value


for name, fn in (("host_read", reads_host),
                 ("late_collective", late_collective)):
    multi = make_multi_step(fn, tx, N, mesh=mesh)
    report["planted"][name] = two_steps(multi._step, tx, state, wins)

with open(os.path.join(out, f"report{rank}.json"), "w") as f:
    json.dump(report, f)
'''


def numpy_params(seed=0, std=0.2):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda r: jgpt2.init(r, jax_config()),
                            jax.random.PRNGKey(0))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        k = "/".join(str(getattr(p, "key", p)) for p in path)
        base = 1.0 if k.endswith("scale") else 0.0
        out[k] = (base + std * rng.normal(size=leaf.shape)).astype(np.float32)
    return out


def jax_config():
    return jgpt2.Config(**DIMS, dtype=jnp.float32)


def unflatten(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def flatten(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_side(params, tokens, devices):
    """JAX's `make_multi_step` over each parity mesh on 2 of the virtual
    devices -> {case: (window means, final params)}."""
    cfg = jax_config()
    ref = {}
    for name, sizes in PARITY.items():
        mesh = jcreate_mesh(JMeshConfig(**sizes).resolve(WORLD),
                            devices[:WORLD])
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
            optax.warmup_cosine_decay_schedule(0.0, LR, 1, 100), b2=0.95,
            weight_decay=0.1))
        with jax.sharding.set_mesh(mesh):
            state = j_create_state(
                lambda r: jax.tree_util.tree_map(jnp.asarray,
                                                 unflatten(params)),
                tx, jax.random.PRNGKey(0), mesh=mesh,
                param_logical_axes=jgpt2.param_logical_axes(cfg))
            multi = j_make_multi_step(
                lambda p, b, r: jgpt2.loss_fn(p, b, cfg), tx, N, mesh=mesh,
                donate_state=False)
            means = []
            for w in tokens:
                state, m = multi(state, {"tokens": jnp.asarray(w)},
                                 jax.random.PRNGKey(0))
                means.append({k: float(v) for k, v in m.items()})
        ref[name] = (means, flatten(jax.tree_util.tree_map(
            np.asarray, state.params)), int(state.step))
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory, devices):
    """Every case in one gloo world of 2, and the JAX side computed while
    it runs -> (the ranks' reports, the run dir, the JAX results)."""
    params = numpy_params()
    tokens = np.random.default_rng(1).integers(
        0, DIMS["vocab_size"], size=(CALLS, N, GLOBAL_BATCH, SEQ)
    ).astype(np.int32)
    out = tmp_path_factory.mktemp("multi_step_mesh")
    np.savez(out / "params.npz", **params)
    np.savez(out / "batches.npz", tokens=tokens)
    script = out / "worker.py"
    script.write_text(WORKER)
    consts = json.dumps({"dims": DIMS, "n": N, "lr": LR,
                         "batch": GLOBAL_BATCH, "seq": SEQ,
                         "parity": PARITY, "safety": SAFETY})
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), str(out), consts],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    try:
        ref = jax_side(params, tokens, devices)
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    reports = [json.loads((out / f"report{r}.json").read_text())
               for r in range(WORLD)]
    return reports, out, ref


def problems(steps_by_rank):
    """What keeps two steps from being captured and replayed in lockstep:
    `steps_by_rank[r]` is rank r's two steps as the detector recorded
    them."""
    found = []
    for r, steps in enumerate(steps_by_rank):
        for i, s in enumerate(steps):
            if s["host_reads"]:
                found.append(f"rank {r} step {i}: host reads "
                             f"{sorted(set(s['host_reads']))}")
        if steps[0]["collectives"] != steps[1]["collectives"]:
            found.append(f"rank {r}: the steps issue different collectives "
                         f"({len(steps[0]['collectives'])} and "
                         f"{len(steps[1]['collectives'])})")
    for i in range(2):
        per_group, p2p = [], []
        for r, steps in enumerate(steps_by_rank):
            groups, sends = {}, []
            for c in steps[i]["collectives"]:
                key = (c["kind"], c["shape"], c["dtype"])
                if "peer" in c:
                    sends.append((c["kind"], r, c["peer"], c["shape"],
                                  c["dtype"]))
                elif c["size"] > 1:
                    groups.setdefault(c["group"], []).append(key)
            per_group.append(groups)
            p2p.append(sends)
        names = set().union(*per_group)
        for g in names:
            seqs = [pg.get(g) for pg in per_group]
            if any(s != seqs[0] for s in seqs):
                found.append(f"step {i}: the ranks' collectives over group "
                             f"{g} differ")
        for src in range(len(steps_by_rank)):
            for dst in range(len(steps_by_rank)):
                sent = [x[3:] for x in p2p[src]
                        if x[0].endswith("send") and x[2] == dst]
                got = [x[3:] for x in p2p[dst]
                       if x[0].endswith("recv_") and x[2] == src]
                if sent != got:
                    found.append(f"step {i}: rank {src}'s sends to rank "
                                 f"{dst} meet {len(got)} receives, not "
                                 f"{len(sent)} of the same shapes")
    return found


@pytest.mark.parametrize("name", list(PARITY))
def test_parity_with_jax_multi_step(world, name):
    reports, out, ref = world
    jmeans, jflat, jstep = ref[name]
    for rep in reports:
        got = rep["parity"][name]
        assert got["step"] == jstep == N * CALLS
        for tm, jm in zip(got["means"], jmeans):
            assert set(tm) == set(jm)
            for k in jm:
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
    tflat = dict(np.load(out / f"parity_{name}.npz"))
    d = DIMS["d_model"]
    for k, want in jflat.items():
        got = tflat[k]
        if k == "blocks/qkv/bias":
            np.testing.assert_allclose(got[:, d:2 * d], want[:, d:2 * d],
                                       atol=2 * LR * N * CALLS)
            got = np.delete(got, np.s_[d:2 * d], 1)
            want = np.delete(want, np.s_[d:2 * d], 1)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=k)
    if name == "fsdp":
        # Rank 1's wrong window is refused on both ranks, before a step:
        # rank 1 with its own error, rank 0 naming rank 1.
        for r, rep in enumerate(reports):
            refused = rep["refusal"]
            assert refused is not None, f"rank {r} ran the window"
            assert refused["step"] == N * CALLS
        assert reports[1]["refusal"]["kind"] == "ValueError"
        assert "steps_per_call" in reports[1]["refusal"]["message"]
        assert reports[0]["refusal"]["kind"] == "RuntimeError"
        assert "rank 1 of the mesh refused" in \
            reports[0]["refusal"]["message"]


@pytest.mark.parametrize("name", list(SAFETY))
def test_step_is_capture_safe(world, name):
    reports, _, _ = world
    # At fsdp both gather routes: sync, and async (`overlap_allgather`).
    for case in [name] + (["fsdp_overlap"] if name == "fsdp" else []):
        steps = [rep["safety"][case] for rep in reports]
        assert problems(steps) == [], case
        assert steps[0][0]["collectives"], f"{case}: no collective"
    if name == "pipeline" or name == "context_ring":
        kinds = {c["kind"] for c in steps[0][0]["collectives"]}
        assert {"c10d.send", "c10d.recv_"} <= kinds, kinds
    if name == "fsdp":
        kinds = [c["kind"] for c in steps[0][0]["collectives"]]
        assert "_c10d_functional.all_gather_into_tensor" in kinds, kinds


def test_detector_refuses_host_read_and_late_collective(world):
    reports, _, _ = world
    host = problems([rep["planted"]["host_read"] for rep in reports])
    assert any("host reads ['aten._local_scalar_dense']" in p
               for p in host), host
    late = problems([rep["planted"]["late_collective"] for rep in reports])
    assert any("different collectives" in p for p in late), late
    assert not any("host reads" in p for p in late), late
