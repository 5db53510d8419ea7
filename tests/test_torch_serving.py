"""The port's serving stack: engine, block manager, batcher.

Greedy generations of the port's engine must equal the JAX package's
`ServingEngine(attention_impl="reference")` and a full-forward
`gpt2.apply` on the same numpy-seeded params (f32, CPU, TINY size). The
host-side contracts (BlockManager accounting, continuous batching, prefix
sharing, drain) are the ones tests/test_serving.py holds the JAX package
to, run against the port's copies. test_torch_serving_exact.py holds the
generations through the batcher and the HTTP front-end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu_torch.common import faultpoint
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.serve import (
    AdmissionQueue,
    BlockManager,
    ContinuousBatcher,
    Draining,
    KVBlockError,
    QueueFull,
    Request,
    ServingEngine,
)
from determined_tpu_torch.serve.scheduler import FAULT_POINT_DROP

JCFG = jgpt2.Config(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
                    n_head=2, dtype=jnp.float32, remat=False,
                    attention_impl="dot")
TCFG = tgpt2.Config(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
                    n_head=2, dtype=torch.float32, remat=False,
                    attention_impl="dot")


@pytest.fixture(autouse=True)
def _clean_faults():
    faultpoint.disarm_all()
    yield
    faultpoint.disarm_all()


@pytest.fixture(scope="module")
def params():
    """Numpy params in the JAX init's structure, with a wide spread so
    greedy decoding is not degenerate."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jgpt2.init(jax.random.PRNGKey(0), JCFG))

    def draw(path, sd):
        if "scale" in jax.tree_util.keystr(path):
            return (1 + 0.1 * rng.normal(size=sd.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


_greedy_cache = {}
# Jitted once a context length (op by op, a token took seconds).
_jax_apply = jax.jit(lambda p, tokens: jgpt2.apply(p, tokens, JCFG))


def reference_greedy(params, prompt, n):
    """Full-forward greedy generation with the JAX model: the ground truth
    the port's paged path must reproduce."""
    key = (id(params), tuple(int(t) for t in prompt), n)
    if key not in _greedy_cache:
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        ctx = [int(t) for t in prompt]
        out = []
        for _ in range(n):
            logits = _jax_apply(jp, jnp.asarray([ctx], jnp.int32))
            tok = int(jnp.argmax(logits[0, -1]))
            out.append(tok)
            ctx.append(tok)
        _greedy_cache[key] = out
    return _greedy_cache[key]


def make_engine(params, slots=4, max_seq=32, buckets=(8, 16, 32), **kw):
    return ServingEngine(params, TCFG, slots=slots, max_seq_len=max_seq,
                         prefill_buckets=list(buckets), device="cpu", **kw)


def make_batcher(engine, queue_size=64, num_blocks=None, block_size=8):
    blocks = BlockManager(
        num_blocks=num_blocks if num_blocks is not None
        else engine.slots * (engine.max_seq_len // block_size),
        block_size=block_size)
    return ContinuousBatcher(
        engine, queue=AdmissionQueue(queue_size), block_manager=blocks,
        idle_wait_s=0.005)


def _req(n_prompt=4, max_new=4, **kw):
    return Request(np.arange(1, 1 + n_prompt, dtype=np.int32),
                   max_new_tokens=max_new, **kw)


def greedy_via_engine(eng, prompt, n):
    first = eng.prefill_request(0, np.asarray(prompt, np.int32))
    out = [first]
    tokens = np.zeros(eng.slots, np.int32)
    positions = np.zeros(eng.slots, np.int32)
    temps = np.zeros(eng.slots, np.float32)
    pos, last = len(prompt), first
    for _ in range(n - 1):
        tokens[0], positions[0] = last, pos
        last = int(eng.decode(tokens, positions, temps)[0])
        out.append(last)
        pos += 1
    return out


# ------------------------------------------------------------------ engine


def test_engine_casts_weights_but_not_layer_norm(params):
    import dataclasses

    cfg = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    eng = ServingEngine(params, cfg, slots=1, max_seq_len=16,
                        kv_block_size=8, device="cpu")
    assert eng.params["wte"].dtype == torch.bfloat16
    assert eng.params["blocks"]["qkv"]["kernel"].dtype == torch.bfloat16
    assert eng.params["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert eng.params["ln_f"]["bias"].dtype == torch.float32


def test_bucket_selection_and_warm_calls(params):
    eng = make_engine(params, buckets=(8, 16, 32))
    assert [eng.bucket_for(n) for n in (1, 8, 9, 32, 33)] == [8, 8, 16, 32,
                                                             None]
    stats = eng.compile()
    assert {"decode_s", "prefill_8_s", "prefill_16_s", "prefill_32_s",
            "total_s"} <= set(stats)
    assert eng.decode_steps == 0 and eng.prefills == 0  # warm-up not counted


# ----------------------------------------------------------- block manager


def test_block_manager_allocate_free_roundtrip():
    bm = BlockManager(num_blocks=8, block_size=4)
    assert [bm.blocks_for_tokens(n) for n in (1, 4, 5)] == [1, 1, 2]
    blocks = bm.allocate("a", 10)
    assert len(blocks) == 3 and bm.free_blocks == 5 and bm.used_blocks == 3
    assert bm.free("a") == 3 and bm.free_blocks == 8
    assert bm.stats()["total_allocated"] == bm.stats()["total_freed"] == 3
    assert bm.allocate("b", 40) is None  # exhaustion is backpressure


def test_prefix_blocks_shared_and_survive_one_sharer():
    bm = BlockManager(num_blocks=16, block_size=4)
    prompt = list(range(1, 9))  # 2 full blocks
    ta, ca, cowa = bm.admit("a", prompt, 12)
    assert ca == 0 and cowa == [] and len(ta) == 3
    tb, cb, cowb = bm.admit("b", prompt + [99], 12)
    assert cb == 8 and tb[:2] == ta[:2] and cowb == []
    assert bm.ref_count(ta[0]) == 2
    bm.free("a")
    assert bm.ref_count(ta[0]) == 1
    bm.free("b")
    assert bm.ref_count(ta[0]) == 0 and bm.cached_blocks >= 2
    tc, cc, _ = bm.admit("c", prompt + [7], 12)
    assert cc == 8 and tc[:2] == ta[:2]


def test_full_prompt_hit_copies_on_write_while_shared():
    bm = BlockManager(num_blocks=16, block_size=4)
    prompt = list(range(1, 9))
    ta, _, _ = bm.admit("a", prompt, 10)
    tb, cb, cowb = bm.admit("b", prompt, 10)
    assert cb == 7 and cowb == [(ta[1], tb[1])]
    bm.free("a")
    bm.free("b")
    _, cc, cowc = bm.admit("c", prompt, 10)
    assert cc == 7 and cowc == []
    assert bm.stats()["cow_copies"] == 1


def test_block_accounting_exact_under_interleaved_admit_retire():
    bm = BlockManager(num_blocks=12, block_size=4)
    prompt = list(range(1, 9))

    def used():
        s = bm.stats()
        assert s["free_blocks"] + s["used_blocks"] == s["num_blocks"]
        return s["used_blocks"]

    bm.admit("a", prompt, 16)
    assert used() == 4
    _, cb, _ = bm.admit("b", prompt + [9], 16)
    assert cb == 8 and used() == 6
    bm.free("a")
    assert used() == 4
    bm.admit("c", [1, 2, 3], 4)
    assert used() == 5
    bm.free("b")
    bm.free("c")
    s = bm.stats()
    assert used() == 0 and s["total_freed"] == s["total_allocated"] > 0


def test_prefix_cache_eviction_and_misuse():
    bm = BlockManager(num_blocks=4, block_size=4)
    bm.admit("a", list(range(1, 9)), 8)
    bm.free("a")
    assert bm.cached_blocks == 2
    assert bm.allocate("b", 16) is not None and bm.cached_blocks == 0
    assert bm.stats()["cached_evictions"] == 2
    bm.free("b")
    with pytest.raises(KVBlockError):
        bm.free("b")
    bm.admit("c", [1, 2, 3], 4)
    with pytest.raises(KVBlockError):
        bm.admit("c", [1, 2, 3], 4)
    with pytest.raises(KVBlockError):
        bm.admit("x", [], 4)


# ------------------------------------------------------------ queue/batcher


def test_queue_backpressure_drain_and_fault_point():
    q = AdmissionQueue(maxsize=2)
    q.submit(_req())
    q.submit(_req())
    with pytest.raises(QueueFull):
        q.submit(_req())
    q.pop()
    faultpoint.arm(FAULT_POINT_DROP, "drop", count=1)
    with pytest.raises(QueueFull, match="shed"):
        q.submit(_req())
    q.drain()
    with pytest.raises(Draining):
        q.submit(_req())
    assert (q.rejected_full, q.dropped, q.rejected_draining) == (1, 1, 1)


def test_join_at_boundary_retire_without_drain(params):
    eng = make_engine(params, slots=2)
    b = make_batcher(eng).start()
    try:
        r1 = b.submit(_req(n_prompt=3, max_new=2))
        r2 = b.submit(_req(n_prompt=3, max_new=12))
        r3 = b.submit(_req(n_prompt=3, max_new=2))
        for r in (r1, r2, r3):
            r.result(timeout=60)
        ev = {(kind, rid): step for kind, rid, step in b.events}
        assert ev[("admit", r3.id)] >= ev[("retire", r1.id)]
        assert ev[("retire", r2.id)] > ev[("admit", r3.id)]
    finally:
        b.stop()


def test_drain_finishes_accepted_work_zero_dropped(params):
    eng = make_engine(params, slots=2)
    b = make_batcher(eng).start()
    try:
        reqs = [b.submit(_req(n_prompt=4, max_new=10)) for _ in range(6)]
        b.drain(timeout=None)
        with pytest.raises(Draining):
            b.submit(_req())
        assert b.drain(timeout=60) is True
        assert all(len(r.result(timeout=5)["tokens"]) == 10 for r in reqs)
        stats = b.stats()
        assert stats["completed"] == 6 and stats["failed"] == 0
    finally:
        b.stop()


def test_submit_validates_against_engine_limits(params):
    eng = make_engine(params, slots=2, max_seq=32, buckets=(8, 16))
    b = make_batcher(eng)
    with pytest.raises(ValueError, match="prefill bucket"):
        b.submit(_req(n_prompt=20))
    with pytest.raises(ValueError, match="max_seq_len"):
        b.submit(_req(n_prompt=16, max_new=20))
    with pytest.raises(ValueError, match="unknown adapter"):
        b.submit(_req(model="finetune-a"))
