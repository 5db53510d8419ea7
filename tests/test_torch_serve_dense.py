"""The port's slot-dense KV layout against the JAX package's.

The same numpy-seeded params and tokens go through
`determined_tpu.serve.model` (`prefill`, `decode_step`) and
`determined_tpu_torch.serve.model`, on the CPU, in f32 at the TINY size of
tests/test_serving.py; then the port's dense engine (`attention_impl:
dense`) against the JAX dense engine, the port's paged engine and the
continuous batcher. Tolerances: logits atol=rtol=1e-4 (matmuls summed in
another order); K/V lanes atol 1e-5; greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.serve import model as jsm
from determined_tpu.serve.engine import ServingEngine as JaxEngine
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.serve import (
    AdmissionQueue, ContinuousBatcher, Request, ServingEngine)
from determined_tpu_torch.serve import model as tsm

JCFG = jgpt2.Config(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
                    n_head=2, dtype=jnp.float32, remat=False,
                    attention_impl="dot")
TCFG = tgpt2.Config(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
                    n_head=2, dtype=torch.float32, remat=False,
                    attention_impl="dot")
SLOTS, MAX_SEQ = 3, 32


@pytest.fixture(scope="module")
def params():
    """Params in the JAX init's structure, drawn from numpy with a wide
    spread so greedy decoding is not degenerate."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jgpt2.init(jax.random.PRNGKey(0), JCFG))

    def draw(path, sd):
        if "scale" in jax.tree_util.keystr(path):
            return (1 + 0.1 * rng.normal(size=sd.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def dense_run(params):
    """Prompt A (11 tokens, bucket 16) into lane 0 and prompt B (5 tokens,
    bucket 8) into lane 2, then three decode steps with lane 1 inactive
    (position 0). Every call goes through both packages."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tgpt2.params_from_numpy(params, "cpu")
    rng = np.random.default_rng(1)
    jc = jsm.init_cache(JCFG, SLOTS, MAX_SEQ)
    tc = tsm.init_cache(TCFG, SLOTS, MAX_SEQ)
    steps = {}

    def keep(name, jl, tl):
        steps[name] = (np.asarray(jl), tl.numpy().copy(),
                       jax.tree_util.tree_map(np.asarray, jc),
                       {k: v.clone() for k, v in tc.items()})

    last = np.zeros((SLOTS,), np.int32)
    for name, n, bucket, slot in (("prefill_a", 11, 16, 0),
                                  ("prefill_b", 5, 8, 2)):
        padded = np.zeros((bucket,), np.int32)
        padded[:n] = rng.integers(0, 128, n)
        jc, jl = jsm.prefill(jp, jc, jnp.asarray(padded), jnp.int32(n),
                             jnp.int32(slot), JCFG)
        _, tl = tsm.prefill(tp, tc, torch.from_numpy(padded),
                            torch.tensor(n, dtype=torch.int32),
                            torch.tensor(slot, dtype=torch.int32), TCFG)
        keep(name, jl, tl)
        last[slot] = int(np.asarray(jl).argmax())
    positions = np.array([11, 0, 5], np.int32)
    for step in range(3):
        jc, jl = jsm.decode_step(jp, jc, jnp.asarray(last),
                                 jnp.asarray(positions), JCFG)
        _, tl = tsm.decode_step(tp, tc, torch.from_numpy(last),
                                torch.from_numpy(positions), TCFG)
        keep(f"decode_{step}", jl, tl)
        last = np.asarray(jl).argmax(-1).astype(np.int32)
        positions = positions + np.array([1, 0, 1], np.int32)
    return steps


@pytest.mark.parametrize("step", ["prefill_a", "prefill_b", "decode_0",
                                  "decode_1", "decode_2"])
def test_dense_steps_match_jax(dense_run, step):
    jl, tl, jc, tc = dense_run[step]
    assert tl.dtype == np.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), jc[key], atol=1e-5)


def test_dense_cache_geometry():
    cache = tsm.init_cache(TCFG, SLOTS, MAX_SEQ)
    assert tuple(cache["k"].shape) == (2, SLOTS, MAX_SEQ, 2, 16)
    assert tsm.cache_bytes(TCFG, SLOTS, MAX_SEQ) == jsm.cache_bytes(
        JCFG, SLOTS, MAX_SEQ) == 2 * cache["k"].numel() * 4
    with pytest.raises(ValueError, match="position table"):
        tsm.init_cache(TCFG, SLOTS, 65)


def _greedy(eng, prompts, n):
    """Greedy generations of `prompts`, one a slot, decoded together."""
    last = np.zeros((eng.slots,), np.int32)
    pos = np.zeros((eng.slots,), np.int32)
    out = []
    for slot, prompt in enumerate(prompts):
        last[slot] = eng.prefill_request(slot, np.asarray(prompt, np.int32))
        pos[slot] = len(prompt)
        out.append([int(last[slot])])
    for _ in range(n - 1):
        last = np.asarray(eng.decode(last, pos, np.zeros((eng.slots,),
                                                         np.float32)),
                          np.int32)
        pos = pos + np.array([1] * len(prompts)
                             + [0] * (eng.slots - len(prompts)), np.int32)
        for slot in range(len(prompts)):
            out[slot].append(int(last[slot]))
    return out


PROMPTS = ([5, 9, 17, 3, 77, 41], [100, 2, 64, 8, 8, 1, 99, 3, 12, 50])


def test_dense_engine_matches_jax_dense_engine_and_paged(params):
    jeng = JaxEngine(jax.tree_util.tree_map(jnp.asarray, params), JCFG,
                     slots=SLOTS, max_seq_len=MAX_SEQ,
                     prefill_buckets=[8, 16], attention_impl="dense")
    jeng.compile()
    teng = ServingEngine(params, TCFG, slots=SLOTS, max_seq_len=MAX_SEQ,
                         prefill_buckets=[8, 16], attention_impl="dense",
                         device="cpu")
    stats = teng.compile()
    assert not teng.paged and teng.attention_impl == "dense"
    assert {"decode_s", "prefill_8_s", "prefill_16_s", "total_s"} <= set(
        stats) and "copy_block_s" not in stats
    want = _greedy(jeng, PROMPTS, 8)
    assert _greedy(teng, PROMPTS, 8) == want
    assert all(len(set(t)) > 1 for t in want)  # non-degenerate
    paged = ServingEngine(params, TCFG, slots=SLOTS, max_seq_len=MAX_SEQ,
                          prefill_buckets=[8, 16], kv_block_size=8,
                          device="cpu")
    assert _greedy(paged, PROMPTS, 8) == want
    est = teng.stats()
    assert est["kv_layout"] == "dense" and est["kv_block_size"] is None
    assert est["cache_hbm_bytes"] == tsm.cache_bytes(TCFG, SLOTS, MAX_SEQ)
    with pytest.raises(RuntimeError, match="paged"):
        teng.copy_block(0, 1)
    with pytest.raises(ValueError, match="paged"):
        teng.prefill_request(0, np.arange(1, 6, dtype=np.int32),
                             cached_len=2)


def test_dense_batcher_serves_a_burst_like_the_paged_one(params):
    """The batcher's dense path (lane per slot, accounting-only block
    manager) answers a burst with the paged replica's tokens and frees
    every block."""
    outs = {}
    for impl in ("dense", "reference"):
        eng = ServingEngine(params, TCFG, slots=2, max_seq_len=MAX_SEQ,
                            prefill_buckets=[8, 16], attention_impl=impl,
                            kv_block_size=8, device="cpu")
        b = ContinuousBatcher(eng, queue=AdmissionQueue(16),
                              idle_wait_s=0.005)
        if impl == "dense":
            assert b.blocks.block_size == 16  # accounting-only pool
        b.start()
        try:
            reqs = [b.submit(Request(p, max_new_tokens=5))
                    for p in PROMPTS + (PROMPTS[0][:3],)]
            outs[impl] = [r.result(timeout=120)["tokens"] for r in reqs]
        finally:
            b.stop()
        assert b.blocks.used_blocks == 0 and b.completed == 3
    assert outs["dense"] == outs["reference"]
