"""Multi-adapter serving in the port against the JAX package.

An adapter is the tied embedding / LM-head table of a head-tuned
fine-tune; the engine stacks the tables `[A+1, V, D]` (index 0 = base) and
picks one a lane. Held here, on the CPU in f32 at the TINY size of
tests/test_serving.py, with numpy-seeded params:

  - `_embed_adapter` and `_finish_adapter`, and the paged prefill and
    decode with adapters, against the JAX functions (atol=rtol=1e-4);
  - the adapter-routed logits of an engine against a direct serve of the
    fine-tune's full params, step by step (`prefill_logits` /
    `decode_logits`: what the engine samples from; atol=rtol=1e-4), and
    base routing against a no-adapter engine;
  - a mixed continuous batch routes per slot (each lane's tokens equal its
    solo run, and the fine-tunes really change the tokens);
  - a wrong-shape or missing `wte` is refused, an unknown name is a 400.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.serve import model as jsm
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
PROMPT = [5, 9, 17, 3]


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jgpt2.init(jax.random.PRNGKey(0), JCFG))

    def draw(path, sd):
        if "scale" in jax.tree_util.keystr(path):
            return (1 + 0.1 * rng.normal(size=sd.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def finetune(params, seed):
    """The same body with the tied table perturbed: a head-tuned fine-tune
    (what the engine stacks)."""
    ft = dict(params)
    ft["wte"] = (params["wte"] + 0.5 * np.random.default_rng(seed).normal(
        size=params["wte"].shape)).astype(np.float32)
    return ft


@pytest.fixture(scope="module")
def stack(params):
    return np.stack([params["wte"], finetune(params, 7)["wte"],
                     finetune(params, 11)["wte"]])


def test_embed_and_finish_adapter_match_jax(params, stack):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 128, 6).astype(np.int32)
    tp = tgpt2.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tstack, jstack = torch.from_numpy(stack), jnp.asarray(stack)
    for idx in (np.int32(2), np.array([1, 0, 2, 2, 0, 1], np.int32)):
        want = jsm._embed_adapter(jstack, jnp.asarray(idx),
                                  jnp.asarray(tokens), jnp.float32)
        got = tsm._embed_adapter(tstack, torch.from_numpy(np.asarray(idx)),
                                 torch.from_numpy(tokens), torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.normal(size=(1, 5, 32)).astype(np.float32)  # prefill: [1, S, D]
    want = jsm._finish_adapter(jp, jnp.asarray(x), jstack, jnp.int32(1),
                               JCFG, None)
    got = tsm._finish_adapter(tp, torch.from_numpy(x), tstack,
                              torch.tensor(1, dtype=torch.int32), TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    x = rng.normal(size=(3, 1, 32)).astype(np.float32)  # decode: [slots,1,D]
    idx = np.array([2, 0, 1], np.int32)
    want = jsm._finish_adapter(jp, jnp.asarray(x), jstack, jnp.asarray(idx),
                               JCFG, None)
    got = tsm._finish_adapter(tp, torch.from_numpy(x), tstack,
                              torch.from_numpy(idx), TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_paged_steps_with_adapters_match_jax(params, stack):
    """Lane 0 prefills with adapter 2, then one decode step routes lanes
    [2, 0, 1] (lane 1 and 2 inactive on the trash block)."""
    tp = tgpt2.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tstack, jstack = torch.from_numpy(stack), jnp.asarray(stack)
    bs, mb, pool = 8, 4, 13
    jc = jsm.init_paged_cache(JCFG, pool, bs)
    tc = tsm.init_paged_cache(TCFG, pool, bs)
    padded = np.zeros((8,), np.int32)
    padded[:4] = PROMPT
    table = np.array([0, 1, 2, 3], np.int32)
    jc, jl = jsm.paged_prefill(jp, jc, jnp.asarray(padded), jnp.int32(4),
                               jnp.int32(0), jnp.asarray(table), JCFG,
                               adapters=jstack, slot_adapter=jnp.int32(2))
    _, tl = tsm.paged_prefill(tp, tc, torch.from_numpy(padded), 4, 0,
                              torch.from_numpy(table), TCFG, adapters=tstack,
                              slot_adapter=torch.tensor(2))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    tokens = np.array([int(np.asarray(jl).argmax()), 0, 0], np.int32)
    positions = np.array([4, 0, 0], np.int32)
    tables = np.stack([table] + [np.full((mb,), pool - 1, np.int32)] * 2)
    idx = np.array([2, 0, 1], np.int32)
    _, jl = jsm.paged_decode_step(
        jp, jc, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables), JCFG, attention_impl="reference",
        adapters=jstack, slot_adapters=jnp.asarray(idx))
    _, tl = tsm.paged_decode_step(
        tp, tc, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(tables), TCFG, adapters=tstack,
        slot_adapters=torch.from_numpy(idx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


def _engine(params, adapters=None, slots=4):
    return ServingEngine(params, TCFG, slots=slots, max_seq_len=32,
                         prefill_buckets=[8, 16], kv_block_size=8,
                         adapters=adapters, device="cpu")


def _logits_of_a_generation(eng, adapter, n):
    """The logits of a greedy generation of PROMPT in slot 0 with
    `adapter`: the prefill's, then n - 1 decode steps'."""
    out = [eng.prefill_logits(0, np.asarray(PROMPT, np.int32),
                              adapter=adapter).clone()]
    tokens = np.zeros((eng.slots,), np.int32)
    positions = np.zeros((eng.slots,), np.int32)
    for step in range(n - 1):
        tokens[0], positions[0] = int(out[-1].argmax()), len(PROMPT) + step
        out.append(eng.decode_logits(tokens, positions)[0].clone())
    eng.release_slot(0)
    return torch.stack(out).numpy()


def test_adapter_routed_logits_equal_a_direct_serve(params):
    ft = finetune(params, 7)
    eng = _engine(params, adapters={"ft": ft})
    assert eng.has_adapters and eng.adapter_names == ["ft"]
    routed = _logits_of_a_generation(eng, eng.adapter_index("ft"), 8)
    direct = _logits_of_a_generation(_engine(ft), 0, 8)
    np.testing.assert_allclose(routed, direct, atol=1e-4, rtol=1e-4)
    base = _logits_of_a_generation(eng, 0, 8)
    plain = _logits_of_a_generation(_engine(params), 0, 8)
    np.testing.assert_allclose(base, plain, atol=1e-4, rtol=1e-4)
    # The fine-tune moves the logits (a precondition, not a tolerance).
    assert np.abs(routed[0] - base[0]).max() > 1.0


def test_mixed_batch_routes_per_slot(params):
    eng = _engine(params, adapters={"ft-a": finetune(params, 7),
                                    "ft-b": finetune(params, 11)})

    def run(models):
        b = ContinuousBatcher(eng, queue=AdmissionQueue(16),
                              idle_wait_s=0.005)
        b.start()
        try:
            reqs = [b.submit(Request(PROMPT, max_new_tokens=10, model=m))
                    for m in models]
            return [r.result(timeout=120)["tokens"] for r in reqs], b
        finally:
            b.stop()

    outs, b = run([None, "ft-a", "ft-b", None])
    assert b.max_occupancy >= 2  # the lanes really shared decode steps
    assert b.stats()["adapter_requests"] == {"base": 2, "ft-a": 1, "ft-b": 1}
    solo = {m: run([m])[0][0] for m in (None, "ft-a", "ft-b")}
    assert outs == [solo[None], solo["ft-a"], solo["ft-b"], solo[None]]
    assert len({tuple(t) for t in solo.values()}) == 3
    assert eng.stats()["adapters"] == ["ft-a", "ft-b"]
    assert eng._slot_adapters.tolist() == [0, 0, 0, 0]  # released to base


def test_adapter_refusals(params):
    bad = dict(params)
    bad["wte"] = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError, match="geometry"):
        _engine(params, adapters={"bad": bad})
    with pytest.raises(ValueError, match="no 'wte'"):
        _engine(params, adapters={"bad": {"blocks": params["blocks"]}})
    eng = _engine(params, adapters={"ft": finetune(params, 7)})
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.adapter_index("ghost")
    plain = _engine(params)
    with pytest.raises(ValueError, match="unknown adapter"):
        ContinuousBatcher(plain).submit(Request(PROMPT, model="ft"))
    with pytest.raises(ValueError, match="no adapters"):
        plain.prefill_request(0, np.asarray(PROMPT, np.int32), adapter=1)
