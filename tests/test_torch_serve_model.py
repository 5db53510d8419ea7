"""The port's GPT-2 params and paged serve steps against the JAX package's.

The same numpy-seeded params and tokens go through
`determined_tpu.serve.model` (paged prefill/decode with the reference
attention) and `determined_tpu_torch.serve.model`, on the CPU, in f32 at
the TINY size of tests/test_serving.py. Tolerances: logits atol=rtol=1e-4
(matmuls summed in another order); K/V pools atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.serve import model as jsm
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.serve import model as tsm

JCFG = jgpt2.Config(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
                    n_head=2, dtype=jnp.float32, remat=False,
                    attention_impl="dot")
TCFG = tgpt2.Config(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
                    n_head=2, dtype=torch.float32, remat=False,
                    attention_impl="dot")
BS, MB = 8, 4
POOL = 8 + 1  # 8 blocks + trash


def numpy_params(seed=0):
    """Params with the JAX init's structure and shapes, drawn from numpy
    with a wide spread so greedy decoding is not degenerate."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jgpt2.init(jax.random.PRNGKey(0), JCFG))

    def draw(path, sd):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1 + 0.1 * rng.normal(size=sd.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def pools_close(jcache, tcache, atol=1e-5):
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=atol)


# ------------------------------------------------------------- params / init


def test_params_from_numpy_round_trip(tmp_path):
    tree = numpy_params()
    tparams = tgpt2.params_from_numpy(tree, "cpu")
    back = tgpt2.params_to_numpy(tparams)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)
    path = str(tmp_path / "params.npz")
    tgpt2.save_params_npz(path, tparams)
    loaded = tgpt2.load_params_npz(path)
    with np.load(path) as data:
        assert "blocks/qkv/kernel" in data.files
    assert jax.tree_util.tree_structure(loaded) == \
        jax.tree_util.tree_structure(tree)
    for (_, a), (_, b) in zip(flat_a,
                              jax.tree_util.tree_leaves_with_path(loaded)):
        np.testing.assert_array_equal(a, b)


def test_init_matches_jax_shapes_and_stds():
    cfg_j = dataclasses.replace(JCFG, n_layer=4, d_model=64, n_head=4)
    cfg_t = dataclasses.replace(TCFG, n_layer=4, d_model=64, n_head=4)
    jp = jgpt2.init(jax.random.PRNGKey(0), cfg_j)
    tp = tgpt2.init(torch.Generator().manual_seed(0), cfg_t)
    jflat = {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    tflat = {jax.tree_util.keystr(p): v.numpy()
             for p, v in jax.tree_util.tree_leaves_with_path(tp)}
    assert jflat.keys() == tflat.keys()
    for name, a in jflat.items():
        b = tflat[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert abs(a.std() - b.std()) <= 0.1 * a.std() + 1e-6, name
        assert abs(a.mean() - b.mean()) <= 0.01, name
    assert tgpt2.param_count(cfg_t) == jgpt2.param_count(cfg_j) == sum(
        v.size for v in tflat.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    jout = jgpt2._layer_norm(jnp.asarray(x, getattr(jnp, dtype)),
                             jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    tout = tgpt2._layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(scale), torch.from_numpy(bias),
                             1e-5)
    assert str(tout.dtype) == f"torch.{dtype}"
    atol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=atol, rtol=0)


# ------------------------------------------------------- paged prefill/decode


@pytest.fixture(scope="module")
def paged_run():
    """Sequence A: a 12-token prompt, full prefill into blocks [0, 1].
    Sequence B: shares A's first full block and prefills only its 6-token
    suffix at prefix_len 8 into block 4. Then one decode step for both.
    Every call goes through both packages; results kept side by side."""
    tree = numpy_params()
    jp, tp = as_jax(tree), tgpt2.params_from_numpy(tree, "cpu")
    rng = np.random.default_rng(2)
    prompt_a = rng.integers(0, 128, 12).astype(np.int32)
    prompt_b = np.concatenate(
        [prompt_a[:8], rng.integers(0, 128, 6)]).astype(np.int32)
    table_a = np.array([0, 1, 2, 3], np.int32)
    table_b = np.array([0, 4, 5, 6], np.int32)
    jc = jsm.init_paged_cache(JCFG, POOL, BS)
    tc = tsm.init_paged_cache(TCFG, POOL, BS)
    steps = {}

    def prefill(name, tokens, bucket, prefix, table):
        nonlocal jc
        padded = np.zeros((bucket,), np.int32)
        suffix = tokens[prefix:]
        padded[:len(suffix)] = suffix
        jc, jl = jsm.paged_prefill(
            jp, jc, jnp.asarray(padded), jnp.int32(len(suffix)),
            jnp.int32(prefix), jnp.asarray(table), JCFG)
        _, tl = tsm.paged_prefill(
            tp, tc, torch.from_numpy(padded), len(suffix), prefix,
            torch.from_numpy(table), TCFG)
        steps[name] = (np.asarray(jl), tl.numpy(), jax.tree_util.tree_map(
            np.asarray, jc), {k: v.clone() for k, v in tc.items()})

    prefill("prefill_a", prompt_a, 16, 0, table_a)
    prefill("prefill_b", prompt_b, 8, 8, table_b)
    tokens = np.array([int(steps["prefill_a"][0].argmax()),
                       int(steps["prefill_b"][0].argmax())], np.int32)
    positions = np.array([12, 14], np.int32)
    tables = np.stack([table_a, table_b])
    jc, jl = jsm.paged_decode_step(
        jp, jc, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables), JCFG, attention_impl="reference")
    _, tl = tsm.paged_decode_step(
        tp, tc, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(tables), TCFG)
    steps["decode"] = (np.asarray(jl), tl.numpy(),
                       jax.tree_util.tree_map(np.asarray, jc), tc)
    return steps


@pytest.mark.parametrize("step", ["prefill_a", "prefill_b", "decode"])
def test_paged_steps_match_jax(paged_run, step):
    jl, tl, jc, tc = paged_run[step]
    assert tl.dtype == np.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    pools_close(jc, tc)


def test_prefix_prefill_writes_only_its_suffix_block(paged_run):
    """B's prefill at prefix_len 8 wrote only block 4 (its suffix) and the
    trash block; block 0, shared with A, is untouched."""
    _, _, _, after_a = paged_run["prefill_a"]
    _, _, _, after_b = paged_run["prefill_b"]
    for key in ("k", "v"):
        diff = (after_a[key] != after_b[key]).any(dim=(0, 2, 3, 4))
        assert set(torch.nonzero(diff).flatten().tolist()) <= {4, POOL - 1}
        assert diff[4]


def test_copy_paged_block_matches_jax():
    rng = np.random.default_rng(4)
    k = rng.normal(size=(2, POOL, BS, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, POOL, BS, 2, 16)).astype(np.float32)
    jc = jsm.copy_paged_block({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                              jnp.int32(5), jnp.int32(2))
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    out = tsm.copy_paged_block(tc, 5, 2)
    assert out is tc  # updated in place
    pools_close(jc, tc, atol=0)


def test_sample_greedy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(6, 128)).astype(np.float32)
    temps = np.zeros((6,), np.float32)
    jt = jsm.sample(jnp.asarray(logits), jnp.asarray(temps),
                    jax.random.PRNGKey(0))
    tt = tsm.sample(torch.from_numpy(logits), torch.from_numpy(temps),
                    torch.Generator().manual_seed(0))
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_sample_temperature_draws_from_the_softmax():
    """At temperature t the draws follow softmax(logits / t): compare the
    frequencies of 20k draws with the probabilities (bits differ from
    jax.random, so only the distribution is checked)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(20000, 1)
    temps = torch.full((20000,), 0.7)
    draws = tsm.sample(logits, temps, torch.Generator().manual_seed(0))
    freq = torch.bincount(draws.long(), minlength=4).float() / 20000
    probs = torch.softmax(logits[0] / 0.7, dim=-1)
    assert torch.allclose(freq, probs, atol=0.015), (freq, probs)
    # Mixed batch: greedy lanes stay argmax.
    temps[::2] = 0
    mixed = tsm.sample(logits, temps, torch.Generator().manual_seed(1))
    assert (mixed[::2] == 0).all()


def test_moe_config_is_refused():
    # MoE is no longer refused: `init` gives the JAX init's tree, shapes
    # and dtypes (the `moe` subtree in place of the dense FFN), and
    # `param_logical_axes` the JAX axes, leaf for leaf.
    cfg = dataclasses.replace(TCFG, num_experts=4)
    jcfg = dataclasses.replace(JCFG, num_experts=4)
    tree = tgpt2.init(torch.Generator().manual_seed(0), cfg)
    want = jax.eval_shape(lambda: jgpt2.init(jax.random.PRNGKey(0), jcfg))
    flat = {jax.tree_util.keystr(p): (tuple(sd.shape), np.dtype(sd.dtype))
            for p, sd in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {jax.tree_util.keystr(p): (tuple(t.shape),
                                     np.dtype(str(t.dtype)[6:]))
           for p, t in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == flat
    assert "['blocks']['moe']['up']['kernel']" in got
    assert not any("mlp_up" in k for k in got)
    assert tgpt2.param_logical_axes(cfg) == jgpt2.param_logical_axes(jcfg)
