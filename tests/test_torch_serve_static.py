"""The port's serve steps as the engine captures them: lengths, slots and
indices as device tensors, and no host read of a device value.

The engine captures each step once as a CUDA graph and replays it with new
inputs in the same buffers, so a step may take no length as a Python int
(a graph would freeze it) and may read nothing back to the host (`.item()`
cannot run inside a capture). Held here on the CPU, f32, TINY size:

  - `paged_prefill` with `suffix_len` / `prefix_len` as 0-d int32 tensors
    gives bitwise the results of the same call with ints, and the JAX
    function's (logits atol=rtol=1e-4, pools 1e-5), for several lengths in
    one bucket over a pool that already holds a prefix;
  - every step function runs on the meta device, where any read of a
    device value on the host raises ("Tensor.item() cannot be called on
    meta tensors").
"""

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
BS, MB, POOL, BUCKET = 8, 4, 9, 16
TABLE = np.array([0, 1, 2, 3], np.int32)


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jgpt2.init(jax.random.PRNGKey(0), JCFG))

    def draw(path, sd):
        if "scale" in jax.tree_util.keystr(path):
            return (1 + 0.1 * rng.normal(size=sd.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def prefixed(params):
    """Both packages' pools after a full prefill of a 20-token prompt into
    blocks 0-2 (bucket 32), and the prompt."""
    prompt = np.random.default_rng(1).integers(0, 128, 20).astype(np.int32)
    padded = np.zeros((32,), np.int32)
    padded[:20] = prompt
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tgpt2.params_from_numpy(params, "cpu")
    jc, _ = jsm.paged_prefill(jp, jsm.init_paged_cache(JCFG, POOL, BS),
                              jnp.asarray(padded), jnp.int32(20),
                              jnp.int32(0), jnp.asarray(TABLE), JCFG)
    tc, _ = tsm.paged_prefill(tp, tsm.init_paged_cache(TCFG, POOL, BS),
                              torch.from_numpy(padded), 20, 0,
                              torch.from_numpy(TABLE), TCFG)
    return jp, tp, jc, tc, prompt


@pytest.mark.parametrize("suffix_len, prefix_len",
                         [(16, 0), (9, 8), (3, 13), (1, 20)])
def test_tensor_lengths_equal_int_lengths_and_jax(prefixed, suffix_len,
                                                  prefix_len):
    jp, tp, jc, tc, prompt = prefixed
    padded = np.zeros((BUCKET,), np.int32)
    padded[:suffix_len] = np.random.default_rng(suffix_len).integers(
        0, 128, suffix_len)
    table = torch.from_numpy(TABLE)
    runs = {}
    for kind, lengths in (
            ("int", (suffix_len, prefix_len)),
            ("tensor", (torch.tensor(suffix_len, dtype=torch.int32),
                        torch.tensor(prefix_len, dtype=torch.int32)))):
        cache = {k: v.clone() for k, v in tc.items()}
        _, logits = tsm.paged_prefill(tp, cache, torch.from_numpy(padded),
                                      *lengths, table, TCFG)
        runs[kind] = (logits, cache)
    assert torch.equal(runs["int"][0], runs["tensor"][0])
    for key in ("k", "v"):
        assert torch.equal(runs["int"][1][key], runs["tensor"][1][key])
    jcache, jl = jsm.paged_prefill(jp, jc, jnp.asarray(padded),
                                   jnp.int32(suffix_len),
                                   jnp.int32(prefix_len), jnp.asarray(TABLE),
                                   JCFG)
    logits, cache = runs["tensor"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)


def _meta(shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.fixture(scope="module")
def meta_params(params):
    return tgpt2.map_params(lambda a: torch.from_numpy(np.array(a)).to(
        "meta"), params)


@pytest.mark.parametrize("step", ["paged_prefill", "paged_decode_step",
                                  "prefill", "decode_step",
                                  "copy_paged_block"])
@pytest.mark.parametrize("with_adapters", [False, True])
def test_steps_never_read_the_device_on_the_host(meta_params, step,
                                                 with_adapters):
    slots, scalar = 3, _meta(())
    adapters = (_meta((3, 128, 32), torch.float32) if with_adapters
                else None)
    paged = tsm.init_paged_cache(TCFG, POOL, BS, device="meta")
    dense = tsm.init_cache(TCFG, slots, 32, device="meta")
    idx = {"slot_adapter": scalar} if with_adapters else {}
    idxs = {"slot_adapters": _meta((slots,))} if with_adapters else {}
    if step == "paged_prefill":
        _, out = tsm.paged_prefill(meta_params, paged, _meta((BUCKET,)),
                                   scalar, scalar, _meta((MB,)), TCFG,
                                   adapters=adapters, **idx)
        assert out.shape == (128,)
    elif step == "paged_decode_step":
        _, out = tsm.paged_decode_step(
            meta_params, paged, _meta((slots,)), _meta((slots,)),
            _meta((slots, MB)), TCFG, attention_impl="reference",
            adapters=adapters, **idxs)
        assert out.shape == (slots, 128)
    elif step == "prefill":
        _, out = tsm.prefill(meta_params, dense, _meta((BUCKET,)), scalar,
                             scalar, TCFG, adapters=adapters, **idx)
        assert out.shape == (128,)
    elif step == "decode_step":
        _, out = tsm.decode_step(meta_params, dense, _meta((slots,)),
                                 _meta((slots,)), TCFG, adapters=adapters,
                                 **idxs)
        assert out.shape == (slots, 128)
    else:
        tsm.copy_paged_block(paged, scalar, scalar)
