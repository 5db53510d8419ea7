"""Tensor lengths in the serving steps: the same outputs as int lengths and
as the JAX package's steps.

These are test_torch_serve_static.py's length checks; its helpers are
imported from there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.serve import model as jsm
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.serve import model as tsm
from test_torch_serve_static import (  # noqa: F401 (fixtures)
    BS,
    BUCKET,
    JCFG,
    POOL,
    TABLE,
    TCFG,
    params,
)


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
