"""MoE GPT-2 against the JAX package: logits, loss and every gradient, and
the paged and dense serving steps.

These are test_torch_moe.py's model checks; its helpers are imported from
there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu_torch.models import gpt2 as tgpt2
from test_torch_moe import (  # noqa: F401 (fixtures)
    routes,
    assert_margin,
    to_jax,
    DIMS,
    gpt2_configs,
    numpy_params,
    serve_run,
)


@pytest.mark.parametrize("remat,policy", [(False, "dots"), (True, "dots")],
                         ids=["no-remat", "remat-dots"])
def test_moe_gpt2_logits_loss_and_grads_match_jax(routes, remat, policy):
    jcfg, tcfg = gpt2_configs(remat=remat, remat_policy=policy)
    params = numpy_params(jcfg, seed=1)
    tokens = np.random.default_rng(1).integers(
        0, DIMS["vocab_size"], size=(3, 18)).astype(np.int32)

    batch = {"tokens": jnp.asarray(tokens)}
    (jlogits, jaux), (jloss, jgrads) = jax.jit(lambda p: (
        jgpt2.apply(p, batch["tokens"][:, :-1], jcfg, return_aux=True),
        jax.value_and_grad(jgpt2.loss_fn)(p, batch, jcfg)))(to_jax(params))

    tp = tgpt2.params_from_numpy(params)
    leaves = [t.requires_grad_(True) for t in
              tgpt2._flatten(tp).values()]
    tlogits, taux = tgpt2.apply(tp, torch.from_numpy(tokens[:, :-1]), tcfg,
                                return_aux=True)
    tloss = tgpt2.loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    grads = torch.autograd.grad(tloss, leaves)
    assert_margin(routes)

    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=2e-5, rtol=0)
    assert float(jaux) > 0.5  # the aux term is in the loss
    tgrads = tgpt2._unflatten(dict(zip(tgpt2._flatten(tp),
                                       (g.numpy() for g in grads))))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(tgrads))
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        np.testing.assert_allclose(flat_g[path], np.asarray(w), atol=2e-5,
                                   rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("step", [
    "paged_prefill_0", "paged_prefill_1", "paged_decode",
    "dense_prefill_0", "dense_prefill_1", "dense_decode"])
def test_moe_serving_steps_match_jax(serve_run, step):
    assert_margin(serve_run["routes"])
    jl, tl = serve_run[step]
    assert tl.dtype == np.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    if step == "paged_decode":
        jc, tc = serve_run["pools"]
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), jc[key], atol=1e-5)
