"""`make_multi_step` and the remat policies against the JAX package, on
the CPU.

On the CPU `make_multi_step` runs its steps eagerly (the plain version of
the CUDA-graph replay, with the optimizer's floats fed as a tensor as a
replay feeds them): N of its steps must equal N `make_train_step` calls
bitwise, and its final params and window-mean metrics must be those of
the JAX package's `make_multi_step` (a `lax.scan`) within 1e-5. Every
remat policy of the JAX package gives the loss and gradients of
`jax.grad` under the same policy within 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.train.state import create_train_state as j_create_state
from determined_tpu.train.step import make_multi_step as j_make_multi_step
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.state import create_train_state
from determined_tpu_torch.train.step import make_multi_step, make_train_step

DIMS = dict(vocab_size=96, n_positions=32, d_model=32, n_layer=2, n_head=2)
N = 3  # steps_per_call
CALLS = 2


def numpy_params(seed=0, std=0.2):
    rng = np.random.default_rng(seed)
    cfg = tgpt2.Config(**DIMS, dtype=torch.float32)
    flat = tgpt2._flatten(tgpt2.init(torch.Generator().manual_seed(0), cfg))
    return tgpt2._unflatten({
        k: ((1.0 if k.endswith("scale") else 0.0)
            + std * rng.normal(size=tuple(v.shape))).astype(np.float32)
        for k, v in flat.items()})


def windows(seed=5, b=3, s=17):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, DIMS["vocab_size"], size=(N, b, s))
            .astype(np.int32) for _ in range(CALLS)]


def port_tx():
    sched = optim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 100)
    return optim.chain(optim.clip_by_global_norm(1.0),
                       optim.adamw(sched, b2=0.95, weight_decay=0.1))


def port_state(params, tx):
    return create_train_state(lambda g: tgpt2.params_from_numpy(params), tx,
                              torch.Generator(), device="cpu")


def flat_np(tree):
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tgpt2._flatten(tree).items()}


def test_replays_equal_train_step_calls_bitwise():
    cfg = tgpt2.Config(**DIMS, dtype=torch.float32, remat=True)
    params = numpy_params()

    def loss(p, b, r):
        return tgpt2.loss_fn(p, b, cfg)

    tx_a, tx_b = port_tx(), port_tx()
    multi = make_multi_step(loss, tx_a, steps_per_call=N)
    one = make_train_step(loss, tx_b)
    a, b = port_state(params, tx_a), port_state(params, tx_b)
    for w in windows():
        a, means = multi(a, {"tokens": torch.from_numpy(w)}, None)
        per_step = []
        for i in range(N):
            b, m = one(b, {"tokens": torch.from_numpy(w[i])}, None)
            per_step.append(m)
        for k in ("loss", "grad_norm", "all_finite"):
            want = torch.stack([m[k].float() for m in per_step]).sum() / N
            assert torch.equal(means[k], want), k
    assert a.step == b.step == N * CALLS
    assert a.opt_state[1]["count"] == b.opt_state[1]["count"] == N * CALLS
    fa, fb = flat_np(a.params), flat_np(b.params)
    for k in fb:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    for ta, tb in zip(a.opt_state[1]["mu"] + a.opt_state[1]["nu"],
                      b.opt_state[1]["mu"] + b.opt_state[1]["nu"]):
        assert torch.equal(ta, tb)


def test_final_params_and_window_means_match_jax():
    tcfg = tgpt2.Config(**DIMS, dtype=torch.float32, remat=True)
    jcfg = jgpt2.Config(**DIMS, dtype=jnp.float32, remat=True)
    params = numpy_params(seed=3)
    jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 100), b2=0.95,
        weight_decay=0.1))
    jstate = j_create_state(
        lambda r: jax.tree_util.tree_map(jnp.asarray, params), jtx,
        jax.random.PRNGKey(0))
    jmulti = j_make_multi_step(lambda p, b, r: jgpt2.loss_fn(p, b, jcfg),
                               jtx, N, donate_state=False)
    ttx = port_tx()
    tstate = port_state(params, ttx)
    tmulti = make_multi_step(lambda p, b, r: tgpt2.loss_fn(p, b, tcfg), ttx,
                             steps_per_call=N)
    for w in windows():
        jstate, jm = jmulti(jstate, {"tokens": jnp.asarray(w)},
                            jax.random.PRNGKey(0))
        tstate, tm = tmulti(tstate, {"tokens": torch.from_numpy(w)}, None)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    assert tstate.step == int(jstate.step) == N * CALLS
    jflat = {k: np.asarray(v) for k, v in tgpt2._flatten(
        jax.tree_util.tree_map(np.asarray, jstate.params)).items()}
    d = DIMS["d_model"]
    for k, got in flat_np(tstate.params).items():
        want = jflat[k]
        if k == "blocks/qkv/bias":
            # The key bias: a gradient 0 in exact arithmetic, whose fp32
            # noise Adam turns into steps of up to lr (test_torch_train_
            # model.py): held to 2 lr a moving step.
            np.testing.assert_allclose(got[:, d:2 * d], want[:, d:2 * d],
                                       atol=2e-3 * (N * CALLS - 1))
            got = np.delete(got, np.s_[d:2 * d], 1)
            want = np.delete(want, np.s_[d:2 * d], 1)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=k)


def test_batches_need_the_window_axis():
    cfg = tgpt2.Config(**DIMS, dtype=torch.float32)
    tx = port_tx()
    multi = make_multi_step(lambda p, b, r: tgpt2.loss_fn(p, b, cfg), tx, N)
    with pytest.raises(ValueError, match="steps_per_call"):
        multi(port_state(numpy_params(), tx),
              {"tokens": torch.zeros((N + 1, 2, 17), dtype=torch.int32)},
              None)
    with pytest.raises(ValueError, match="steps_per_call"):
        make_multi_step(lambda p, b, r: 0, tx, 0)


@pytest.mark.parametrize("policy,attention_impl", [
    (None, "auto"), ("nothing", "auto"), ("dots", "auto"),
    ("dots_saveable", "auto"), ("everything", "auto"),
    # Attention through plain batched products, which "dots" recomputes
    # and "dots_saveable" keeps.
    ("dots", "dense"), ("dots_saveable", "dense")])
def test_remat_policy_loss_and_grads_match_jax(policy, attention_impl):
    tcfg = tgpt2.Config(**DIMS, dtype=torch.float32, remat=True,
                        remat_policy=policy, attention_impl=attention_impl)
    jcfg = jgpt2.Config(**DIMS, dtype=jnp.float32, remat=True,
                        remat_policy=policy,
                        attention_impl="dot" if attention_impl == "dense"
                        else "reference")
    params = numpy_params(seed=2)
    tokens = np.random.default_rng(9).integers(
        0, DIMS["vocab_size"], size=(3, 17)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jgpt2.loss_fn(
        p, {"tokens": jnp.asarray(tokens)}, jcfg)))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tparams = tgpt2.params_from_numpy(params)
    leaves = tgpt2._flatten(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    tloss = tgpt2.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)},
                          tcfg)
    grads = torch.autograd.grad(tloss, list(leaves.values()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=2e-5)
    jflat = {k: np.asarray(v) for k, v in tgpt2._flatten(
        jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jflat[k], atol=2e-5,
                                   rtol=1e-4, err_msg=k)


def test_policies_save_what_their_comment_says():
    """The selective policies keep the products they name and recompute
    the rest: counted by the ops each runs again in the backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    params = tgpt2.params_from_numpy(numpy_params())
    leaves = list(tgpt2._flatten(params).values())
    for t in leaves:
        t.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, DIMS["vocab_size"], size=(2, 17)).astype(np.int32))

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    def backward_ops(policy, impl):
        cfg = tgpt2.Config(**DIMS, dtype=torch.float32, remat=True,
                           remat_policy=policy, attention_impl=impl)
        loss = tgpt2.loss_fn(params, {"tokens": tokens}, cfg)
        with Count() as c:
            torch.autograd.grad(loss, leaves)
        return c.ops

    mm = torch.ops.aten.mm.default
    bmm = torch.ops.aten.bmm.default
    # Attention through plain matmuls ("dense") has batched products.
    full = backward_ops(None, "dense")
    dots = backward_ops("dots", "dense")
    saveable = backward_ops("dots_saveable", "dense")
    everything = backward_ops("everything", "dense")
    # The backward of the block's products is itself products: compare
    # with "everything", which recomputes nothing.
    assert full.count(mm) > dots.count(mm) == everything.count(mm)
    assert dots.count(bmm) > saveable.count(bmm) == everything.count(bmm)
    assert backward_ops("nothing", "dense").count(mm) == full.count(mm)
