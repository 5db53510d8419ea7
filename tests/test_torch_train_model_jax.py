"""GPT-2's logits, loss and gradients, the optimizer and the train step of the
port against the JAX package's (jax.grad, optax, the JAX train step).

These are test_torch_train_model.py's checks that run the JAX side; its
helpers are imported from there."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.train.state import create_train_state as j_create_state
from determined_tpu.train.step import make_train_step as j_make_train_step
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.state import create_train_state
from determined_tpu_torch.train.step import make_train_step
from test_torch_train_model import (  # noqa: F401 (fixtures)
    DIMS,
    _configs,
    numpy_params,
    _tokens,
    _to_jax,
    _leaves_np,
    _optax_chain,
    _port_chain,
)


@pytest.mark.parametrize("remat, policy", [(False, "dots"), (True, None),
                                           (True, "dots")])
def test_logits_loss_and_grads_match_jax(remat, policy):
    jcfg, tcfg = _configs(remat, policy)
    params = numpy_params()
    tokens = _tokens()
    jparams = _to_jax(params)
    tparams = tgpt2.params_from_numpy(params)
    for t in tgpt2._flatten(tparams).values():
        t.requires_grad_(True)

    jlogits = jax.jit(lambda p, t: jgpt2.apply(p, t, jcfg))(
        jparams, jnp.asarray(tokens[:, :-1]))
    tlogits = tgpt2.apply(tparams, torch.from_numpy(tokens[:, :-1]), tcfg)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=0)

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgpt2.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg)))(
        jparams)
    tloss = tgpt2.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg)
    leaves = tgpt2._flatten(tparams)
    tgrads = dict(zip(leaves, torch.autograd.grad(tloss,
                                                  list(leaves.values()))))
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=2e-5)
    jflat = _leaves_np(jgrads)
    assert set(jflat) == set(tgrads)
    for k, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jflat[k], atol=2e-5, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["unclipped", "clipped"])
@pytest.mark.parametrize("which", ["example_chain", "jaxtrial_default"])
def test_optimizer_matches_optax(which, grad_scale):
    """Four steps with warmup 1 (step 0 has lr 0 in both: the schedule is
    read before the count moves), so three of them move the params."""
    rng = np.random.default_rng(3)
    shapes = [(5, 3), (7,), (2, 4, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if which == "example_chain":
        jtx, ttx = _optax_chain(1e-3, 1, 50), _port_chain(1e-3, 1, 50)
    else:  # JaxTrial.optimizer / TorchTrial.optimizer: adamw(lr), wd 1e-4
        jtx, ttx = optax.adamw(1e-3), optim.adamw(1e-3)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = ttx.init(tp)
    for step in range(4):
        grads = [(grad_scale * rng.normal(size=s)).astype(np.float32)
                 for s in shapes]
        upd, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = ttx.update([torch.from_numpy(g) for g in grads],
                                  tstate, tp)
        optim.apply_updates(tp, tupd)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0, err_msg=f"step {step}")
    moved = max(float(np.abs(a.numpy() - p).max())
                for a, p in zip(tp, params))
    assert moved > 1e-4  # the steps after the first did move the params


def test_train_step_metrics_and_params_match_jax():
    jcfg, tcfg = _configs(remat=True)
    params = numpy_params(seed=4)
    batches = [_tokens(seed=10 + i) for i in range(3)]

    jtx = _optax_chain(1e-3, 1, 100)
    jstate = j_create_state(lambda r: _to_jax(params), jtx,
                            jax.random.PRNGKey(0))
    jstep = j_make_train_step(
        lambda p, b, r: jgpt2.loss_fn(p, b, jcfg), jtx, donate_state=False)
    ttx = _port_chain(1e-3, 1, 100)
    tstate = create_train_state(lambda g: tgpt2.params_from_numpy(params),
                                ttx, torch.Generator(), device="cpu")
    tstep = make_train_step(lambda p, b, r: tgpt2.loss_fn(p, b, tcfg), ttx)
    for i, tokens in enumerate(batches):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)},
                           jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens)},
                           None)
        assert set(tm) == set(jm) == {"loss", "grad_norm", "all_finite"}
        for k in ("loss", "grad_norm", "all_finite"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert tstate.step == int(jstate.step) == 3
    jflat = _leaves_np(jstate.params)
    for k, t in tgpt2._flatten(tstate.params).items():
        got, want = t.detach().numpy(), jflat[k]
        if k == "blocks/qkv/bias":
            # The key bias's gradient is 0 in exact arithmetic (softmax does
            # not see a shift shared by all keys), so both sides hold fp32
            # noise there, which Adam's normalised update turns into steps
            # of up to +-lr: hold that third to 2 moving steps x 2 lr.
            d = DIMS["d_model"]
            np.testing.assert_allclose(got[:, d:2 * d], want[:, d:2 * d],
                                       atol=4e-3)
            got = np.concatenate([got[:, :d], got[:, 2 * d:]], axis=1)
            want = np.concatenate([want[:, :d], want[:, 2 * d:]], axis=1)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=k)


def test_train_step_flags_non_finite_like_jax():
    jcfg, tcfg = _configs()
    params = numpy_params(seed=5)
    params["wpe"][3, 0] = np.nan
    tokens = _tokens()
    jtx, ttx = optax.adamw(1e-3), optim.adamw(1e-3)
    jstate = j_create_state(lambda r: _to_jax(params), jtx,
                            jax.random.PRNGKey(0))
    _, jm = j_make_train_step(lambda p, b, r: jgpt2.loss_fn(p, b, jcfg), jtx,
                              donate_state=False)(
        jstate, {"tokens": jnp.asarray(tokens)}, jax.random.PRNGKey(0))
    tstate = create_train_state(lambda g: tgpt2.params_from_numpy(params),
                                ttx, torch.Generator())
    _, tm = make_train_step(lambda p, b, r: tgpt2.loss_fn(p, b, tcfg), ttx)(
        tstate, {"tokens": torch.from_numpy(tokens)}, None)
    assert float(tm["all_finite"]) == float(jm["all_finite"]) == 0.0
