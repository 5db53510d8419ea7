"""The port's GPT-2 training forward, optimizer and train step against the
JAX package's, on the CPU.

One tiny fp32 GPT-2 param tree is drawn with numpy and carried to both
sides (`params_from_numpy` / `jnp.asarray`); attention is the reference
path on both (`attention_impl: flash` resolves to it off the card).
Logits, loss and every gradient are held to `gpt2.apply`, `gpt2.loss_fn`
and `jax.grad`, with rematerialisation off, full and "dots". The optimizer
chain is held to optax over several steps, and `make_train_step`'s
metrics to determined_tpu.train.step's.

Tolerances: fp32 throughout; logits and loss atol 2e-5, gradients atol
2e-5 / rtol 1e-4 (the same arithmetic in another summation order), params
after optimizer steps atol 1e-6 (Adam's normalised update is at most lr =
1e-3 a step; the moments agree to fp32 rounding).
"""

import dataclasses

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

DIMS = dict(vocab_size=96, n_positions=32, d_model=32, n_layer=2, n_head=2)


def _configs(remat=False, policy="dots"):
    jcfg = jgpt2.Config(**DIMS, dtype=jnp.float32, remat=remat,
                        remat_policy=policy)
    tcfg = tgpt2.Config(**DIMS, dtype=torch.float32, remat=remat,
                        remat_policy=policy)
    return jcfg, tcfg


def numpy_params(seed=0, std=0.2):
    """A param tree with the port's (= the JAX package's) layout, drawn
    with numpy: normal weights, LayerNorm scales near 1."""
    rng = np.random.default_rng(seed)
    shapes = tgpt2.map_params(lambda t: tuple(t.shape), tgpt2.init(
        torch.Generator().manual_seed(0), _configs()[1]))

    def draw(path, shape):
        base = 1.0 if path.endswith("scale") else 0.0
        return (base + std * rng.normal(size=shape)).astype(np.float32)

    flat = tgpt2._flatten(shapes)
    return tgpt2._unflatten({k: draw(k, s) for k, s in flat.items()})


def _tokens(seed=1, b=3, s=17):
    return np.random.default_rng(seed).integers(
        0, DIMS["vocab_size"], size=(b, s)).astype(np.int32)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves_np(tree):
    return {k: np.asarray(v) for k, v in tgpt2._flatten(tree).items()}


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

    jlogits = jgpt2.apply(jparams, jnp.asarray(tokens[:, :-1]), jcfg)
    tlogits = tgpt2.apply(tparams, torch.from_numpy(tokens[:, :-1]), tcfg)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=0)

    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt2.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg))(
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


def test_bf16_forward_keeps_fp32_param_grads():
    """Weights are cast to cfg.dtype before each product: the fp32 params
    still get fp32 gradients, and the loss is fp32."""
    _, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16, remat=True)
    tparams = tgpt2.params_from_numpy(numpy_params())
    leaves = list(tgpt2._flatten(tparams).values())
    for t in leaves:
        t.requires_grad_(True)
    loss = tgpt2.loss_fn(tparams, {"tokens": torch.from_numpy(_tokens())},
                         tcfg)
    assert loss.dtype == torch.float32
    logits = tgpt2.apply(tparams, torch.from_numpy(_tokens()[:, :-1]), tcfg)
    assert logits.dtype == torch.bfloat16
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


def test_flops_per_token_and_param_count_match_jax():
    for name in ("small", "medium", "tiny"):
        jcfg, tcfg = getattr(jgpt2.Config, name)(), getattr(
            tgpt2.Config, name)()
        assert tgpt2.param_count(tcfg) == jgpt2.param_count(jcfg)
        assert tgpt2.flops_per_token(tcfg, 1024) == \
            jgpt2.flops_per_token(jcfg, 1024)
    assert tgpt2.param_count(tgpt2.Config.small()) == 124_439_808


def test_moe_and_unported_remat_policies_raise():
    # Every policy name of the JAX package is ported; a name neither
    # package defines still raises, for a dense and an MoE config. MoE is
    # ported (tests/test_torch_moe.py holds it to JAX): its params carry
    # `moe` in place of the dense FFN, and a dense param tree does not
    # serve an MoE config.
    _, tcfg = _configs(remat=True, policy="offload")
    tparams = tgpt2.params_from_numpy(numpy_params())
    tokens = torch.from_numpy(_tokens())
    with pytest.raises(ValueError, match="remat_policy"):
        tgpt2.apply(tparams, tokens, tcfg)
    mcfg = dataclasses.replace(tcfg, num_experts=4)
    mparams = tgpt2.init(torch.Generator().manual_seed(0), mcfg)
    with pytest.raises(ValueError, match="remat_policy"):
        tgpt2.apply(mparams, tokens, mcfg)
    with pytest.raises(KeyError, match="moe"):
        tgpt2.apply(tparams, tokens, dataclasses.replace(mcfg, remat=False))
    logits = tgpt2.apply(mparams, tokens, dataclasses.replace(
        mcfg, remat_policy="dots"))
    assert logits.shape == (*tokens.shape, DIMS["vocab_size"])
    assert torch.isfinite(logits).all()


# ------------------------------------------------------------- optimizer


def _optax_chain(lr, warmup, decay, wd=0.1):
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay)
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(sched, b2=0.95, weight_decay=wd))


def _port_chain(lr, warmup, decay, wd=0.1):
    sched = optim.warmup_cosine_decay_schedule(0.0, lr, warmup, decay)
    return optim.chain(optim.clip_by_global_norm(1.0),
                       optim.adamw(sched, b2=0.95, weight_decay=wd))


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


def test_schedules_match_optax():
    for args in ((0.0, 3e-4, 100, 10000), (1e-5, 1e-3, 7, 60, 1e-4)):
        j = optax.warmup_cosine_decay_schedule(*args)
        t = optim.warmup_cosine_decay_schedule(*args)
        for count in (0, 1, 6, 7, 50, 99, 100, 101, 5000, 20000):
            # optax evaluates in fp32, the port in Python floats.
            np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-5,
                                       atol=1e-12)
    assert optim.warmup_cosine_decay_schedule(0.0, 1.0, 10, 100)(0) == 0.0


def test_clip_is_not_torchs_clip_grad_norm():
    """optax clips only when norm >= max_norm and divides by the norm
    exactly; torch.nn.utils.clip_grad_norm_ scales by max/(norm + 1e-6)."""
    g = torch.full((4,), 0.5)  # global norm exactly 1.0
    out, _ = optim.clip_by_global_norm(1.0).update([g.clone()], (), None)
    np.testing.assert_array_equal(out[0].numpy(), g.numpy())
    j, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g.numpy())],
                                                 None)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(j[0]))


# ------------------------------------------------------------ train step


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
