"""The port's Mixture-of-Experts block, MoE GPT-2 and MoE serving steps
against the JAX package's, on the CPU.

The same numpy-drawn params and inputs go through
`determined_tpu.ops.moe.moe_block`, `determined_tpu.models.gpt2` and
`determined_tpu.serve.model`, and through their counterparts in the port,
in fp32. The port routes by index (a scatter into the experts' slots and
a gather back) where the JAX package contracts `[T, E, C]` one-hots; the
two are the same function while no router probabilities tie, so every
test first asserts that its inputs route with a margin: between each of
a token's first k + 1 sorted probabilities a gap of at least 1e-4 (the
port's own router probabilities, recorded as it runs). A routing
mismatch is then a fault, not a near-tie.

Tolerances: the block's output and aux loss rtol 1e-5 / atol 1e-6, its
gradients rtol 1e-5 / atol 1e-5 of each leaf's largest element (an
expert's weight gradient sums a slot's products of size ~1, whose fp32
rounding in another order reaches 2e-6 on elements of ~1e-2). GPT-2's
loss and aux atol 2e-5, logits and gradients atol 2e-5 / rtol 1e-4
(tests/test_torch_train_model.py's gradient bound: the same arithmetic
in another summation order, on logits up to ~3 at these weights).
Serving logits atol = rtol = 1e-4 and K/V pools atol 1e-5
(tests/test_torch_serve_model.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.ops import moe as jmoe
from determined_tpu.serve import model as jsm
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.ops import moe as tmoe
from determined_tpu_torch.serve import model as tsm

MARGIN = 1e-4


@pytest.fixture
def routes(monkeypatch):
    """Every `route` the port makes while the test runs: (probs, k)."""
    seen = []
    route = tmoe.route

    def recording(xt, router, num_experts, top_k, *args, **kwargs):
        r = route(xt, router, num_experts, top_k, *args, **kwargs)
        seen.append((r.probs.detach().clone(), r.gate_idx.shape[1]))
        return r

    monkeypatch.setattr(tmoe, "route", recording)
    return seen


def assert_margin(seen):
    assert seen, "nothing was routed"
    for probs, k in seen:
        top = torch.sort(probs, dim=-1, descending=True).values
        n = min(k, probs.shape[1] - 1)
        gaps = top[:, :n] - top[:, 1:n + 1]
        assert gaps.min() >= MARGIN, f"routing margin {gaps.min():.2e}"


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_torch(tree, grad=False):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=grad), tree)


def assert_tree_close(got, want, rtol, atol, what):
    """Leaf by leaf, atol relative to the leaf's largest element."""
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_g.keys() == flat_w.keys(), what
    for path, w in flat_w.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(flat_g[path]), w, rtol=rtol,
            atol=atol * max(1.0, float(np.abs(w).max())),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ------------------------------------------------------------------ block


def block_params(rng, e, d, f):
    return {
        "router": {"kernel": rng.normal(size=(d, e)).astype(np.float32)},
        "up": {"kernel": (0.3 * rng.normal(size=(e, d, f))).astype(np.float32),
               "bias": (0.1 * rng.normal(size=(e, f))).astype(np.float32)},
        "down": {"kernel": (0.3 * rng.normal(size=(e, f, d))
                            ).astype(np.float32),
                 "bias": (0.1 * rng.normal(size=(e, d))).astype(np.float32)},
    }


@pytest.mark.parametrize("e,k,cf", [
    (2, 1, 1.25), (2, 2, 1.25), (4, 1, 1.25), (4, 2, 1.25), (4, 2, 0.5),
], ids=["e2-k1", "e2-k2", "e4-k1", "e4-k2", "e4-k2-drops"])
def test_moe_block_matches_jax(routes, e, k, cf):
    d, f, b, s = 8, 16, 2, 16
    rng = np.random.default_rng(e * 10 + k)
    params = block_params(rng, e, d, f)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = rng.normal(size=(b, s, d)).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_block(xx, p, e, top_k=k, capacity_factor=cf)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(to_jax(params), jnp.asarray(x))

    tp = to_torch(params, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    ty, taux = tmoe.moe_block(tx, tp, e, top_k=k, capacity_factor=cf)
    (torch.sum(ty * torch.from_numpy(w)) + taux).backward()
    assert_margin(routes)
    kept = tmoe.route(tx.detach().reshape(-1, d), tp["router"]["kernel"],
                      e, k, cf).kept
    if cf < 1:  # half the slots the choices need: some are dropped
        assert not kept.all()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5, atol=1e-6)
    assert_tree_close({"x": tx.grad.numpy(), **jax.tree_util.tree_map(
        lambda t: t.grad.numpy(), tp)}, {"x": jgx, **jgp}, 1e-5, 1e-5,
        "grad")


# ---------------------------------------------------------------- GPT-2

DIMS = dict(vocab_size=96, n_positions=32, d_model=32, n_layer=2, n_head=2,
            num_experts=4, moe_top_k=2)


def gpt2_configs(**kw):
    return (jgpt2.Config(**DIMS, dtype=jnp.float32, **kw),
            tgpt2.Config(**DIMS, dtype=torch.float32, **kw))


def numpy_params(jcfg, seed, std=0.3):
    """The JAX init's tree drawn with numpy: normal weights, LayerNorm
    scales near 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jgpt2.init(jax.random.PRNGKey(0), jcfg))

    def draw(path, sd):
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return (base + std * rng.normal(size=sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


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


# ------------------------------------------------------------- serving

SCFG_J = jgpt2.Config(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
                      n_head=2, dtype=jnp.float32, remat=False,
                      attention_impl="dot", num_experts=4, moe_top_k=2)
SCFG_T = tgpt2.Config(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
                      n_head=2, dtype=torch.float32, remat=False,
                      attention_impl="dot", num_experts=4, moe_top_k=2)
BS, POOL = 8, 8 + 1


@pytest.fixture(scope="module")
def serve_run():
    """Two prompts through the paged prefill (the second after a prefix
    hit) and the dense prefill into lanes 0 and 1, then one decode step
    of both in each layout (paged: two more slots idle, all-trash tables
    at position 0, which route and compete for capacity too), through
    both packages; the port's router probabilities recorded alongside."""
    params = numpy_params(SCFG_J, seed=3)
    jp, tp = to_jax(params), tgpt2.params_from_numpy(params, "cpu")
    rng = np.random.default_rng(4)
    prompt_a = rng.integers(0, 128, 12).astype(np.int32)
    prompt_b = np.concatenate([prompt_a[:8],
                               rng.integers(0, 128, 6)]).astype(np.int32)
    tables = np.array([[0, 1, 2, 3], [0, 4, 5, 6]], np.int32)
    seen = []
    route = tmoe.route

    def recording(*args, **kwargs):
        r = route(*args, **kwargs)
        seen.append((r.probs.clone(), r.gate_idx.shape[1]))
        return r

    tmoe.route = recording
    # The JAX steps jitted, as its engine runs them.
    j_paged_prefill, j_prefill, j_paged_decode, j_decode = (
        jax.jit(f, static_argnames=("cfg", "attention_impl")[:n])
        for f, n in ((jsm.paged_prefill, 1), (jsm.prefill, 1),
                     (jsm.paged_decode_step, 2), (jsm.decode_step, 1)))
    try:
        out = {}
        jc = jsm.init_paged_cache(SCFG_J, POOL, BS)
        tc = tsm.init_paged_cache(SCFG_T, POOL, BS)
        jd = jsm.init_cache(SCFG_J, 2, 32)
        td = tsm.init_cache(SCFG_T, 2, 32)
        last = []
        for i, (prompt, prefix, bucket) in enumerate(
                ((prompt_a, 0, 16), (prompt_b, 8, 8))):
            padded = np.zeros((bucket,), np.int32)
            padded[:len(prompt) - prefix] = prompt[prefix:]
            jc, jl = j_paged_prefill(
                jp, jc, jnp.asarray(padded), jnp.int32(len(prompt) - prefix),
                jnp.int32(prefix), jnp.asarray(tables[i]), cfg=SCFG_J)
            _, tl = tsm.paged_prefill(
                tp, tc, torch.from_numpy(padded), len(prompt) - prefix,
                prefix, torch.from_numpy(tables[i]), SCFG_T)
            out[f"paged_prefill_{i}"] = (np.asarray(jl), tl.numpy())
            full = np.zeros((16,), np.int32)
            full[:len(prompt)] = prompt
            jd, jdl = j_prefill(jp, jd, jnp.asarray(full),
                                jnp.int32(len(prompt)), jnp.int32(i),
                                cfg=SCFG_J)
            _, tdl = tsm.prefill(tp, td, torch.from_numpy(full), len(prompt),
                                 i, SCFG_T)
            out[f"dense_prefill_{i}"] = (np.asarray(jdl), tdl.numpy())
            last.append(int(np.asarray(jl).argmax()))
        tokens = np.array(last + [0, 0], np.int32)
        positions = np.array([12, 14, 0, 0], np.int32)
        idle = np.full((2, 4), POOL - 1, np.int32)
        all_tables = np.concatenate([tables, idle])
        jc, jl = j_paged_decode(
            jp, jc, jnp.asarray(tokens), jnp.asarray(positions),
            jnp.asarray(all_tables), cfg=SCFG_J, attention_impl="reference")
        _, tl = tsm.paged_decode_step(
            tp, tc, torch.from_numpy(tokens), torch.from_numpy(positions),
            torch.from_numpy(all_tables), SCFG_T)
        out["paged_decode"] = (np.asarray(jl), tl.numpy())
        out["pools"] = (jax.tree_util.tree_map(np.asarray, jc), tc)
        jd, jdl = j_decode(jp, jd, jnp.asarray(tokens[:2]),
                           jnp.asarray(positions[:2]), cfg=SCFG_J)
        _, tdl = tsm.decode_step(tp, td, torch.from_numpy(tokens[:2]),
                                 torch.from_numpy(positions[:2]), SCFG_T)
        out["dense_decode"] = (np.asarray(jdl), tdl.numpy())
    finally:
        tmoe.route = route
    out["routes"] = seen
    return out


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


@pytest.mark.parametrize("step", ["moe_block", "paged_prefill",
                                  "paged_decode_step", "prefill",
                                  "decode_step"])
def test_moe_steps_never_read_the_device_on_the_host(step):
    """On the meta device any host read of a device value raises, as it
    would break a CUDA graph's capture (tests/test_torch_serve_static.py)."""
    def meta(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    params = tgpt2.map_params(lambda a: torch.from_numpy(np.array(a)).to(
        "meta"), numpy_params(SCFG_J, seed=3))
    scalar, slots = meta(()), 3
    if step == "moe_block":
        lp = tgpt2.map_params(lambda t: t[0], params["blocks"]["moe"])
        y, aux = tmoe.moe_block(meta((2, 16, 32), torch.float32), lp, 4)
        assert y.shape == (2, 16, 32) and aux.shape == ()
    elif step == "paged_prefill":
        cache = tsm.init_paged_cache(SCFG_T, POOL, BS, device="meta")
        out = tsm.paged_prefill(params, cache, meta((16,)), scalar, scalar,
                                meta((4,)), SCFG_T)[1]
        assert out.shape == (128,)
    elif step == "paged_decode_step":
        cache = tsm.init_paged_cache(SCFG_T, POOL, BS, device="meta")
        out = tsm.paged_decode_step(params, cache, meta((slots,)),
                                    meta((slots,)), meta((slots, 4)), SCFG_T,
                                    attention_impl="reference")[1]
        assert out.shape == (slots, 128)
    elif step == "prefill":
        cache = tsm.init_cache(SCFG_T, slots, 32, device="meta")
        out = tsm.prefill(params, cache, meta((16,)), scalar, scalar,
                          SCFG_T)[1]
        assert out.shape == (128,)
    else:
        cache = tsm.init_cache(SCFG_T, slots, 32, device="meta")
        out = tsm.decode_step(params, cache, meta((slots,)), meta((slots,)),
                              SCFG_T)[1]
        assert out.shape == (slots, 128)


# --------------------------------------------------------- the trainer


def test_expert_axis_needs_a_trial_that_routes_over_it(monkeypatch):
    import torch.distributed as dist

    from determined_tpu_torch.train import TorchTrial, Trainer
    from determined_tpu_torch.train.trial import TrialContext

    class Dense(TorchTrial):
        cfg = tgpt2.Config.tiny()

        def init_params(self, rng):
            return tgpt2.init(rng, self.cfg)

        def loss(self, params, batch, rng):
            return tgpt2.loss_fn(params, batch, self.cfg)

        def build_training_data(self):
            return []

    class MoE(Dense):
        cfg = dataclasses.replace(tgpt2.Config.tiny(), num_experts=4)

        def supports_expert_parallel(self):
            return self.cfg.num_experts > 1

    # A world of 4 with a process group.
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    mesh = {"fsdp": 2, "expert": 2, "data": 1}
    with pytest.raises(ValueError, match="does not declare expert-parallel"):
        Trainer(Dense(TrialContext(hparams={"mesh": mesh})), device="cpu")
    cfg = Trainer(MoE(TrialContext(hparams={"mesh": mesh})),
                  device="cpu").mesh_config
    assert (cfg.data, cfg.fsdp, cfg.expert) == (1, 2, 2)
    # MoE over tensor and context resolves (tests/test_torch_moe_axes.py
    # trains over them). What the port still refuses is what JAX refuses:
    # pipeline for a trial without loss_pipelined, and MoE blocks under
    # pipeline in the model.
    for axis in ("tensor", "context"):
        cfg = Trainer(MoE(TrialContext(hparams={"mesh": {
            axis: 2, "expert": 2, "data": 1}})), device="cpu").mesh_config
        assert (getattr(cfg, axis), cfg.expert) == (2, 2)
    with pytest.raises(ValueError, match="does not implement loss_pipelined"):
        Trainer(MoE(TrialContext(hparams={"mesh": {
            "pipeline": 2, "expert": 2, "data": 1}})), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="MoE blocks are not supported under pipeline"):
        tgpt2.loss_fn_pipelined({}, {"tokens": torch.zeros((2, 9))},
                                MoE.cfg, None)
