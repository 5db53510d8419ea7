"""The port's training flash attention against the JAX package's.

The same numpy inputs go through `determined_tpu.ops.flash_attention`
(`reference_attention`, and `pallas_flash_attention` with its Pallas
kernels in interpret mode, as tests/test_ops.py runs them on the CPU) and
through `determined_tpu_torch.ops.flash_attention`, forward and backward
(`jax.grad` against torch autograd of the same loss). A blockwise fp32 twin
of the three CUDA kernels' loops (the forward's online softmax over k
tiles, dQ over k tiles, dK/dV over q tiles from the causal start) is held
to the plain versions; the kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, those of tests/test_ops.py: fp32 forward atol 2e-5 / rtol
1e-4, backward 2e-3; with `bf16` forward 1e-2 and backward 5e-2 (bf16
probability products lose mantissa; the two frameworks round at other
places).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The module, not the `flash_attention` function determined_tpu.ops exports.
jfa = importlib.import_module("determined_tpu.ops.flash_attention")
from determined_tpu_torch.ops import _softmax_common as sc
from determined_tpu_torch.ops import flash_attention as tfa

SHAPES = [  # two of tests/test_ops.py's pallas-vs-reference shapes
    pytest.param(2, 128, 2, 64, True, id="single-block-causal"),
    pytest.param(1, 256, 2, 64, False, id="non-causal-padded"),
]


def _qkv(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _tols(bf16):
    fwd = dict(atol=1e-2, rtol=1e-2) if bf16 else dict(atol=2e-5, rtol=1e-4)
    bwd = dict(atol=5e-2, rtol=5e-2) if bf16 else dict(atol=2e-3, rtol=2e-3)
    return fwd, bwd


def _torch_fwd_bwd(arrs, causal, bf16):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = tfa.reference_attention(*leaves, causal=causal, bf16=bf16)
    grads = torch.autograd.grad((out ** 2).sum(), leaves)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_fwd_bwd(fn, arrs):
    q, k, v = (jnp.asarray(a) for a in arrs)
    out = fn(q, k, v)
    grads = jax.grad(lambda *t: jnp.sum(fn(*t) ** 2), argnums=(0, 1, 2))(
        q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("b,s,h,d,causal", SHAPES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_reference_matches_jax_reference(b, s, h, d, causal, bf16):
    arrs = _qkv(7, b, s, h, d)
    tout, tgrads = _torch_fwd_bwd(arrs, causal, bf16)
    jout, jgrads = _jax_fwd_bwd(
        lambda q, k, v: jfa.reference_attention(q, k, v, causal=causal,
                                                bf16=bf16), arrs)
    fwd, bwd = _tols(bf16)
    np.testing.assert_allclose(tout, jout, **fwd)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t, j, **bwd)


@pytest.mark.parametrize("b,s,h,d,causal", SHAPES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_reference_matches_pallas_kernels_interpret(b, s, h, d, causal,
                                                    bf16):
    from jax.experimental.pallas import tpu as pltpu

    arrs = _qkv(11, b, s, h, d)
    tout, tgrads = _torch_fwd_bwd(arrs, causal, bf16)
    with pltpu.force_tpu_interpret_mode():
        jout, jgrads = _jax_fwd_bwd(
            lambda q, k, v: jfa.pallas_flash_attention(q, k, v, causal,
                                                       bf16), arrs)
    fwd, bwd = _tols(bf16)
    np.testing.assert_allclose(tout, jout, **fwd)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t, j, **bwd)


def test_dense_is_the_reference_without_bf16():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 64, 2, 16))
    np.testing.assert_array_equal(
        tfa._xla_attention(q, k, v, causal=True).numpy(),
        tfa.reference_attention(q, k, v, causal=True).numpy())
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    np.testing.assert_allclose(
        tfa.flash_attention(q, k, v, impl="dense").numpy(),
        np.asarray(jfa.flash_attention(jq, jk, jv, impl="dense")),
        atol=2e-5, rtol=1e-4)


# ------------------------------------------------------------- dispatch


@pytest.mark.parametrize("setting, device, want", [
    (None, "cpu", "reference"), ("auto", "cpu", "reference"),
    ("auto", "cuda", "kernel"), ("flash", "cpu", "reference"),
    ("flash", "cuda", "kernel"), ("pallas", "cpu", "kernel"),
    ("kernel", "cpu", "kernel"), ("reference", "cuda", "reference"),
    ("dense", "cuda", "dense"), ("dot", "cpu", "dense"),
])
def test_resolve_attention_impl(setting, device, want):
    assert tfa.resolve_attention_impl(setting, torch.device(device)) == want


def test_resolve_attention_impl_rejects_unknown_names():
    with pytest.raises(ValueError, match="attention_impl must be one of"):
        tfa.resolve_attention_impl("ring", torch.device("cpu"))


@pytest.mark.parametrize("s, d, to_kernel", [
    (128, 64, True), (256, 128, True), (384, 256, True), (100, 64, False),
    (128, 32, False), (64, 64, False),
])
def test_dispatcher_shape_rule(s, d, to_kernel):
    """`kernel` goes to the CUDA kernels exactly for S % 128 == 0 and D in
    64/128/256 (decided from the shapes, before any launch); with CPU
    tensors that path raises, every other shape runs the reference."""
    q = torch.zeros(1, s, 1, d)
    assert tfa.kernel_supported(q) == to_kernel
    calls = tfa.reference_attention.calls
    if to_kernel:
        with pytest.raises(ValueError, match="not cuda"):
            tfa.flash_attention(q, q, q, impl="kernel")
        assert tfa.reference_attention.calls == calls
    else:
        out = tfa.flash_attention(q, q, q, impl="kernel")
        assert out.shape == q.shape
        assert tfa.reference_attention.calls == calls + 1
    # auto on CPU tensors is the reference, whatever the shape.
    tfa.flash_attention(q, q, q, impl="auto")
    assert tfa.reference_attention.calls == calls + (1 if to_kernel else 2)


# ------------------------------------------- the kernels' algorithm (twin)


def twin_fwd(q, k, v, causal, bq=64, bk=64):
    """The forward kernel's loop in plain torch, fp32: per (b, h, q tile),
    fold k tiles 0..the diagonal (causal) into (acc, m, l); -> (o, lse)."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    o = torch.empty(b, s, h, d)
    lse = torch.empty(b * h, s)
    for bi in range(b):
        for hi in range(h):
            for q0 in range(0, s, bq):
                rows = torch.arange(q0, min(q0 + bq, s))
                acc, m, l = sc.init_softmax_state(len(rows), d)
                nk = (int(rows[-1]) // bk + 1) if causal else -(-s // bk)
                for k0 in range(0, nk * bk, bk):
                    cols = torch.arange(k0, min(k0 + bk, s))
                    st = q[bi, rows, hi] @ k[bi, cols, hi].T * scale
                    if causal:
                        st = torch.where(cols[None] <= rows[:, None], st,
                                         sc.NEG_INF)
                    acc, m, l = sc.online_softmax_update(
                        st, v[bi, cols, hi], acc, m, l)
                o[bi, rows, hi] = sc.finish_softmax_state(acc, l, q.dtype)
                lse[bi * h + hi, rows] = (m + torch.log(l))[:, 0]
    return o, lse


def _twin_p_ds(q, k, v, dout, lse, delta, bi, hi, rows, cols, causal):
    h, d = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    st = q[bi, rows, hi] @ k[bi, cols, hi].T * scale
    p = torch.exp(st - lse[bi * h + hi, rows][:, None])
    if causal:
        p = torch.where(cols[None] <= rows[:, None], p, 0.0)
    dp = dout[bi, rows, hi] @ v[bi, cols, hi].T
    ds = p * (dp - delta[bi * h + hi, rows][:, None]) * scale
    return p, ds


def twin_dq(q, k, v, dout, lse, delta, causal, bq=64, bk=64):
    """The dQ kernel's loop: per q tile, accumulate dS.K over k tiles up to
    the diagonal."""
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            for q0 in range(0, s, bq):
                rows = torch.arange(q0, min(q0 + bq, s))
                acc = torch.zeros(len(rows), d)
                nk = (int(rows[-1]) // bk + 1) if causal else -(-s // bk)
                for k0 in range(0, nk * bk, bk):
                    cols = torch.arange(k0, min(k0 + bk, s))
                    _, ds = _twin_p_ds(q, k, v, dout, lse, delta, bi, hi,
                                       rows, cols, causal)
                    acc += ds @ k[bi, cols, hi]
                dq[bi, rows, hi] = acc
    return dq


def twin_dkv(q, k, v, dout, lse, delta, causal, bq=32, bk=64):
    """The dK/dV kernel's loop: per k tile, accumulate P^T.dO and dS^T.Q
    over q tiles from the first one holding a row >= the tile's first key
    (`_causal_q_index`)."""
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            for k0 in range(0, s, bk):
                cols = torch.arange(k0, min(k0 + bk, s))
                acc_k = torch.zeros(len(cols), d)
                acc_v = torch.zeros(len(cols), d)
                start = (k0 // bq) * bq if causal else 0
                for q0 in range(start, s, bq):
                    rows = torch.arange(q0, min(q0 + bq, s))
                    p, ds = _twin_p_ds(q, k, v, dout, lse, delta, bi, hi,
                                       rows, cols, causal)
                    acc_v += p.T @ dout[bi, rows, hi]
                    acc_k += ds.T @ q[bi, rows, hi]
                dk[bi, cols, hi], dv[bi, cols, hi] = acc_k, acc_v
    return dk, dv


@pytest.mark.parametrize("s, causal", [(128, True), (200, True),
                                       (96, False)])
def test_blockwise_twin_matches_plain_versions(s, causal):
    rng = np.random.default_rng(s)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(1, s, 2, 16))
                                      .astype(np.float32)) for _ in range(4))
    o, lse = twin_fwd(q, k, v, causal)
    o_ref, lse_ref = tfa.flash_fwd_reference(q, k, v, causal)
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=1e-5,
                               rtol=1e-5)
    delta = tfa.flash_delta(dout, o)
    dq = twin_dq(q, k, v, dout, lse, delta, causal)
    dk, dv = twin_dkv(q, k, v, dout, lse, delta, causal)
    dq_ref = tfa.flash_dq_reference(q, k, v, dout, lse, delta, causal)
    dk_ref, dv_ref = tfa.flash_dkv_reference(q, k, v, dout, lse, delta,
                                             causal)
    # ... and the plain versions are the reference's autograd.
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.reference_attention(*leaves, causal=causal)
    auto = torch.autograd.grad(out, leaves, dout)
    for got, plain, want in zip((dq, dk, dv), (dq_ref, dk_ref, dv_ref),
                                auto):
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(plain.numpy(), want.numpy(), atol=2e-5,
                                   rtol=1e-4)


def test_plain_backward_bf16_option_rounds_like_the_pallas_kernels():
    """With bf16=True the plain dQ/dK/dV versions round P, dS and their
    other operands as the Pallas backward does: held to the interpret-mode
    kernels' gradients of a linear loss (so dO is exact in both)."""
    from jax.experimental.pallas import tpu as pltpu

    b, s, h, d = 1, 128, 1, 64
    arrs = _qkv(5, b, s, h, d)
    w = np.random.default_rng(6).normal(size=(b, s, h, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jgrads = jax.grad(
            lambda *t: jnp.sum(jfa.pallas_flash_attention(*t, True, True)
                               * w), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in arrs))
    q, k, v = (torch.from_numpy(a) for a in arrs)
    dout = torch.from_numpy(w)
    o, lse = twin_fwd(q, k, v, True)
    delta = tfa.flash_delta(dout, o)
    got = (tfa.flash_dq_reference(q, k, v, dout, lse, delta, True, True),
           *tfa.flash_dkv_reference(q, k, v, dout, lse, delta, True, True))
    for t, j in zip(got, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-2,
                                   rtol=5e-2)
