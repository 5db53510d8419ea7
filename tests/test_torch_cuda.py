"""The port's CUDA kernel on the card (marked `cuda`; skipped without one).

A CUDA kernel has no interpret mode, so these run only where a GPU is.
The file imports no JAX, so it also runs on a GPU host without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances against the plain version on the same GPU tensors: fp32
atol=rtol=1e-5 (another summation order); bf16 atol=rtol=2e-2 (the kernel
keeps the probabilities in fp32 where the plain version casts them to
bf16).
"""

import dataclasses

import numpy as np
import pytest
import torch

from determined_tpu_torch.models import gpt2
from determined_tpu_torch.ops import paged_attention as pa
from determined_tpu_torch.serve.engine import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(slots, nh, dh, bs, mb, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = slots * mb + 1
    q = torch.randn(slots, nh, dh, generator=g, device="cuda").to(dtype)
    kp = torch.randn(pool, bs, nh, dh, generator=g, device="cuda").to(dtype)
    vp = torch.randn(pool, bs, nh, dh, generator=g, device="cuda").to(dtype)
    tables = torch.randperm(pool - 1, generator=g, device="cuda")
    tables = tables.reshape(slots, mb).to(torch.int32)
    pos = torch.randint(0, mb * bs, (slots,), generator=g, device="cuda")
    pos[0] = mb * bs - 1
    if slots > 1:
        tables[-1] = pool - 1  # inactive: all trash, position 0
        pos[-1] = 0
    return q, kp, vp, tables.contiguous(), pos.to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh, bs", [(16, 1), (32, 8), (64, 16), (128, 32),
                                    (256, 128)])
def test_kernel_matches_plain_version(cuda, dtype, dh, bs):
    args = _inputs(5, 3, dh, bs, 6, dtype, seed=dh + bs)
    before = pa.paged_attention_cuda.launches
    out = pa.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda.launches == before + 1
    ref = pa.paged_attention_reference(*args)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, kp, vp, tables, pos = _inputs(2, 2, 64, 16, 4, torch.float32, 0)
    with pytest.raises(ValueError, match="not cuda"):
        pa.paged_attention_cuda(q, kp, vp, tables.cpu(), pos)
    with pytest.raises(ValueError, match="not contiguous"):
        pa.paged_attention_cuda(q.transpose(0, 1).contiguous().transpose(
            0, 1), kp, vp, tables, pos)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention_cuda(q, kp, vp, tables.long(), pos)


def test_engine_kernel_greedy_equals_reference_engine(cuda):
    cfg = gpt2.Config(vocab_size=128, n_positions=64, d_model=64, n_layer=2,
                      n_head=2, dtype=torch.float32)
    rng = np.random.default_rng(0)
    params = gpt2.map_params(
        lambda t: torch.from_numpy(
            (0.3 * rng.normal(size=tuple(t.shape))).astype(np.float32)),
        gpt2.init(torch.Generator().manual_seed(0), cfg))
    outs = {}
    for impl in ("auto", "reference"):
        eng = ServingEngine(params, cfg, slots=2, max_seq_len=32,
                            prefill_buckets=[8, 16], kv_block_size=8,
                            attention_impl=impl)
        eng.compile()
        prompt = np.array([5, 9, 17, 3, 77], np.int32)
        toks = [eng.prefill_request(0, prompt)]
        tokens = np.zeros(2, np.int32)
        positions = np.zeros(2, np.int32)
        for step in range(10):
            tokens[0], positions[0] = toks[-1], len(prompt) + step
            toks.append(int(eng.decode(tokens, positions,
                                       np.zeros(2, np.float32))[0]))
        outs[impl] = (toks, eng.attention_launches, eng.decode_steps)
    assert outs["auto"][0] == outs["reference"][0]
    assert outs["auto"][1] == cfg.n_layer * outs["auto"][2] == 20
    assert outs["reference"][1] == 0


def test_bf16_config_serves_through_the_kernel(cuda):
    cfg = dataclasses.replace(gpt2.Config.tiny(), dtype=torch.bfloat16)
    params = gpt2.init(torch.Generator().manual_seed(0), cfg)
    eng = ServingEngine(params, cfg, slots=4, max_seq_len=64,
                        kv_block_size=16)
    eng.compile()
    first = eng.prefill_request(1, np.arange(1, 20, dtype=np.int32))
    assert 0 <= first < cfg.vocab_size
    toks = eng.decode(np.full(4, first, np.int32),
                      np.array([0, 19, 0, 0], np.int32),
                      np.array([0, 0.8, 0, 0], np.float32))
    assert toks.shape == (4,) and ((0 <= toks) & (toks < cfg.vocab_size)).all()
    assert eng.attention_launches == cfg.n_layer


# ------------------------------------------------ flash attention (training)
#
# Tolerances against the plain versions on the same GPU tensors (atol,
# rtol). fp32 with `bf16` off, those of tests/test_ops.py: forward 2e-5 /
# 1e-4, backward 2e-3 / 2e-3. Otherwise 1e-3 / 1e-2 (measured on an H100:
# the outputs lie one bf16 ulp apart and at most 2e-4 beyond 1e-2 |x|),
# except the forward output with bf16 inputs and `bf16` on, 1e-2 / 1e-2:
# the kernel rounds each k tile's exp(s - m) to bf16 as the Pallas kernel
# does, the plain version the normalised probabilities (up to 6e-3 beyond
# 1e-2 |o| measured). chip_smoke.py plants faults these limits refuse.


def _flash_inputs(b, s, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device="cuda").to(dtype)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    dout = torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)
    return q, k, v, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b, s, h, d, causal", [
    (2, 256, 3, 64, True), (1, 256, 2, 64, False), (1, 128, 2, 128, True),
    (1, 128, 1, 256, True), (1, 200, 2, 64, True), (1, 72, 2, 128, False),
])
def test_flash_kernels_match_plain_versions(cuda, dtype, bf16, b, s, h, d,
                                            causal):
    from determined_tpu_torch.ops import flash_attention as fa

    q, k, v, dout = _flash_inputs(b, s, h, d, dtype, seed=s + d)
    launches = (fa.flash_fwd_cuda.launches, fa.flash_dq_cuda.launches,
                fa.flash_dkv_cuda.launches)
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, bf16)
    delta = fa.flash_delta(dout, o)
    dq = fa.flash_dq_cuda(q, k, v, dout, lse, delta, causal, bf16)
    dk, dv = fa.flash_dkv_cuda(q, k, v, dout, lse, delta, causal, bf16)
    torch.cuda.synchronize()
    assert (fa.flash_fwd_cuda.launches, fa.flash_dq_cuda.launches,
            fa.flash_dkv_cuda.launches) == tuple(n + 1 for n in launches)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, bf16)
    grads = (fa.flash_dq_reference(q, k, v, dout, lse, delta, causal, bf16),
             *fa.flash_dkv_reference(q, k, v, dout, lse, delta, causal, bf16))
    if dtype == torch.float32 and not bf16:
        fwd, bwd = dict(atol=2e-5, rtol=1e-4), dict(atol=2e-3, rtol=2e-3)
    else:
        fwd = dict(atol=1e-2 if dtype == torch.bfloat16 and bf16 else 1e-3,
                   rtol=1e-2)
        bwd = dict(atol=1e-3, rtol=1e-2)
    torch.testing.assert_close(o.float(), o_ref.float(), **fwd)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    for got, want in zip((dq, dk, dv), grads):
        torch.testing.assert_close(got.float(), want.float(), **bwd)


def test_flash_autograd_matches_reference_autograd(cuda):
    from determined_tpu_torch.ops import flash_attention as fa

    q, k, v, dout = _flash_inputs(2, 256, 2, 64, torch.float32, seed=5)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, impl="auto")
    got = torch.autograd.grad(out, leaves, dout)
    ref_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = fa.reference_attention(*ref_leaves, causal=True)
    want = torch.autograd.grad(ref, ref_leaves, dout)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, atol=2e-3, rtol=2e-3)


def test_flash_kernel_is_deterministic(cuda):
    from determined_tpu_torch.ops import flash_attention as fa

    q, k, v, dout = _flash_inputs(2, 256, 2, 64, torch.bfloat16, seed=9)
    runs = []
    for _ in range(2):
        o, lse = fa.flash_fwd_cuda(q, k, v)
        delta = fa.flash_delta(dout, o)
        runs.append((o, fa.flash_dq_cuda(q, k, v, dout, lse, delta),
                     *fa.flash_dkv_cuda(q, k, v, dout, lse, delta)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from determined_tpu_torch.ops import flash_attention as fa

    q, k, v, dout = _flash_inputs(1, 128, 2, 64, torch.float32, seed=1)
    with pytest.raises(ValueError, match="not cuda"):
        fa.flash_fwd_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd_cuda(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="does not match"):
        fa.flash_fwd_cuda(q, k.bfloat16(), v)
    o, lse = fa.flash_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="fp32"):
        fa.flash_dq_cuda(q, k, v, dout, lse.double(), lse)


def test_gpt2_grads_through_kernels_match_reference(cuda):
    """A GPT-2 forward and backward whose attention runs the three kernels
    equals the plain attention's in fp32, launch counts included: 2 forward
    launches per layer under remat "dots" (the recompute), 1 dQ and 1
    dK/dV."""
    from determined_tpu_torch.ops import flash_attention as fa

    cfg = gpt2.Config(vocab_size=256, n_positions=128, d_model=128,
                      n_layer=2, n_head=2, dtype=torch.float32)
    params = gpt2.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = torch.randint(0, 256, (2, 129), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    grads = {}
    for impl in ("auto", "reference"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        leaves = [t.detach().clone().requires_grad_()
                  for t in gpt2._flatten(params).values()]
        tree = gpt2._unflatten(dict(zip(gpt2._flatten(params), leaves)))
        counts = [fn.launches for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda,
                                         fa.flash_dkv_cuda)]
        loss = gpt2.loss_fn(tree, {"tokens": tokens}, c)
        grads[impl] = (loss, torch.autograd.grad(loss, leaves))
        launched = [fn.launches - n for fn, n in zip(
            (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda), counts)]
        assert launched == ([4, 2, 2] if impl == "auto" else [0, 0, 0])
    torch.testing.assert_close(grads["auto"][0], grads["reference"][0],
                               atol=1e-5, rtol=1e-5)
    for a, r in zip(grads["auto"][1], grads["reference"][1]):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-4)
