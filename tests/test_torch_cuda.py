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
