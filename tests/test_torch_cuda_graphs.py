"""The serving engine's CUDA graphs on the card (marked `cuda`; skipped
without one).

`ServingEngine.compile()` captures decode, every prefill bucket and the
block copy once; every later call replays them with its inputs copied into
the same buffers. These tests hold the replays to the same module
functions run eagerly on a copy of the engine's cache, at a small size in
fp32, for the paged layout (kernel and plain attention) and the dense one,
with and without adapters: the same kernels on the same inputs, so the
logits should agree to the bit (held to atol 1e-5, rtol 0) and the greedy
tokens exactly. The file imports no JAX, so it also runs on a GPU host
without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graphs.py
"""

import numpy as np
import pytest
import torch

from determined_tpu_torch.models import gpt2
from determined_tpu_torch.ops import paged_attention as pa
from determined_tpu_torch.serve import engine as engine_mod
from determined_tpu_torch.serve import model as smodel
from determined_tpu_torch.serve.engine import ServingEngine

pytestmark = pytest.mark.cuda

CFG = gpt2.Config(vocab_size=128, n_positions=64, d_model=64, n_layer=2,
                  n_head=4, dtype=torch.float32)
BUCKETS = [8, 16]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(seed=0):
    """GPT-2 params with a wide spread (greedy decoding not degenerate)."""
    rng = np.random.default_rng(seed)
    shapes = gpt2.init(torch.Generator().manual_seed(0), CFG)
    return gpt2.map_params(
        lambda t: torch.from_numpy((0.3 * rng.normal(size=tuple(t.shape)))
                                   .astype(np.float32)), shapes)


def _engine(impl, adapters):
    params = _params()
    extra = None
    if adapters:
        extra = {"ft": {"wte": params["wte"] + 0.5 * torch.from_numpy(
            np.random.default_rng(7).normal(size=(128, 64))).float()}}
    return ServingEngine(params, CFG, slots=3, max_seq_len=32,
                         prefill_buckets=BUCKETS, kv_block_size=8,
                         attention_impl=impl, adapters=extra, device="cuda")


def test_compile_captures_every_call(cuda):
    eng = _engine("kernel", False)
    stats = eng.compile()
    graphs = eng.stats()["cuda_graphs"]
    assert graphs == {"prefill_16": 0, "prefill_8": 0, "decode": CFG.n_layer,
                      "copy_block": 0}
    assert {"kernel_build_s", "decode_s", "prefill_8_s", "prefill_16_s",
            "copy_block_s", "total_s"} <= set(stats)
    before = pa.paged_attention_cuda.launches
    zeros = np.zeros((3,), np.int32)
    for _ in range(3):
        eng.decode(zeros, zeros, np.zeros((3,), np.float32))
    # Replays launch the kernel without the wrapper: the engine counts them.
    assert pa.paged_attention_cuda.launches == before
    assert eng.attention_launches == 3 * CFG.n_layer


@pytest.mark.parametrize("adapters", [False, True])
@pytest.mark.parametrize("impl", ["kernel", "reference", "dense"])
def test_replays_equal_eager_calls(cuda, impl, adapters):
    """Prompt A into slot 0; prompt B into slot 1 (paged: a prefix-cache
    hit on A's first block; with adapters: routed to the fine-tune); then
    4 decode steps. The engine replays its graphs; the module functions run
    eagerly on a copy of its cache with the same inputs."""
    eng = _engine(impl, adapters)
    eng.compile()
    cache = {k: v.clone() for k, v in eng._cache.items()}
    stack = eng._adapter_stack
    rng = np.random.default_rng(1)
    a = rng.integers(0, 128, 12).astype(np.int32)
    b = np.concatenate([a[:8], rng.integers(0, 128, 5)]).astype(np.int32)
    mb, trash = eng.max_blocks_per_seq, eng.trash_block
    tables = np.full((3, mb), trash, np.int32)
    tables[0] = [0, 1, 2, 3]
    tables[1] = [0, 4, 5, 6]
    slot_adapters = np.array([0, 1 if adapters else 0, 0], np.int32)
    dev = torch.device("cuda")
    worst, last = 0.0, np.zeros((3,), np.int32)
    with torch.inference_mode():
        for slot, prompt, cached in ((0, a, 0), (1, b, 8 if eng.paged else 0)):
            got = eng.prefill_logits(slot, prompt, block_table=tables[slot],
                                     cached_len=cached,
                                     adapter=int(slot_adapters[slot]))
            suffix = prompt[cached:]
            bucket = eng.bucket_for(len(suffix))
            padded = torch.zeros(bucket, dtype=torch.int32, device=dev)
            padded[:len(suffix)] = torch.from_numpy(suffix)
            idx = {}
            if adapters:
                idx = {"adapters": stack, "slot_adapter": torch.tensor(
                    int(slot_adapters[slot]), device=dev)}
            if eng.paged:
                want = smodel.paged_prefill(
                    eng.params, cache, padded, len(suffix), cached,
                    torch.from_numpy(tables[slot]).to(dev), CFG, **idx)[1]
            else:
                want = smodel.prefill(eng.params, cache, padded, len(suffix),
                                      slot, CFG, **idx)[1]
            worst = max(worst, float((got - want).abs().max()))
            assert int(got.argmax()) == int(want.argmax())
            last[slot] = int(got.argmax())
        positions = np.array([12, 13, 0], np.int32)
        for _ in range(4):
            got = eng.decode_logits(last, positions)
            idx = {}
            if adapters:
                idx = {"adapters": stack, "slot_adapters": torch.from_numpy(
                    slot_adapters).to(dev)}
            t, p = (torch.from_numpy(x).to(dev) for x in (last, positions))
            if eng.paged:
                want = smodel.paged_decode_step(
                    eng.params, cache, t, p, torch.from_numpy(eng._tables)
                    .to(dev), CFG, attention_impl=eng.attention_impl,
                    **idx)[1]
            else:
                want = smodel.decode_step(eng.params, cache, t, p, CFG,
                                          **idx)[1]
            worst = max(worst, float((got - want).abs().max()))
            assert torch.equal(got.argmax(-1), want.argmax(-1))
            last = got.argmax(-1).int().cpu().numpy()
            positions = positions + np.array([1, 1, 0], np.int32)
    assert worst <= 1e-5, f"graph vs eager max |logit diff| {worst:.3e}"
    for key in ("k", "v"):
        assert (eng._cache[key] - cache[key]).abs().max() <= 1e-5


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A step that reads a device value on the host cannot be captured:
    compile() raises instead of serving eagerly."""
    real = smodel.paged_decode_step

    def reads_the_device(*args, **kwargs):
        out = real(*args, **kwargs)
        out[1].sum().item()  # a host sync: refused inside a capture
        return out

    monkeypatch.setattr(engine_mod.smodel, "paged_decode_step",
                        reads_the_device)
    eng = _engine("kernel", False)
    with pytest.raises(RuntimeError):
        eng.compile()
