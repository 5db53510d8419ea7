"""The arithmetic of the split paged decode kernel and of the tensor-core dQ
kernel, held against the JAX package on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py,
chip_smoke.py). Here their plain twins take the same numpy inputs as the
JAX functions:

  - `split_twin` is the paged kernel's split-and-combine: each context cut
    into chunks of `SPLIT_KEYS` keys, a partial (m, l, acc) per visible
    chunk, then the chunks merged in chunk order with the usual rescale.
    Held to `paged_attention_reference` (both packages) and the Pallas
    `_paged_kernel` in interpret mode at fp32 atol 1e-5 (the same
    arithmetic in another summation order).
  - `dq_tile_twin` is the wgmma dQ kernel's loop: per 64-row q tile and
    64-key k tile, dS in fp32, split into three bf16 terms (`split_bf16`),
    each term times the bf16 K tile summed in fp32. Held to
    `flash_dq_reference` and the JAX `_dq_kernel` in interpret mode at the
    backward tolerance of tests/test_ops.py (1e-3).
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.ops import paged_attention as jpa
from determined_tpu_torch.ops import flash_attention as tfa
from determined_tpu_torch.ops import paged_attention as tpa

# The module, not the `flash_attention` function determined_tpu.ops exports.
jfa = importlib.import_module("determined_tpu.ops.flash_attention")

# ------------------------------------------------------------ paged split

CHUNK = tpa.SPLIT_KEYS
SLOTS, BS, NH, DH = 6, 64, 2, 16
MB = 4 * CHUNK // BS  # a context of four chunks
POOL = SLOTS * MB + 1  # + the trash block
TRASH = POOL - 1


def paged_inputs(seed, positions):
    """Permuted pool blocks, slot 1 sharing the first half of slot 0's
    blocks, the last slot inactive (all-trash table, position 0)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(SLOTS, NH, DH)).astype(np.float32)
    kp = rng.normal(size=(POOL, BS, NH, DH)).astype(np.float32)
    vp = rng.normal(size=(POOL, BS, NH, DH)).astype(np.float32)
    tables = rng.permutation(SLOTS * MB).reshape(SLOTS, MB).astype(np.int32)
    tables[1, :MB // 2] = tables[0, :MB // 2]
    tables[-1] = TRASH
    pos = np.array(list(positions) + [0], np.int32)
    assert pos.shape == (SLOTS,)
    return q, kp, vp, tables, pos


def split_twin(q, kp, vp, tables, positions, split_keys=CHUNK):
    """The paged kernels' split-and-combine in plain torch, fp32."""
    slots, nh, dh = q.shape
    bs, mb = kp.shape[1], tables.shape[1]
    keys = mb * bs
    scale = 1.0 / math.sqrt(dh)
    tbl = tables.long().clamp(0, kp.shape[0] - 1)  # a jnp gather's clamp
    k_lane = kp[tbl].reshape(slots, keys, nh, dh).float()
    v_lane = vp[tbl].reshape(slots, keys, nh, dh).float()
    out = torch.empty(slots, nh, dh)
    for s in range(slots):
        last = min(int(positions[s]), keys - 1)
        parts = []  # (m, l, acc) of each visible chunk, in chunk order
        for c0 in range(0, last + 1, split_keys):
            idx = torch.arange(c0, min(c0 + split_keys, last + 1))
            st = torch.einsum("hd,khd->hk", q[s].float(), k_lane[s, idx])
            st = st * scale
            m = st.max(dim=-1).values
            p = torch.exp(st - m[:, None])
            parts.append((m, p.sum(dim=-1),
                          torch.einsum("hk,khd->hd", p, v_lane[s, idx])))
        mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        lt = torch.zeros(nh)
        acc = torch.zeros(nh, dh)
        for m, l, a in parts:
            w = torch.exp(m - mx)
            lt = lt + w * l
            acc = acc + w[:, None] * a
        out[s] = acc * (1.0 / lt)[:, None]
    return out.to(q.dtype)


EDGE_POSITIONS = [
    pytest.param((0, CHUNK - 1, CHUNK, CHUNK + 1, 4 * CHUNK - 1),
                 id="chunk-edges"),
    pytest.param((4 * CHUNK - 1, 4 * CHUNK - 1, 3 * CHUNK + 7, 2 * CHUNK,
                  CHUNK // 2), id="multi-chunk"),
]


@pytest.mark.parametrize("positions", EDGE_POSITIONS)
def test_split_twin_matches_both_references_and_pallas(positions):
    arrs = paged_inputs(5, positions)
    twin = split_twin(*(torch.from_numpy(a) for a in arrs))
    ref = tpa.paged_attention_reference(*(torch.from_numpy(a) for a in arrs))
    jref = jpa.paged_attention_reference(*(jnp.asarray(a) for a in arrs))
    pallas = jpa.paged_attention_pallas(*(jnp.asarray(a) for a in arrs),
                                        interpret=True)
    for want in (ref.numpy(), np.asarray(jref), np.asarray(pallas)):
        np.testing.assert_allclose(twin.numpy(), want, atol=1e-5, rtol=0)


def test_split_twin_inactive_slot_and_shared_blocks():
    """The all-trash slot at position 0 reads trash key 0 alone; two slots
    sharing their first blocks at one position inside them, with one
    query, attend to the same keys through one chunk."""
    q, kp, vp, tables, pos = paged_inputs(9, (CHUNK, CHUNK, 1, 2, 3))
    q[1] = q[0]
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, pos)]
    out = split_twin(*t)
    np.testing.assert_allclose(out[-1].numpy(), vp[TRASH, 0], atol=1e-6)
    np.testing.assert_array_equal(out[0].numpy(), out[1].numpy())


def test_split_count_and_chunk_rule():
    """ceil(max_blocks * block_size / SPLIT_KEYS) splits; the chunk is a
    multiple of every block size the kernels take, so no block straddles
    two splits."""
    assert tpa.num_splits(64, 16) == 2  # the serving run: 1024 keys
    assert tpa.num_splits(256, 16) == 8
    assert tpa.num_splits(6, 1) == 1
    assert tpa.num_splits(MB, BS) == 4
    bs = 1
    while bs <= tpa.MAX_BLOCK_SIZE:
        assert CHUNK % bs == 0
        bs *= 2


def test_split_twin_is_the_single_pass_softmax_for_one_chunk():
    """With one chunk per context the twin is the plain online softmax over
    the whole lane: the split changes only the order of the sums."""
    arrs = paged_inputs(13, (CHUNK - 1, 3, 0, 100, CHUNK - 2))
    t = [torch.from_numpy(a) for a in arrs]
    np.testing.assert_allclose(split_twin(*t).numpy(),
                               split_twin(*t, split_keys=MB * BS).numpy(),
                               atol=1e-6, rtol=0)


# ----------------------------------------------------------- wgmma dQ twin


def dq_tile_twin(q, k, v, dout, lse, delta, causal, terms=3, tile=64):
    """The wgmma dQ kernel's loop in plain torch: per 64-row q tile, over k
    tiles up to the diagonal, dS split into `terms` bf16 terms, each times
    the bf16 K tile, summed in fp32."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dq = torch.zeros(b, s, h, d)
    for bi in range(b):
        for hi in range(h):
            bh = bi * h + hi
            for q0 in range(0, s, tile):
                rows = torch.arange(q0, min(q0 + tile, s))
                acc = torch.zeros(len(rows), d)
                nk = int(rows[-1]) // tile + 1 if causal else -(-s // tile)
                for k0 in range(0, nk * tile, tile):
                    cols = torch.arange(k0, min(k0 + tile, s))
                    kt = k[bi, cols, hi].float()
                    st = q[bi, rows, hi].float() @ kt.T * scale
                    p = torch.exp(st - lse[bh, rows][:, None])
                    if causal:
                        p = torch.where(cols[None] <= rows[:, None], p, 0.0)
                    dp = dout[bi, rows, hi].float() @ v[bi, cols, hi].float().T
                    ds = p * (dp - delta[bh, rows][:, None]) * scale
                    for term in tfa.split_bf16(ds, terms):
                        acc += term.float() @ kt
                dq[bi, rows, hi] = acc
    return dq


def _bf16_inputs(seed, b, s, h, d):
    """q, k, v, dO as fp32 tensors holding bf16 values (the wgmma route's
    inputs), so both packages see the same numbers."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
            .to(torch.bfloat16).float() for _ in range(4)]


def _jax_dq(q, k, v, dout, o, lse, causal, bf16):
    """dq from the JAX backward with its Pallas kernels in interpret mode,
    on the same lse and o."""
    b, s, h, d = q.shape
    to3 = lambda x: jnp.asarray(  # noqa: E731
        x.numpy().transpose(0, 2, 1, 3).reshape(b * h, s, d))
    dq, _, _ = jfa._flash_bwd(to3(q), to3(k), to3(v), to3(o),
                              jnp.asarray(lse.numpy()[..., None]), to3(dout),
                              causal, bf16, True)
    return np.asarray(dq).reshape(b, h, s, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
def test_dq_tile_twin_matches_plain_version_and_jax_kernel(causal):
    q, k, v, dout = _bf16_inputs(3, 1, 128, 2, 64)
    o, lse = tfa.flash_fwd_reference(q, k, v, causal)
    delta = tfa.flash_delta(dout, o)
    twin = dq_tile_twin(q, k, v, dout, lse, delta, causal)
    plain = tfa.flash_dq_reference(q, k, v, dout, lse, delta, causal)
    jax_dq = _jax_dq(q, k, v, dout, o, lse, causal, False)
    np.testing.assert_allclose(twin.numpy(), plain.numpy(), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(twin.numpy(), jax_dq, atol=1e-3, rtol=1e-3)
    # The three terms are exact: only the order of the fp32 sums differs.
    np.testing.assert_allclose(twin.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_dq_tile_twin_ragged_s():
    """S 200: the last q tile and k tile are partial (the kernel zero-fills
    them and stores no row past S)."""
    q, k, v, dout = _bf16_inputs(4, 1, 200, 2, 64)
    o, lse = tfa.flash_fwd_reference(q, k, v, True)
    delta = tfa.flash_delta(dout, o)
    np.testing.assert_allclose(
        dq_tile_twin(q, k, v, dout, lse, delta, True).numpy(),
        tfa.flash_dq_reference(q, k, v, dout, lse, delta, True).numpy(),
        atol=1e-5, rtol=1e-5)


def test_one_term_is_the_bf16_option():
    """One term of the split is dS rounded to bf16 once: the `bf16=True`
    kernel's product, held to the plain version's and the JAX kernel's
    `bf16=True` dq; and it is not the fp32 product."""
    q, k, v, dout = _bf16_inputs(5, 1, 128, 2, 64)
    o, lse = tfa.flash_fwd_reference(q, k, v, True)
    delta = tfa.flash_delta(dout, o)
    one = dq_tile_twin(q, k, v, dout, lse, delta, True, terms=1)
    plain = tfa.flash_dq_reference(q, k, v, dout, lse, delta, True, True)
    jax_dq = _jax_dq(q, k, v, dout, o, lse, True, True)
    np.testing.assert_allclose(one.numpy(), plain.numpy(), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(one.numpy(), jax_dq, atol=1e-3, rtol=1e-3)
    three = dq_tile_twin(q, k, v, dout, lse, delta, True)
    assert (one - three).abs().max() > 1e-6
    # Per tile, the one term is exactly the rounding the option makes.
    ds = torch.from_numpy(np.random.default_rng(6).normal(
        size=(64, 64)).astype(np.float32))
    (term,) = tfa.split_bf16(ds, terms=1)
    assert torch.equal(term.float() @ k[0, :64, 0],
                       ds.to(torch.bfloat16).float() @ k[0, :64, 0])
