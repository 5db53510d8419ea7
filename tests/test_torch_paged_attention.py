"""The port's paged decode attention against the JAX package's.

The same numpy inputs go through `determined_tpu.ops.paged_attention`
(`paged_attention_reference`, and the Pallas kernel `_paged_kernel` in
interpret mode, as the JAX package's own tests run it on the CPU) and
through `determined_tpu_torch.ops.paged_attention_reference`. A blockwise
online-softmax twin of the CUDA kernel, built from ops/_softmax_common,
is held to both. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: f32 atol 1e-5 (the same arithmetic in another summation
order); bf16 atol 2e-2 (bf16 rounds the logits and probabilities at other
places in the two frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.ops import paged_attention as jpa
from determined_tpu_torch.ops import _softmax_common as sc
from determined_tpu_torch.ops import paged_attention as tpa

SLOTS, MB, BS, NH, DH = 4, 4, 8, 2, 16
POOL = SLOTS * MB + 1  # + the trash block
TRASH = POOL - 1


def make_inputs(seed=7):
    """Permuted pool blocks, slot 1 sharing slot 0's first two blocks,
    slot 3 inactive (all-trash table, position 0); positions cover a
    partial block, the last index of the lane and 0."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(SLOTS, NH, DH)).astype(np.float32)
    kp = rng.normal(size=(POOL, BS, NH, DH)).astype(np.float32)
    vp = rng.normal(size=(POOL, BS, NH, DH)).astype(np.float32)
    tables = rng.permutation(SLOTS * MB).reshape(SLOTS, MB).astype(np.int32)
    tables[1, :2] = tables[0, :2]
    tables[3] = TRASH
    positions = np.array([5, MB * BS - 1, 17, 0], np.int32)
    return q, kp, vp, tables, positions


def blocked_twin(q, kp, vp, tables, positions):
    """The CUDA kernel's algorithm in plain torch: per (slot, head), walk
    logical blocks 0..pos // bs and fold each into fp32 (acc, m, l)."""
    slots, nh, dh = q.shape
    bs = kp.shape[1]
    out = torch.empty_like(q)
    scale = 1.0 / dh ** 0.5
    for s in range(slots):
        pos = int(positions[s])
        for h in range(nh):
            acc, m, l = sc.init_softmax_state(1, dh)
            for b in range(pos // bs + 1):
                blk = int(tables[s, b])
                k = kp[blk, :, h].float()             # [bs, Dh]
                st = (q[s, h].float() @ k.T)[None] * scale
                idx = b * bs + torch.arange(bs)
                st = torch.where(idx[None] <= pos, st, sc.NEG_INF)
                acc, m, l = sc.online_softmax_update(
                    st, vp[blk, :, h], acc, m, l)
            out[s, h] = sc.finish_softmax_state(acc, l, q.dtype)[0]
    return out


@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5),
                                         ("bfloat16", 2e-2)])
def test_reference_matches_jax_reference(dtype, atol):
    arrs = make_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout = jpa.paged_attention_reference(
        *(jnp.asarray(a, jdt) for a in arrs[:3]), jnp.asarray(arrs[3]),
        jnp.asarray(arrs[4]))
    tout = tpa.paged_attention_reference(
        *(torch.from_numpy(a).to(tdt) for a in arrs[:3]),
        torch.from_numpy(arrs[3]), torch.from_numpy(arrs[4]))
    assert tout.dtype == tdt and tout.shape == (SLOTS, NH, DH)
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5),
                                         ("bfloat16", 2e-2)])
def test_reference_matches_pallas_kernel_interpret(dtype, atol):
    arrs = make_inputs(seed=11)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout = jpa.paged_attention_pallas(
        *(jnp.asarray(a, jdt) for a in arrs[:3]), jnp.asarray(arrs[3]),
        jnp.asarray(arrs[4]), interpret=True)
    tout = tpa.paged_attention_reference(
        *(torch.from_numpy(a).to(tdt) for a in arrs[:3]),
        torch.from_numpy(arrs[3]), torch.from_numpy(arrs[4]))
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=atol, rtol=0)


def test_blocked_twin_matches_both_references():
    q, kp, vp, tables, positions = make_inputs(seed=3)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, positions)]
    twin = blocked_twin(*t)
    ref = tpa.paged_attention_reference(*t)
    pallas = jpa.paged_attention_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, positions)),
        interpret=True)
    np.testing.assert_allclose(twin.numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(twin.numpy(), np.asarray(pallas), atol=1e-5)


def test_inactive_slot_reads_only_trash_key_zero():
    q, kp, vp, tables, positions = make_inputs()
    out = tpa.paged_attention_reference(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, positions)))
    # Position 0 over an all-trash table: one visible key, weight 1.
    np.testing.assert_allclose(out[3].numpy(), vp[TRASH, 0], atol=1e-6)


def test_shared_blocks_give_equal_prefix_attention():
    """Two slots whose tables share their first blocks, at the same
    position inside those blocks, attend to exactly the same keys."""
    q, kp, vp, tables, positions = make_inputs()
    q[1] = q[0]
    positions[:2] = 9  # inside the two shared blocks
    out = tpa.paged_attention_reference(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, positions)))
    np.testing.assert_array_equal(out[0].numpy(), out[1].numpy())


def test_dispatcher_rejects_unknown_impl():
    t = [torch.from_numpy(a) for a in make_inputs()]
    with pytest.raises(ValueError, match="unknown paged attention impl"):
        tpa.paged_decode_attention(*t, impl="dense")
