"""Ring attention: causal self-attention with the sequence split over the
`context` mesh axis.

Counterpart of determined_tpu/ops/ring_attention.py. Each rank holds one
contiguous chunk of the sequence (chunk i on context rank i,
`parallel/mesh.seq_shard`) and its q, k and v, `[B, S/cp, H, D]`. Over
`cp` steps the K/V blocks travel the ring, each rank sending its current
block to the next rank and taking the previous rank's
(`dist.batch_isend_irecv`), and every rank attends its q chunk to the
block it holds. The block rule is the JAX one: with `causal`, a block
from an earlier chunk is attended unmasked, the rank's own block under
the causal mask, a later block not at all; without it every block
unmasked. The blocks' flash partials (m, l, o: the running max, the
normaliser and the unnormalised output, fp32) merge with `_combine`.

The work of one block is a module function, so the ring loop and a
caller without a ring (chip_smoke.py's schedule on one card) run the
same code:

  - `block_forward(q, k, v, causal) -> (m, l, o)`. On CUDA one launch of
    the flash forward kernel, whose `(o_j, lse_j)` is the partial
    `(lse_j, 1, o_j)`: exp(s - lse_j) are the block's probabilities, which
    sum to 1 and weight v to o_j. On the CPU `_block_attend`, the JAX
    function.
  - `_combine`, the JAX function, and `finish(m, l, o) -> (out, lse)`.
  - `block_backward(q, k, v, dout, lse, delta, causal) -> (dq, dk, dv)`.
    On CUDA one launch each of the dQ and dK/dV kernels, on the CPU
    their plain versions (`flash_dq_reference`, `flash_dkv_reference`).
    `lse` and `delta = rowsum(dO * O)` are those of the whole row, from
    the final output, so the kernels' P = exp(S - lse) is the block's
    share of the global softmax and each block's gradient is exact.

PyTorch's point-to-point calls carry no autograd, so the ring is one
`torch.autograd.Function`: the forward saves the rank's own q, k, v, the
output and the row's lse; the backward runs the ring again, the K/V
blocks with their dK/dV accumulators (fp32), which are back on the rank
that owns the block after `cp` steps, while dQ accumulates in place.
On CUDA a chunk whose shape the kernels are not built for (S % 128 or D
outside 64/128/256, `flash_attention.kernel_supported`) runs the plain
versions, the rule of the flash dispatcher; the launch counters say
which ran. With no mesh, or a context axis of 1, `ring_attention` is
`flash_attention(q, k, v, causal)` with `bf16` off, as the JAX function
is.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from determined_tpu_torch.ops import flash_attention as fa
from determined_tpu_torch.parallel.mesh import AxisGroup, axis_group

NEG_INF = float(torch.finfo(torch.float32).min)

Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _block_attend(q, k, v, mask, sm_scale) -> Partial:
    """One q-block x kv-block flash partial: returns (m, l, o) in fp32.

    q: [B,Sq,H,D], k/v: [B,Sk,H,D], mask: [Sq,Sk] bool or None."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    if mask is not None:
        logits = torch.where(mask[None, None], logits, NEG_INF)
    m = torch.amax(logits, dim=-1)  # [B,H,Sq]
    # guard fully-masked rows: exp(NEG_INF - NEG_INF) would be exp(0)=1
    m_safe = torch.where(m == NEG_INF, 0.0, m)
    p = torch.exp(logits - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask[None, None], p, 0.0)
    l = torch.sum(p, dim=-1)  # [B,H,Sq]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return m_safe, l, o


def _combine(m1, l1, o1, m2, l2, o2) -> Partial:
    """Merge two flash partials with the standard rescaling identity."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    # a*: [B,H,Sq] -> broadcast onto o: [B,Sq,H,D]
    o = o1 * a1.transpose(1, 2)[..., None] + o2 * a2.transpose(1, 2)[..., None]
    return m, l, o


def _on_kernels(q: torch.Tensor) -> bool:
    return q.is_cuda and fa.kernel_supported(q)


def block_forward(q, k, v, causal: bool) -> Partial:
    """The flash partial (m, l, o) of the q chunk against one K/V block,
    fp32, m and l [B, H, Sq], o [B, Sq, H, D]. `causal`: the diagonal
    block, under the causal mask."""
    if q.is_cuda:
        run = fa.flash_fwd_cuda if _on_kernels(q) else fa.flash_fwd_reference
        o, lse = run(q, k, v, causal)
        b, s, h, _ = q.shape
        m = lse.view(b, h, s)
        return m, torch.ones_like(m), o.float()
    s = q.shape[1]
    mask = (torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
            if causal else None)
    return _block_attend(q, k, v, mask, 1.0 / math.sqrt(q.shape[-1]))


def finish(m, l, o, dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merged partials -> (out [B, S, H, D] in `dtype`, lse [B*H, S]
    fp32 contiguous: the layout the backward kernels read)."""
    l = torch.where(l == 0.0, 1.0, l)  # fully-masked rows (not when causal)
    out = (o / l.transpose(1, 2)[..., None]).to(dtype)
    b, h, s = m.shape
    lse = (m + torch.log(l)).reshape(b * h, s).contiguous()
    return out, lse


def block_backward(q, k, v, dout, lse, delta, causal: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of one block, in q's dtype, from the whole row's `lse`
    and `delta` ([B*H, Sq] fp32 contiguous)."""
    if _on_kernels(q):
        dq = fa.flash_dq_cuda(q, k, v, dout, lse, delta, causal)
        dk, dv = fa.flash_dkv_cuda(q, k, v, dout, lse, delta, causal)
        return dq, dk, dv
    dq = fa.flash_dq_reference(q, k, v, dout, lse, delta, causal)
    dk, dv = fa.flash_dkv_reference(q, k, v, dout, lse, delta, causal)
    return dq, dk, dv


def block_causal(src: int, me: int, causal: bool) -> Optional[bool]:
    """How rank `me`'s q chunk sees the K/V block of chunk `src`: None
    (skipped: a later chunk under `causal`), True (causal: its own) or
    False (unmasked)."""
    if not causal:
        return False
    if src < me:
        return False
    return True if src == me else None


def _pass_on(tensors: Sequence[torch.Tensor], axis: AxisGroup):
    """Send `tensors` to the next rank of the ring and receive the same
    shapes from the previous one: (received, requests to wait on)."""
    import torch.distributed as dist

    nxt = dist.get_global_rank(axis.group, (axis.index + 1) % axis.size)
    prv = dist.get_global_rank(axis.group, (axis.index - 1) % axis.size)
    sent = [t.contiguous() for t in tensors]
    got = [torch.empty_like(t) for t in sent]
    ops = [dist.P2POp(dist.isend, t, nxt, axis.group) for t in sent]
    ops += [dist.P2POp(dist.irecv, t, prv, axis.group) for t in got]
    reqs = dist.batch_isend_irecv(ops)
    return got, (reqs, sent)


def _wait(pending) -> None:
    reqs, _ = pending  # `sent` stays referenced until the sends end
    for r in reqs:
        r.wait()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, axis: AxisGroup):
        me, n = axis.index, axis.size
        part: Optional[Partial] = None
        kv = (k, v)
        for step in range(n):
            src = (me - step) % n
            pending = None
            if step + 1 < n:
                nxt, pending = _pass_on(kv, axis)
            mode = block_causal(src, me, causal)
            if mode is not None:
                p = block_forward(q, *kv, mode)
                part = p if part is None else _combine(*part, *p)
            if pending is not None:
                _wait(pending)
                kv = tuple(nxt)
        out, lse = finish(*part, q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.axis = causal, axis
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        axis, causal = ctx.axis, ctx.causal
        me, n = axis.index, axis.size
        dout = dout.contiguous()
        delta = fa.flash_delta(dout, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = (k, v)
        dkv = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for t in kv]
        for step in range(n):
            src = (me - step) % n
            pending = None
            if step + 1 < n:
                nxt, pending = _pass_on(kv, axis)
            mode = block_causal(src, me, causal)
            if mode is not None:
                dq_j, dk_j, dv_j = block_backward(q, *kv, dout, lse, delta,
                                                  mode)
                dq += dq_j
                dkv[0] += dk_j
                dkv[1] += dv_j
            # The block's dK/dV go on with it; after n steps they are home.
            dkv, back = _pass_on(dkv, axis)
            _wait(back)
            if pending is not None:
                _wait(pending)
                kv = tuple(nxt)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, mesh=None) -> torch.Tensor:
    """Causal ring attention over the `context` ring of the DeviceMesh
    `mesh`: q, k, v are this rank's [B, S/cp, H, D] chunk (H the heads
    this rank holds). Falls back to single-block fused attention when
    there is no mesh or the axis has size 1."""
    axis = axis_group(mesh, "context")
    if axis is None:
        return fa.flash_attention(q, k, v, causal=causal)
    return _RingAttention.apply(q, k, v, causal, axis)
