"""Flash attention for training: the CUDA kernels, their plain versions and
the `attention_impl` dispatcher.

Counterpart of determined_tpu/ops/flash_attention.py. The public layout is
the model's `[B, S, H, D]`. Implementations, selected by
`gpt2.Config.attention_impl`:

  - `kernel`: the hand-written CUDA kernels in ops/csrc/flash_attention.cu,
    the port of the JAX package's Pallas kernels (`pallas` there, and
    `pallas` is accepted here as another spelling of `kernel`). bf16 inputs
    at D 64 run all three kernels on the tensor cores (wgmma, the products
    with P or dS split exactly into three bf16 terms, see `split_bf16`);
    fp32 inputs and D 128 and 256 run on CUDA cores (FFMA). The forward
    kernel writes `o` and the per-row
    `lse`; `_FlashAttention`, a `torch.autograd.Function`, saves `(q, k,
    v, o, lse)` and its backward computes `delta = rowsum(dO * O)` in
    plain torch, then launches the dQ kernel and the dK/dV kernel. The
    kernels read q, k and v in place through their strides (the per-head
    views of the fused qkv product: no `[BH, S, D]` copies; in bf16 the
    pointers and strides must be 16-byte aligned) and write contiguous
    `[B, S, H, D]` outputs and `[B*H, S]` fp32 statistics. The wrappers
    (`flash_fwd_cuda`, `flash_dq_cuda`, `flash_dkv_cuda`) take CUDA tensors
    only and raise on anything else; each counts its launches in
    `launches`.
  - `reference`: plain torch with exactly the dense arithmetic (fp32 logits
    times 1/sqrt(d), the mask at finfo(float32).min, fp32 softmax, the
    probabilities cast to bf16 when `bf16` else to q's dtype), differentiated
    by autograd. The CPU path; `calls` counts it.
  - `dense`: `_xla_attention`, the JAX package's legacy path, which is the
    reference without the bf16 option.

`auto` (and the legacy `flash`) picks `kernel` for CUDA tensors and
`reference` for CPU tensors; the legacy `dot` is `dense`. The dispatcher
sends only shapes the kernels are built for to them (`S % 128 == 0` and
`D` in 64/128/256, the JAX package's `_pallas_supported` rule), decided from
the shapes before any launch; any other shape runs the reference.

Meta tensors (the preflight's abstract trace, determined_tpu_torch/analysis)
take the route a CUDA device would: `flash_attention` resolves the setting
as for a CUDA tensor, and each wrapper, given meta tensors, returns empty
meta outputs of the kernel's shapes and dtypes (`o` like q, `lse` [B*H, S]
fp32; dq, dk, dv like q) after the same layout checks. A meta tensor holds
no values, so nothing computes and no launch is counted: the estimate
counts the memory the kernels' outputs take on the card, not the plain
version's [S, S] scores. CPU tensors still run the plain version (the
dispatcher) or raise (the wrappers).

`flash_fwd_reference`, `flash_dq_reference` and `flash_dkv_reference` are
the plain versions of the three kernels on the kernels' own inputs and
outputs (lse, delta, dq, dk, dv), with the kernels' rounding: what
chip_smoke.py holds the kernels to. Each counts its calls in `calls`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from determined_tpu_torch.ops import _build

TRAIN_ATTENTION_IMPLS = ("auto", "kernel", "pallas", "reference", "dense")
KERNEL_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def resolve_attention_impl(setting: Optional[str] = None,
                           device: Optional[torch.device] = None) -> str:
    """`attention_impl` -> "kernel" | "reference" | "dense".

    auto (the default) and the legacy "flash" pick the CUDA kernel for a
    CUDA `device` and the reference for a CPU one (`device` None: CUDA when
    one is present, as the JAX package asks its default backend); "pallas",
    the JAX package's name for its kernel, names the CUDA kernel here; the
    legacy "dot" is "dense"."""
    s = setting or "auto"
    if s in ("auto", "flash"):
        if device is None:
            on_cuda = torch.cuda.is_available()
        else:
            on_cuda = torch.device(device).type == "cuda"
        return "kernel" if on_cuda else "reference"
    if s == "dot":
        return "dense"
    if s == "pallas":
        return "kernel"
    if s not in ("kernel", "reference", "dense"):
        raise ValueError(
            f"attention_impl must be one of {TRAIN_ATTENTION_IMPLS} "
            f"(or legacy flash/dot), got {setting!r}")
    return s


# ------------------------------------------------------ reference / dense


def _causal_mask(s_q: int, s_k: int, device) -> torch.Tensor:
    return torch.ones(s_q, s_k, dtype=torch.bool, device=device).tril(
        diagonal=s_k - s_q)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, bf16: bool = False
                        ) -> torch.Tensor:
    """Plain attention with exactly the dense arithmetic: [B, S, H, D] ->
    [B, S, H, D]. fp32 logits and softmax; with bf16=True the probabilities
    are cast to bfloat16 for the P.V product."""
    reference_attention.calls += 1
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    probs = probs.to(torch.bfloat16 if bf16 else q.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)  # jnp's promotion
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), v.to(dt)).to(
        q.dtype)


reference_attention.calls = 0


def _xla_attention(q, k, v, causal: bool) -> torch.Tensor:
    """The legacy dense path (attention_impl: dense)."""
    return reference_attention(q, k, v, causal=causal, bf16=False)


def kernel_supported(q: torch.Tensor) -> bool:
    """Shapes the dispatcher sends to the CUDA kernels: the JAX package's
    `_pallas_supported` rule, S divisible by 128 and D in 64/128/256."""
    _, s, _, d = q.shape
    return s % 128 == 0 and d in KERNEL_HEAD_DIMS


# ---------------------------------------- plain versions of the kernels


def flash_fwd_reference(q, k, v, causal: bool = True, bf16: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (o [B,S,H,D] in q's dtype,
    lse [B*H, S] fp32). It computes the kernel's function, which differs
    from `reference_attention` in bf16: the logits are the fp32 sums of
    the exact products (not rounded to the inputs' dtype), and P.V runs
    in fp32 unless `bf16` rounds P to the value dtype."""
    flash_fwd_reference.calls += 1
    b, s, h, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if causal:
        logits = torch.where(_causal_mask(s, s, q.device), logits,
                             torch.finfo(torch.float32).min)
    lse = torch.logsumexp(logits, dim=-1).reshape(b * h, s)
    probs = torch.softmax(logits, dim=-1)
    if bf16:
        probs = probs.to(v.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return o.to(q.dtype), lse


flash_fwd_reference.calls = 0


def _bwd_plain(q, k, v, dout, lse, delta, causal: bool, bf16: bool):
    """The backward's shared part in fp32 [B, H, S, *]: (p, ds, q, k, dout)
    with the operands of the fp32 products rounded to bf16 when `bf16`."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, dout))
    st = qf @ kf.transpose(-1, -2) * scale
    p = torch.exp(st - lse.reshape(b, h, s, 1))
    if causal:
        p = torch.where(_causal_mask(s, s, q.device), p, 0.0)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - delta.reshape(b, h, s, 1)) * scale
    if bf16:
        p, ds, qf, kf, dof = (t.to(torch.bfloat16).float()
                              for t in (p, ds, qf, kf, dof))
    return p, ds, qf, kf, dof


def flash_dq_reference(q, k, v, dout, lse, delta, causal: bool = True,
                       bf16: bool = False) -> torch.Tensor:
    """Plain version of the dQ kernel on its inputs: dq = dS.K, [B, S, H,
    D] in q's dtype. fp32 throughout; with bf16=True, dS and K are rounded
    to bf16 before their product."""
    flash_dq_reference.calls += 1
    _, ds, _, kf, _ = _bwd_plain(q, k, v, dout, lse, delta, causal, bf16)
    return (ds @ kf).permute(0, 2, 1, 3).to(q.dtype)


flash_dq_reference.calls = 0


def flash_dkv_reference(q, k, v, dout, lse, delta, causal: bool = True,
                        bf16: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: (dk = dS^T.Q, dv = P^T.dO), [B,
    S, H, D] in q's dtype, with the dQ version's rounding."""
    flash_dkv_reference.calls += 1
    p, ds, qf, _, dof = _bwd_plain(q, k, v, dout, lse, delta, causal, bf16)
    dk = ds.transpose(-1, -2) @ qf
    dv = p.transpose(-1, -2) @ dof
    return (dk.permute(0, 2, 1, 3).to(q.dtype),
            dv.permute(0, 2, 1, 3).to(q.dtype))


flash_dkv_reference.calls = 0


def split_bf16(x: torch.Tensor, terms: int = 3):
    """Plain version of the tensor-core kernels' split of an fp32 operand
    (`split_pair` in ops/csrc/flash_attention.cu): `terms` bf16 tensors, the
    first bf16(x) and each next one bf16 of what the earlier ones left. With
    3 terms they sum to x exactly (24 bits of significand in three 8-bit
    pieces; bf16 has fp32's exponent range), so for a bf16 y, x.y is the sum
    of the three bf16 products; with 1 it is the `bf16=True` rounding."""
    out, rest = [], x.float()
    for _ in range(terms):
        t = rest.to(torch.bfloat16)
        out.append(t)
        rest = rest - t.float()
    return out


# ---------------------------------------------------------- CUDA kernels


def _check(name: str, tensors) -> bool:
    """Raise ValueError unless the kernels take these [B, S, H, D] tensors:
    devices first (a CPU tensor never reaches a kernel), then dtypes and
    layout. True for meta tensors, which take the kernel's shapes and
    launch nothing (the module docstring)."""
    q = tensors[0][1]
    if all(t.device.type == "meta" for _, t in tensors):
        _check_layout(name, tensors)
        return True
    for tname, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {tname} is on {t.device}, not cuda")
        if t.device != q.device:
            raise ValueError(
                f"{name}: {tname} is on {t.device}, q on {q.device}")
    _check_layout(name, tensors)
    return False


def _check_layout(name: str, tensors) -> None:
    q = tensors[0][1]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not in float32/bfloat16")
    if q.dim() != 4:
        raise ValueError(f"{name}: expected [B, S, H, D], got {tuple(q.shape)}")
    for tname, t in tensors:
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                f"{name}: {tname} {t.dtype} {tuple(t.shape)} does not match "
                f"q {q.dtype} {tuple(q.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname}'s last dim is not contiguous")
    b, s, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"{name}: B*H {b * h} > 65535")
    if q.dtype == torch.bfloat16:
        # The tensor-core route copies rows by 16-byte cp.async.
        for tname, t in tensors:
            if t.data_ptr() % 16 or any(st * 2 % 16 for st in t.stride()[:3]):
                raise ValueError(
                    f"{name}: {tname}'s data pointer or (batch, seq, head) "
                    f"strides {t.stride()[:3]} are not 16-byte aligned")


def _check_stats(name: str, q: torch.Tensor, **stats) -> None:
    b, s, h, _ = q.shape
    for sname, t in stats.items():
        if t.device != q.device or t.dtype != torch.float32 or \
                tuple(t.shape) != (b * h, s) or not t.is_contiguous():
            raise ValueError(
                f"{name}: {sname} must be a contiguous fp32 [B*H, S] = "
                f"[{b * h}, {s}] tensor on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.dtt_flash_fwd.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        tail = [ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp]
        lib.dtt_flash_fwd.argtypes = [vp] * 6 + tail
        lib.dtt_flash_bwd_dq.argtypes = [vp] * 8 + tail
        lib.dtt_flash_bwd_dkv.argtypes = [vp] * 9 + tail
        for fn in (lib.dtt_flash_fwd, lib.dtt_flash_bwd_dq,
                   lib.dtt_flash_bwd_dkv):
            fn.restype = ci
        lib.dtt_error_string.argtypes = [ci]
        lib.dtt_error_string.restype = ctypes.c_char_p
    return lib


def _strides(*tensors) -> ctypes.Array:
    """(batch, seq, head) element strides of each tensor, 12 in all."""
    vals = [st for t in tensors for st in t.stride()[:3]]
    vals += [0] * (12 - len(vals))
    return (ctypes.c_longlong * 12)(*vals)


def _launch(name: str, fn, q: torch.Tensor, ptrs, strides, causal: bool,
            round_bf16: bool) -> None:
    b, s, h, d = q.shape
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn)(
            *ptrs, strides, b, h, s, d, _DTYPE_CODES[q.dtype], int(causal),
            int(round_bf16), 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: launch failed: {lib.dtt_error_string(err).decode()} "
            f"(cudaError {err})")


def flash_fwd_cuda(q, k, v, causal: bool = True, bf16: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel -> (o [B,S,H,D] contiguous, lse [B*H, S]
    fp32). Runs on the current stream and does not synchronise. Raises on
    a CPU tensor, a dtype or layout the kernel does not take, and on a
    refused launch: there is no fallback to the plain version."""
    meta = _check("flash_fwd_cuda", (("q", q), ("k", k), ("v", v)))
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    if meta:
        return o, lse
    _launch("flash_fwd_cuda", "dtt_flash_fwd", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()), _strides(q, k, v), causal,
            bf16 and q.dtype == torch.bfloat16)
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def flash_dq_cuda(q, k, v, dout, lse, delta, causal: bool = True,
                  bf16: bool = False) -> torch.Tensor:
    """Launch the dQ kernel -> dq [B, S, H, D] contiguous."""
    meta = _check("flash_dq_cuda",
                  (("q", q), ("k", k), ("v", v), ("dout", dout)))
    _check_stats("flash_dq_cuda", q, lse=lse, delta=delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if meta:
        return dq
    _launch("flash_dq_cuda", "dtt_flash_bwd_dq", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            _strides(q, k, v, dout), causal, bf16)
    flash_dq_cuda.launches += 1
    return dq


flash_dq_cuda.launches = 0


def flash_dkv_cuda(q, k, v, dout, lse, delta, causal: bool = True,
                   bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel -> (dk, dv) [B, S, H, D] contiguous."""
    meta = _check("flash_dkv_cuda",
                  (("q", q), ("k", k), ("v", v), ("dout", dout)))
    _check_stats("flash_dkv_cuda", q, lse=lse, delta=delta)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if meta:
        return dk, dv
    _launch("flash_dkv_cuda", "dtt_flash_bwd_dkv", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            _strides(q, k, v, dout), causal, bf16)
    flash_dkv_cuda.launches += 1
    return dk, dv


flash_dkv_cuda.launches = 0


def flash_delta(dout: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, as [B*H, S] (the backward's plain
    torch step between the kernels)."""
    b, s, h, _ = o.shape
    delta = (dout.float() * o.float()).sum(dim=-1)  # [B, S, H]
    return delta.permute(0, 2, 1).reshape(b * h, s).contiguous()


class _FlashAttention(torch.autograd.Function):
    """The kernels as one differentiable op (`jax.custom_vjp` in the JAX
    package): the forward saves (q, k, v, o, lse) as `_flash_vjp_fwd`
    does."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, bf16: bool):
        o, lse = flash_fwd_cuda(q, k, v, causal, bf16)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.bf16 = causal, bf16
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        delta = flash_delta(dout, o)
        dq = flash_dq_cuda(q, k, v, dout, lse, delta, ctx.causal, ctx.bf16)
        dk, dv = flash_dkv_cuda(q, k, v, dout, lse, delta, ctx.causal,
                                ctx.bf16)
        return dq, dk, dv, None, None


def cuda_flash_attention(q, k, v, causal: bool = True, bf16: bool = False
                         ) -> torch.Tensor:
    """q, k, v [B, S, H, D] CUDA tensors -> [B, S, H, D], differentiable
    through the dQ and dK/dV kernels."""
    return _FlashAttention.apply(q, k, v, causal, bf16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, impl: Optional[str] = None,
                    bf16: bool = False) -> torch.Tensor:
    """Self-attention over [B, S, H, D], dispatched by `attention_impl`:
    auto | kernel | pallas | reference | dense (None == auto; legacy
    flash/dot accepted). "kernel" on a shape outside `kernel_supported`
    runs the reference; "kernel" on CPU tensors raises. Meta tensors take
    the route of CUDA ones."""
    device = torch.device("cuda") if q.device.type == "meta" else q.device
    resolved = resolve_attention_impl(impl, device)
    if resolved == "kernel" and kernel_supported(q):
        return cuda_flash_attention(q, k, v, causal=causal, bf16=bf16)
    if resolved == "dense":
        return _xla_attention(q, k, v, causal)
    return reference_attention(q, k, v, causal=causal, bf16=bf16)
