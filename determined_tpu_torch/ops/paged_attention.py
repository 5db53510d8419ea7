"""Paged decode attention: one query per slot over a block pool of K/V.

Counterpart of determined_tpu/ops/paged_attention.py. Each decode step,
every slot attends its single query over K/V that live in a block pool
`[num_pool_blocks, block_size, H, Dh]` (one layer), addressed through the
slot's block table (`[slots, max_blocks]` int32: logical block i of the
sequence is pool block `table[s, i]`). Inactive slots point their whole
table at the trash block (the pool's last) and sit at position 0.

  - `paged_attention_reference`: the plain version. A gather of each slot's
    lane (`pool[table]`) and then the arithmetic of the dense decode step:
    fp32 logits, the `idx <= pos` mask, fp32 softmax, probabilities cast to
    `q.dtype`. The CPU path, and what the kernel is held against.
  - `paged_attention_cuda`: the wrapper of the hand-written CUDA kernels
    (ops/csrc/paged_attention.cu): each context is split into chunks of
    `SPLIT_KEYS` keys, one thread block per (slot, head, chunk), and a
    second kernel merges the chunks' partial softmax states in a fixed
    order. It takes CUDA tensors only and raises on anything else;
    `launches` counts its calls (one a layer a decode step).
  - `paged_decode_attention(..., impl)`: the dispatcher the decode step
    calls. `"kernel"` launches the kernel, `"reference"` runs the plain
    version, `"auto"` picks by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from determined_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_BLOCK_SIZE = 128
# Keys of one split of a context (a multiple of every block size the
# kernels take): ceil(max_blocks * block_size / SPLIT_KEYS) thread blocks
# per (slot, head).
SPLIT_KEYS = 512


def paged_attention_reference(
    q: torch.Tensor,             # [slots, H, Dh]
    k_pool: torch.Tensor,        # [num_pool_blocks, block_size, H, Dh]
    v_pool: torch.Tensor,        # [num_pool_blocks, block_size, H, Dh]
    block_tables: torch.Tensor,  # [slots, max_blocks] int32
    positions: torch.Tensor,     # [slots] int32: index written this step
) -> torch.Tensor:
    """Plain paged decode attention -> [slots, H, Dh] in q.dtype."""
    paged_attention_reference.calls += 1
    slots, mb = block_tables.shape
    bs = k_pool.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    tables = block_tables.long()
    k_lane = k_pool[tables].reshape(slots, mb * bs, *k_pool.shape[2:])
    v_lane = v_pool[tables].reshape(slots, mb * bs, *v_pool.shape[2:])
    idx = torch.arange(mb * bs, device=q.device)
    mask = idx[None] <= positions.long()[:, None]  # [slots, S]
    logits = torch.einsum("bhd,bmhd->bhm", q, k_lane).float()
    logits = torch.where(mask[:, None], logits * scale,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhm,bmhd->bhd", probs, v_lane)


paged_attention_reference.calls = 0


def _check(q, k_pool, v_pool, block_tables, positions) -> None:
    """Raise ValueError unless the kernel takes these tensors: devices
    first (a CPU tensor never reaches the kernel), then dtypes, shapes and
    layout."""
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("positions", positions)):
        if t.device.type != "cuda":
            raise ValueError(
                f"paged_attention_cuda: {name} is on {t.device}, not cuda")
        if t.device != q.device:
            raise ValueError(
                f"paged_attention_cuda: {name} is on {t.device}, q on "
                f"{q.device}")
    _check_layout(q, k_pool, v_pool, block_tables, positions)


def _check_layout(q, k_pool, v_pool, block_tables, positions) -> None:
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("positions", positions)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_cuda: {name} is not contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"paged_attention_cuda: dtype {q.dtype} not in float32/bfloat16")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("paged_attention_cuda: q, k_pool, v_pool dtypes differ")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError(
            "paged_attention_cuda: block_tables and positions must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("paged_attention_cuda: expected q [slots, H, Dh], "
                         "pools [P, bs, H, Dh], tables [slots, mb]")
    slots, nh, dh = q.shape
    p, bs = k_pool.shape[:2]
    if tuple(k_pool.shape) != (p, bs, nh, dh) or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged_attention_cuda: pools {tuple(k_pool.shape)} / "
            f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if block_tables.shape[0] != slots or tuple(positions.shape) != (slots,):
        raise ValueError("paged_attention_cuda: tables/positions do not match "
                         "the slot count of q")
    if dh not in HEAD_DIMS:
        raise ValueError(
            f"paged_attention_cuda: head_dim {dh} not in {HEAD_DIMS}")
    if bs > MAX_BLOCK_SIZE or bs & (bs - 1):
        raise ValueError(
            f"paged_attention_cuda: block_size {bs} is not a power of two "
            f"<= {MAX_BLOCK_SIZE}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(
                f"paged_attention_cuda: {name}'s data pointer is not 16-byte "
                "aligned (the kernel reads rows with 16-byte loads)")


def num_splits(max_blocks: int, block_size: int) -> int:
    """Chunks of `SPLIT_KEYS` keys a context of `max_blocks` blocks is cut
    into: the kernel's grid depth, and the partials the workspace holds."""
    return -(-max_blocks * block_size // SPLIT_KEYS)


def _library() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.dtt_paged_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [ci] * 8 + [ctypes.c_float, vp]
        fn.restype = ci
        lib.dtt_error_string.argtypes = [ci]
        lib.dtt_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention_cuda(
    q: torch.Tensor,             # [slots, H, Dh] fp32 or bf16, contiguous
    k_pool: torch.Tensor,        # [num_pool_blocks, block_size, H, Dh]
    v_pool: torch.Tensor,        # [num_pool_blocks, block_size, H, Dh]
    block_tables: torch.Tensor,  # [slots, max_blocks] int32
    positions: torch.Tensor,     # [slots] int32, each >= 0
) -> torch.Tensor:
    """Launch the CUDA paged decode-attention kernels -> [slots, H, Dh].

    Runs on `torch.cuda.current_stream()` and does not synchronise. Raises
    on a CPU tensor, a dtype, shape or layout the kernels do not take, and
    on a refused launch: there is no fallback to the plain version."""
    _check(q, k_pool, v_pool, block_tables, positions)
    lib = _library()
    slots, nh, dh = q.shape
    p, bs = k_pool.shape[:2]
    mb = block_tables.shape[1]
    out = torch.empty_like(q)
    n_splits = num_splits(mb, bs)
    # Each split's partial (acc[Dh], m, l) in fp32; unused with one split.
    ws = (torch.empty(slots * nh * n_splits * (dh + 2), dtype=torch.float32,
                      device=q.device) if n_splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dtt_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), slots, nh, dh, bs, mb, p,
            SPLIT_KEYS, _DTYPE_CODES[q.dtype], 1.0 / (dh ** 0.5), stream)
    if err != 0:
        raise RuntimeError(
            "paged_attention_cuda: launch failed: "
            f"{lib.dtt_error_string(err).decode()} (cudaError {err})")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def paged_decode_attention(q, k_pool, v_pool, block_tables, positions,
                           impl: str = "auto") -> torch.Tensor:
    """Dispatch by `serving.attention_impl`: "kernel" | "reference" | "auto".

    "auto" launches the kernel for CUDA tensors and runs the plain version
    for CPU tensors; "kernel" raises on CPU tensors."""
    if impl == "auto":
        impl = "kernel" if q.device.type == "cuda" else "reference"
    if impl == "kernel":
        return paged_attention_cuda(q, k_pool, v_pool, block_tables, positions)
    if impl == "reference":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         positions)
    raise ValueError(f"unknown paged attention impl {impl!r}")
