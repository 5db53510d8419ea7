"""The online-softmax arithmetic the attention kernels share, in plain torch.

Counterpart of determined_tpu/ops/_pallas_common.py. The CUDA kernels carry
their own copy of this update in C++ (ops/csrc/); this module is the plain
version the tests read it against: fp32 running max `m`, normaliser `l`
and accumulator `acc`, one masked logits tile folded in at a time.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Masked logits value. Not -inf: exp(-inf - -inf) is NaN when a whole row is
# masked; a large finite negative keeps exp() at exactly 0.0.
NEG_INF = -1e30


def init_softmax_state(rows: int, d: int, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(acc [rows, d], m [rows, 1], l [rows, 1]), all fp32."""
    acc = torch.zeros((rows, d), dtype=torch.float32, device=device)
    m = torch.full((rows, 1), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((rows, 1), dtype=torch.float32, device=device)
    return acc, m, l


def online_softmax_update(st: torch.Tensor, v: torch.Tensor,
                          acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one fp32 logits tile `st` [rows, cols] (masked entries at
    NEG_INF) and its values `v` [cols, d] into (acc, m, l); returns the new
    state. P.V accumulates in fp32, as the decode kernel does."""
    m_new = torch.maximum(m, st.max(dim=-1, keepdim=True).values)
    alpha = torch.exp(m - m_new)
    p = torch.exp(st - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + p @ v.float()
    return acc_new, m_new, l_new


def finish_softmax_state(acc: torch.Tensor, l: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """Normalise the accumulator out to the output dtype."""
    return (acc / l).to(dtype)
