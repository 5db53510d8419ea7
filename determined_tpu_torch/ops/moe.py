"""Mixture-of-Experts block, with expert parallelism over the mesh's
`expert` axis.

Counterpart of determined_tpu/ops/moe.py: the same parameters
(`init_moe`, `moe_logical_axes`) and the same function (`moe_block`):

  - router logits and softmax in fp32;
  - top-k experts a token, the lower index first among equal
    probabilities (`jax.lax.top_k`'s order: a stable descending sort), the
    gates renormalised by max(sum, 1e-9);
  - capacity ceil(t / e * capacity_factor) slots an expert, t the GLOBAL
    token count; slots taken choice-major, then in token order, each
    choice starting where the previous left off; a token past capacity is
    dropped (its term is 0, the residual carries it);
  - the experts' FFN with the tanh-form GELU;
  - the load-balance loss e * sum(f * p) (Switch Transformer eq. 4), f the
    share of tokens whose first choice is each expert, p the mean router
    probability.

What differs is how tokens reach their slots. The JAX package builds
`dispatch` and `combine` as `[T, E, C]` one-hots and contracts them with
einsums, GSPMD's way of placing the all-to-all; at GPT-2 small's width
those two products cost more than the experts. Here each kept
(token, choice) is scattered into its `[E, C, D]` slot (`index_put`) and
gathered back (`index_select`), weighted by its gate cast to the
activation dtype; the k terms are summed in fp32 and rounded once. Each
slot holds at most one token and each token at most k terms, so this is
the one-hot products' function exactly. The scatter's backward is a
gather; the gather's adds each row once, but for the spare row that every
dropped term points at, which is discarded: so a step is deterministic
and a CUDA graph replays it bitwise. Every shape is static and nothing
reads a device value on the host, so the serving engine and
`make_multi_step` capture the block.

Over a mesh (`mesh`, a DeviceMesh; the params' DTensors carry it) the
default rules put "batch" on (data, fsdp) and the expert dim on `expert`:
tokens are replicated across the expert group and each expert rank holds
E / ep experts (`gather_params` gathers their leaves over fsdp only).
Routing stays global: each rank adds the exclusive prefix, over the batch
group, of the per-expert counts of each choice (one all-gather of [k, E]
ints), capacity comes from the global t, and f and p are summed over the
batch group before their product. The expert group runs Megatron's f/g
pair around the local experts: the dispatched tokens and the gates pass
identity forward and are all-reduced backward (f), the partial output is
all-reduced forward and passes identity backward (g). Without the pair a
rank would hold only its experts' share of the trunk's gradients.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from determined_tpu_torch.parallel import collectives, sharding
from determined_tpu_torch.parallel.sharding import LogicalRules

Params = Dict[str, Any]


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, param_dtype: torch.dtype = torch.float32,
             std: float = 0.02, layers: Optional[int] = None,
             device=None) -> Params:
    """Parameters for one MoE FFN (or a stacked [layers, ...] tree): the
    JAX `init_moe`'s shapes and deviations (router and up N(0, std), down
    N(0, std / sqrt(2)), biases 0), drawn from `generator`."""
    lead = () if layers is None else (layers,)
    device = device if device is not None else generator.device

    def normal(shape, s):
        return (torch.randn(lead + shape, generator=generator, device=device,
                            dtype=torch.float32) * s).to(param_dtype)

    def zeros(shape):
        return torch.zeros(lead + shape, dtype=param_dtype, device=device)

    e, d, f = num_experts, d_model, d_ff
    return {
        "router": {"kernel": normal((d, e), std)},
        "up": {"kernel": normal((e, d, f), std), "bias": zeros((e, f))},
        "down": {"kernel": normal((e, f, d), std / math.sqrt(2)),
                 "bias": zeros((e, d))},
    }


def moe_logical_axes(layers: bool = False) -> Dict[str, Any]:
    """Logical axis names of `init_moe`'s params (the expert dim maps to
    the `expert` mesh axis under the default rules)."""
    L = ("layers",) if layers else ()
    return {
        "router": {"kernel": L + ("embed", None)},
        "up": {"kernel": L + ("expert", "embed", "mlp"),
               "bias": L + ("expert", "mlp")},
        "down": {"kernel": L + ("expert", "mlp", "embed"),
                 "bias": L + ("expert", "embed")},
    }


def gather_params(params: Params) -> Params:
    """One layer's MoE params for use: the router gathered whole, the
    experts' leaves over every axis but `expert` (each rank keeps its
    E / ep experts); plain tensors pass through."""
    return {
        "router": {"kernel": sharding.gather_for_use(
            params["router"]["kernel"])},
        **{name: {k: sharding.gather_for_use(v, keep=("expert",))
                  for k, v in params[name].items()}
           for name in ("up", "down")},
    }


# ------------------------------------------------------------ the groups


class _Groups(NamedTuple):
    """Where a rank sits for the block: the process groups of the batch
    axes above 1 (outermost first) with their sizes, this rank's block of
    the batch and the count of blocks, and the expert group, its size and
    this rank's place in it."""
    batch: Tuple[Tuple[Any, int], ...]
    batch_index: int
    batch_count: int
    expert: Any
    expert_size: int
    expert_rank: int


def _groups(mesh, rules: Optional[LogicalRules]) -> Optional[_Groups]:
    if mesh is None or mesh.size() == 1:
        return None
    rules = rules or LogicalRules()
    names = mesh.mesh_dim_names

    def axes(logical):
        a = rules.mesh_axes(logical)
        a = () if a is None else (a,) if isinstance(a, str) else tuple(a)
        return [x for x in a if mesh.size(names.index(x)) > 1]

    batch, index, count = [], 0, 1
    for a in axes("batch"):
        i = names.index(a)
        batch.append((mesh.get_group(i), mesh.size(i)))
        index = index * mesh.size(i) + mesh.get_local_rank(i)
        count *= mesh.size(i)
    expert = axes("expert")
    if len(expert) > 1:
        raise ValueError(f"the expert dim maps to several mesh axes {expert}")
    if expert:
        i = names.index(expert[0])
        return _Groups(tuple(batch), index, count, mesh.get_group(i),
                       mesh.size(i), mesh.get_local_rank(i))
    return _Groups(tuple(batch), index, count, None, 1, 0)


def _gather_batch(t: torch.Tensor, groups: Sequence[Tuple[Any, int]]
                  ) -> torch.Tensor:
    """Every batch block's `t`, stacked in block order: [count, *t.shape]."""
    import torch.distributed as dist

    shape = t.shape
    for g, n in reversed(groups):  # innermost axis first
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=g)
        t = torch.stack(parts)
    return t.reshape(-1, *shape)


# ------------------------------------------------------------- routing


class Routing(NamedTuple):
    probs: torch.Tensor      # [T, E] fp32 router probabilities
    gate_idx: torch.Tensor   # [T, k] int64 chosen experts, best first
    gate_vals: torch.Tensor  # [T, k] fp32 renormalised gates
    pos: torch.Tensor        # [T, k] int64 slot in the expert's buffer
    kept: torch.Tensor       # [T, k] bool: pos < capacity
    capacity: int


def route(xt: torch.Tensor, router: torch.Tensor, num_experts: int,
          top_k: int, capacity_factor: float,
          groups: Optional[_Groups] = None) -> Routing:
    """The router's choices for tokens `xt` [T, D] and each (token,
    choice)'s slot, in the global token order of the batch."""
    e = num_experts
    k = min(top_k, e)
    t = xt.shape[0]
    n_blocks = groups.batch_count if groups is not None else 1
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    gate_idx = order[:, :k]
    gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    capacity = max(1, int(math.ceil(t * n_blocks / e * capacity_factor)))

    # [k, E, T]: the scan over tokens runs along the innermost dim (a
    # scan over the outer dim of [T, k*E] runs each column serially).
    sel = F.one_hot(gate_idx.t(), e).transpose(1, 2).contiguous()
    counts = sel.sum(-1)  # [k, E]
    if groups is not None and groups.batch:
        every = _gather_batch(counts, groups.batch)  # [blocks, k, E]
        before = every[:groups.batch_index].sum(0)
        total = every.sum(0)
    else:
        before, total = torch.zeros_like(counts), counts
    # Slots taken by earlier choices (every block's), then by this
    # choice's earlier tokens (earlier blocks', then this block's).
    start = torch.cumsum(total, 0) - total + before  # [k, E]
    rank_in = torch.cumsum(sel, -1) - 1 + start[..., None]  # [k, E, T]
    pos = rank_in.gather(1, gate_idx.t()[:, None, :])[:, 0].t()  # [T, k]
    return Routing(probs, gate_idx, gate_vals, pos, pos < capacity, capacity)


def _aux_loss(r: Routing, num_experts: int, groups: Optional[_Groups]
              ) -> torch.Tensor:
    """e * sum(f * p) over the global batch."""
    first = F.one_hot(r.gate_idx[:, 0], num_experts).float()
    sums = torch.stack([first.sum(0), r.probs.sum(0)])  # [2, E]
    t = r.probs.shape[0]
    if groups is not None and groups.batch:
        sums = collectives.sum_over(sums, [g for g, _ in groups.batch])
        t *= groups.batch_count
    f, p = sums / t
    return num_experts * torch.sum(f * p)


# ---------------------------------------------------------------- block


def moe_block(x: torch.Tensor, params: Params, num_experts: int, *,
              top_k: int = 2, capacity_factor: float = 1.25,
              rules: Optional[LogicalRules] = None, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D] in x's dtype, aux loss fp32 scalar).

    `params` as `gather_params` returns them: over a mesh with an expert
    axis above 1, the experts' leaves hold this rank's E / ep experts.
    `mesh` (None: one process) is the DeviceMesh the batch and the
    experts are laid out on by `rules`."""
    b, s, d = x.shape
    t, e = b * s, num_experts
    dt = x.dtype
    groups = _groups(mesh, rules)
    xt = x.reshape(t, d)
    r = route(xt, params["router"]["kernel"], e, top_k, capacity_factor,
              groups)
    k, cap = r.gate_idx.shape[1], r.capacity

    up_w, down_w = params["up"]["kernel"], params["down"]["kernel"]
    local = up_w.shape[0]
    ep = groups.expert_size if groups is not None else 1
    if local * ep != e:
        raise ValueError(
            f"{local} experts on each of {ep} expert ranks; the model has {e}")
    first = (groups.expert_rank if groups is not None else 0) * local
    gate = r.gate_vals
    if ep > 1:
        xt = collectives.copy_to(xt, groups.expert)
        gate = collectives.copy_to(gate, groups.expert)

    # Slot of each (token, choice) among this rank's experts; a dropped or
    # another rank's one goes to the spare row local * cap, which is 0 in
    # the gather and discarded after the scatter.
    mine = r.kept & (r.gate_idx >= first) & (r.gate_idx < first + local)
    spare = local * cap
    slot = torch.where(mine, (r.gate_idx - first) * cap + r.pos,
                       torch.full_like(r.pos, spare))  # [T, k]

    xe = xt.new_zeros(spare + 1, d).index_put(
        (slot.t().reshape(-1),), xt.repeat(k, 1))
    xe = xe[:spare].view(local, cap, d)
    h = torch.bmm(xe, up_w.to(dt)) + params["up"]["bias"].to(dt)[:, None, :]
    h = F.gelu(h, approximate="tanh")
    ye = torch.bmm(h, down_w.to(dt)) + \
        params["down"]["bias"].to(dt)[:, None, :]
    ye = torch.cat([ye.reshape(spare, d), ye.new_zeros(1, d)])

    y = None
    for c in range(k):
        term = gate[:, c].to(dt).float()[:, None] * \
            ye.index_select(0, slot[:, c]).float()
        y = term if y is None else y + term
    if ep > 1:
        y = collectives.reduce_from(y, groups.expert)
    return y.to(dt).reshape(b, s, d), _aux_loss(r, e, groups)
