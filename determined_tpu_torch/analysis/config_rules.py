"""Config cross-field checks (DTL2xx).

Counterpart of determined_tpu/analysis/config_rules.py, copied whole: the
same checks give the same codes, levels and messages over the same config
dict (tests/test_torch_preflight.py holds the two to each other). They run
over the experiment-config dict alone — no trial code needed — which is
why the native master re-implements exactly this set in
native/master/preflight.cc and gates experiment creation on it. Keep the
three in lockstep.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from determined_tpu_torch.analysis.diagnostics import Diagnostic
from determined_tpu_torch.analysis.rules import RULES
from determined_tpu_torch.parallel.mesh import AXIS_ORDER

# Axes the batch shards over (LogicalRules DEFAULT_RULES "batch" entry).
BATCH_AXES = ("data", "fsdp")

# DTL205's shape-affecting heuristic: an hparam whose snake_case tokens
# intersect this set changes tensor shapes when swept, so each distinct
# value compiles its own executable. Mirrored in native/master/preflight.cc
# — keep the two in lockstep.
SHAPE_HPARAM_TOKENS = frozenset({
    "batch", "size", "dim", "dims", "width", "depth", "layer", "layers",
    "head", "heads", "seq", "len", "length", "vocab", "position",
    "positions", "expert", "experts", "hidden", "model", "feature",
    "features", "channel", "channels", "embed", "embedding",
})

# "More distinct values than anyone could mean": double/log sweeps of a
# shape-affecting hparam without `count` are effectively unbounded.
_UNBOUNDED = 10**9


def is_shape_hparam(name: str) -> bool:
    return bool(SHAPE_HPARAM_TOKENS & set(name.lower().split("_")))


def _length_batches(v: Any) -> int:
    if isinstance(v, (int, float)):
        return int(v)
    if isinstance(v, dict):
        for unit in ("batches", "records", "epochs"):
            if unit in v:
                return int(v[unit])
    return 0


def resolve_batch_axes_product(config: Dict[str, Any],
                               slots: Any = None) -> int:
    """data*fsdp resolved against slots_per_trial, mirroring
    MeshConfig.resolve (omitted `data` = -1 absorbs remaining chips).
    Returns 0 when the mesh is unresolvable (other validation reports it).
    `slots` overrides resources.slots_per_trial — the DTL204 elastic check
    re-resolves the same mesh at every candidate size.
    """
    hp = config.get("hyperparameters") or {}
    mesh = hp.get("mesh") or {}
    if not isinstance(mesh, dict):
        return 0
    res = config.get("resources") or {}
    if slots is None:
        slots = res.get("slots_per_trial", 1)
    if not isinstance(slots, int) or slots <= 0:
        return 0
    sizes = {a: 1 for a in AXIS_ORDER}
    unknown = []
    for a, v in mesh.items():
        if a not in sizes or isinstance(v, bool) or not isinstance(v, int):
            return 0
        if v == -1:
            unknown.append(a)
        elif v > 0:
            sizes[a] = v
        else:
            return 0
    if "data" not in mesh:
        unknown.append("data")
    if len(unknown) > 1:
        return 0
    fixed = math.prod(sizes[a] for a in AXIS_ORDER if a not in unknown)
    if unknown:
        if slots % fixed != 0:
            return 0
        sizes[unknown[0]] = slots // fixed
    elif fixed != slots:
        return 0
    return sizes["data"] * sizes["fsdp"]


def check_config(config: Dict[str, Any]) -> List[Diagnostic]:
    """DTL201 + DTL202 over a (shimmed) experiment config."""
    diags: List[Diagnostic] = []
    if not isinstance(config, dict):
        return diags

    # DTL201 — global_batch_size vs mesh batch axes.
    hp = config.get("hyperparameters") or {}
    gbs = hp.get("global_batch_size") if isinstance(hp, dict) else None
    if isinstance(gbs, dict):  # hparam spec {type: const, val: N}
        gbs = gbs.get("val") if gbs.get("type") == "const" else None
    if isinstance(gbs, int) and gbs > 0:
        bprod = resolve_batch_axes_product(config)
        if bprod > 1 and gbs % bprod != 0:
            diags.append(RULES["DTL201"].diag(
                f"hyperparameters.global_batch_size={gbs} is not divisible "
                f"by the mesh batch axes data x fsdp = {bprod} (resolved "
                f"against resources.slots_per_trial="
                f"{(config.get('resources') or {}).get('slots_per_trial', 1)})"))

    # DTL202 — ASHA budget vs rungs.
    searcher = config.get("searcher")
    if isinstance(searcher, dict) and searcher.get("name") in (
            "async_halving", "sync_halving"):
        max_length = _length_batches(searcher.get("max_length"))
        num_rungs = searcher.get("num_rungs") or 0
        divisor = searcher.get("divisor") or 4
        if max_length > 0 and isinstance(num_rungs, int) and num_rungs > 1 \
                and isinstance(divisor, (int, float)) and divisor > 1:
            bottom = max_length / (divisor ** (num_rungs - 1))
            if bottom < 1:
                diags.append(RULES["DTL202"].diag(
                    f"searcher.max_length={max_length} < divisor^(num_rungs-1)"
                    f"={int(divisor)}^{num_rungs - 1}="
                    f"{int(divisor ** (num_rungs - 1))}: the bottom rung "
                    "would train for zero batches and the top rungs are "
                    "unreachable; lower num_rungs or raise max_length"))

    # DTL204 — elastic configs must be runnable at EVERY size in
    # [min_slots, max_slots]: the scheduler may re-mesh the trial to any
    # of them on a drain or a scale-up (docs/elasticity.md). Mesh
    # resolvability + batch divisibility here; the HBM-per-size leg runs
    # in preflight() with the abstract-trace engine per candidate mesh.
    res = config.get("resources") or {}
    elastic = res.get("elastic") if isinstance(res, dict) else None
    if isinstance(elastic, dict):
        spt = res.get("slots_per_trial", 1)
        mn = elastic.get("min_slots", 1)
        mx = elastic.get("max_slots", spt if isinstance(spt, int) else 0)
        if isinstance(mn, int) and isinstance(mx, int) and 1 <= mn <= mx:
            gbs_val = gbs if isinstance(gbs, int) and gbs > 0 else None
            for k in range(mn, mx + 1):
                bprod = resolve_batch_axes_product(config, slots=k)
                if bprod == 0:
                    diags.append(RULES["DTL204"].diag(
                        f"elastic size {k} (of [{mn}, {mx}]): "
                        "hyperparameters.mesh does not resolve at this slot "
                        "count — the fixed axes product must divide every "
                        "size the scheduler may shrink/grow the trial to"))
                elif gbs_val is not None and gbs_val % bprod != 0:
                    diags.append(RULES["DTL204"].diag(
                        f"elastic size {k} (of [{mn}, {mx}]): "
                        f"hyperparameters.global_batch_size={gbs_val} is not "
                        f"divisible by the mesh batch axes data x fsdp = "
                        f"{bprod} at this slot count"))

    # DTL205 — shape-affecting hparam sweep without bucketing: more
    # distinct executables than compile.max_executables means the sweep
    # spends its trials compiling instead of training and the compile farm
    # can't share anything across them (docs/compile-farm.md).
    diags.extend(_check_shape_sweep(config))

    # DTL206 — serving paged-KV geometry (docs/serving.md "Paged KV &
    # prefix caching"): the block tables tile max_seq_len in
    # kv_block_size steps, so the block size must divide it; and an
    # explicit kv_num_blocks must leave room for at least one worst-case
    # sequence or admission can never succeed. Both fail the replica at
    # runtime — catch them before launch.
    serving = config.get("serving")
    if isinstance(serving, dict):
        bs = serving.get("kv_block_size", 16)
        max_seq = serving.get("max_seq_len", 256)
        nb = serving.get("kv_num_blocks")
        impl = serving.get("attention_impl", "auto")
        paged = impl != "dense"
        ok_ints = (isinstance(bs, int) and not isinstance(bs, bool)
                   and bs > 0 and isinstance(max_seq, int)
                   and not isinstance(max_seq, bool) and max_seq > 0)
        if paged and ok_ints:
            if max_seq % bs != 0:
                diags.append(RULES["DTL206"].diag(
                    f"serving.kv_block_size={bs} does not divide "
                    f"serving.max_seq_len={max_seq}: the paged block "
                    "tables tile max_seq_len exactly; pick a block size "
                    "that divides it"))
            elif (isinstance(nb, int) and not isinstance(nb, bool)
                  and nb > 0 and nb * bs < max_seq):
                diags.append(RULES["DTL206"].diag(
                    f"serving.kv_num_blocks={nb} x kv_block_size={bs} = "
                    f"{nb * bs} tokens of paged KV pool cannot hold even "
                    f"one max_seq_len={max_seq} sequence — no request "
                    "could ever be admitted; raise kv_num_blocks or lower "
                    "max_seq_len"))

    # DTL207 — capacity-loop knobs (docs/cluster-ops.md "Capacity loop"):
    # the scale-to-zero / spot-floor configuration must be satisfiable, or
    # the deployment either can't be created (master re-check) or pins
    # behavior the operator didn't mean (a floor above max would force
    # every replica on-demand forever).
    if isinstance(serving, dict) and isinstance(serving.get("replicas"),
                                                dict):
        rep = serving["replicas"]

        def _int(key, default):
            v = rep.get(key, default)
            return v if isinstance(v, int) and not isinstance(v, bool) \
                else default

        mn = _int("min", 1)
        tgt = _int("target", mn)
        mx = _int("max", max(1, mn, tgt))
        if mn < 0:
            diags.append(RULES["DTL207"].diag(
                f"serving.replicas.min={mn} is negative; 0 "
                "(scale-to-zero) is the smallest legal floor"))
        elif mn > mx:
            diags.append(RULES["DTL207"].diag(
                f"serving.replicas.min={mn} exceeds max={mx}"))
        floor = rep.get("on_demand_floor", max(mn, 0))
        if isinstance(floor, int) and not isinstance(floor, bool) and (
                floor < 0 or floor > mx):
            diags.append(RULES["DTL207"].diag(
                f"serving.replicas.on_demand_floor={floor} must be within "
                f"[0, max={mx}]: a floor above max can never be satisfied "
                "and would pin every replica to on-demand capacity"))
        budget = rep.get("cold_start_budget_s")
        if budget is not None and (
                isinstance(budget, bool)
                or not isinstance(budget, (int, float)) or budget <= 0):
            diags.append(RULES["DTL207"].diag(
                "serving.replicas.cold_start_budget_s must be a positive "
                "number of seconds: it bounds how long the router holds a "
                "request while a scale-from-zero replica restores"))

    # DTL208 — canary traffic fraction (docs/serving.md "Model
    # lifecycle"): a config-declared canary must split a REAL fraction of
    # traffic — 0 burns a replica for no signal, 1 is a rollout wearing a
    # canary costume (use `det serve update`). Mirrored in
    # native/master/preflight.cc; the deployment-create gate enforces it.
    if isinstance(serving, dict) and isinstance(serving.get("canary"), dict):
        cb = serving["canary"]
        frac = cb.get("fraction")
        if frac is not None and (
                isinstance(frac, bool) or not isinstance(frac, (int, float))
                or not 0 < frac < 1):
            diags.append(RULES["DTL208"].diag(
                f"serving.canary.fraction={frac!r} must be strictly "
                "inside (0, 1): 0 routes nothing to the canary and 1 is "
                "a full rollout — use `det serve update` for that"))

    # DTL203 — restarts configured but nothing to restart from. Only an
    # EXPLICIT min_checkpoint_period: 0 fires (key present): the default is
    # also 0 batches and flagging every config would be pure noise.
    if "min_checkpoint_period" in config:
        mcp = _length_batches(config.get("min_checkpoint_period"))
        mr = config.get("max_restarts", 5)
        if mcp == 0 and isinstance(mr, int) and mr > 0:
            diags.append(RULES["DTL203"].diag(
                f"min_checkpoint_period: 0 with max_restarts={mr}: mid-op "
                "failures can only restart from the previous op-boundary "
                "checkpoint (or from scratch); set a periodic "
                "min_checkpoint_period or max_restarts: 0"))
    return diags


def _distinct_bucketed_batches(mn: int, mx: int, buckets) -> int:
    """Distinct bucket boundaries an int range [mn, mx] maps onto."""
    from determined_tpu_torch.compile.bucketing import bucket_size

    n, b = 0, mn
    while b <= mx and n <= 64:
        n += 1
        b = max(bucket_size(b, buckets), b) + 1
    return max(1, n)


def _spec_distinct(name: str, spec: Any, cfg) -> Tuple[int, bool]:
    """(distinct executable shapes this spec sweeps to, bucketing_helped).
    Non-spec values and consts count 1."""
    from determined_tpu_torch.compile.bucketing import bucket_size

    if not isinstance(spec, dict) or not isinstance(spec.get("type"), str):
        return 1, False
    t = spec["type"]
    is_gbs = name == "global_batch_size"
    if t == "const":
        return 1, False
    if t == "categorical":
        vals = spec.get("vals") or []
        if is_gbs and cfg.bucket_batch_sizes:
            ints = [v for v in vals
                    if isinstance(v, int) and not isinstance(v, bool)]
            if ints:
                return len({bucket_size(v, cfg.buckets) for v in ints}), True
        return max(1, len(vals)), False
    if t == "int":
        mn, mx = spec.get("minval"), spec.get("maxval")
        if not isinstance(mn, int) or not isinstance(mx, int) or mx < mn:
            return 1, False
        if is_gbs and cfg.bucket_batch_sizes:
            return _distinct_bucketed_batches(mn, mx, cfg.buckets), True
        cnt = spec.get("count")
        if isinstance(cnt, int) and cnt > 0:
            return min(cnt, mx - mn + 1), False
        return mx - mn + 1, False
    # double/log sweeping a shape-affecting hparam: every sample is a new
    # shape unless `count` bounds it.
    cnt = spec.get("count")
    if isinstance(cnt, int) and cnt > 0:
        return cnt, False
    return _UNBOUNDED, False


def _check_shape_sweep(config: Dict[str, Any]) -> List[Diagnostic]:
    """DTL205 (docs/compile-farm.md): estimate the distinct executables a
    sweep implies from its shape-affecting hparams and warn past
    compile.max_executables when bucketing is off for the offenders."""
    from determined_tpu_torch.compile.bucketing import CompileConfig

    searcher = config.get("searcher")
    if not isinstance(searcher, dict) or searcher.get("name") in (
            "single", "custom", None):
        return []
    hp = config.get("hyperparameters")
    if not isinstance(hp, dict):
        return []
    cfg = CompileConfig.from_block(config.get("compile"))
    total = 1
    offenders: List[str] = []
    bucketable = False
    for name, spec in hp.items():
        if name == "mesh" or not is_shape_hparam(name):
            continue
        n, bucketed = _spec_distinct(name, spec, cfg)
        if n > 1:
            offenders.append(f"{name} ({'unbounded' if n >= _UNBOUNDED else n}"
                             " distinct shapes)")
            total = min(total * n, _UNBOUNDED)
            if name == "global_batch_size" and not bucketed:
                bucketable = True
    max_trials = searcher.get("max_trials")
    if isinstance(max_trials, int) and max_trials > 0:
        total = min(total, max_trials)
    if not offenders or total <= cfg.max_executables:
        return []
    hint = ("enable compile.bucket_batch_sizes so batch sizes share "
            "bucketed executables, " if bucketable else "")
    return [RULES["DTL205"].diag(
        f"searcher sweep implies ~{'unbounded' if total >= _UNBOUNDED else total} "
        f"distinct executables from shape-affecting hyperparameters "
        f"[{', '.join(offenders)}] > compile.max_executables="
        f"{cfg.max_executables}: each distinct shape pays a full XLA "
        f"compile and the compile farm cannot share artifacts across them; "
        f"{hint}use const/categorical values, or raise "
        "compile.max_executables if intended")]
