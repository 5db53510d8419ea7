"""expconf's legacy shim, the one piece of the experiment-config schema
system the port's preflight needs.

Counterpart of `determined_tpu.expconf.shim`, copied whole with the
`optimizations:` keys it keeps (`OPTIMIZATION_KEYS`). Validation,
defaults and merging stay in the shared `determined_tpu.expconf`, which
the master-side CLI runs; `analysis.preflight` calls `shim` first, as the
JAX package's does.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

OPTIMIZATION_KEYS = ("attention_impl", "attention_bf16",
                     "overlap_allgather", "prepartition_inputs")


def shim(config: Dict[str, Any]) -> Dict[str, Any]:
    """Translate legacy config shapes into the current schema (reference
    pkg/schemas/expconf/legacy.go + the v0 version shims): configs written
    for older formats keep working, torch/container-era knobs that have no
    TPU meaning are dropped with a warning instead of failing validation.

    Shims (applied before validate):
      - bare-int lengths → {"batches": N}: searcher.max_length,
        min_validation_period, min_checkpoint_period
      - searcher.max_steps (ancient) → max_length {batches}
      - searcher.name "adaptive"/"adaptive_simple" → adaptive_asha,
        "sync_halving" → async_halving (semantics preserved; the legacy
        names stay accepted by validate for byte-for-byte old configs)
      - resources.slots → resources.slots_per_trial
      - optimizations: the torch-era keys (aggregation_frequency, ...)
        are dropped per-key with a warning; the TPU keys
        (attention_impl, attention_bf16, overlap_allgather,
        prepartition_inputs) are kept. A block left empty is dropped.
      - dropped with a warning: bind_mounts (no containers),
        data_layers, entrypoint_script
    """
    import warnings

    c = copy.deepcopy(config)
    if not isinstance(c, dict):
        return c

    searcher = c.get("searcher")
    if isinstance(searcher, dict):
        if "max_length" not in searcher and "max_steps" in searcher:
            searcher["max_length"] = {"batches": searcher.pop("max_steps")}
        if isinstance(searcher.get("max_length"), (int, float)):
            searcher["max_length"] = {"batches": int(searcher["max_length"])}
    for period in ("min_validation_period", "min_checkpoint_period"):
        if isinstance(c.get(period), (int, float)):
            c[period] = {"batches": int(c[period])}

    res = c.get("resources")
    if isinstance(res, dict) and "slots_per_trial" not in res and \
            isinstance(res.get("slots"), int):
        res["slots_per_trial"] = res.pop("slots")

    opt = c.get("optimizations")
    if isinstance(opt, dict):
        for legacy in sorted(set(opt) - set(OPTIMIZATION_KEYS)):
            warnings.warn(
                f"expconf: `optimizations.{legacy}` is a torch-era knob "
                "with no meaning on the TPU platform and is ignored",
                stacklevel=2)
            opt.pop(legacy)
        if not opt:
            c.pop("optimizations")
    elif "optimizations" in c:
        warnings.warn(
            "expconf: `optimizations` must be a mapping of TPU knobs "
            "(attention_impl, ...); the legacy form is ignored",
            stacklevel=2)
        c.pop("optimizations")

    for dropped in ("bind_mounts", "data_layers", "entrypoint_script"):
        if dropped in c:
            warnings.warn(
                f"expconf: `{dropped}` has no meaning on the TPU platform "
                "and is ignored", stacklevel=2)
            c.pop(dropped)
    return c
