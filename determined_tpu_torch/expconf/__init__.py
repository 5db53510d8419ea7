"""expconf — the experiment-config schema system, the port's copy.

Counterpart of `determined_tpu.expconf`, copied whole: `validate`,
`apply_defaults`, `merge`, `check` and the legacy `shim`, with the mesh
axes and the DTL2xx cross-field rules taken from the port's own
`parallel.mesh` and `analysis.config_rules`. The port's client and `det`
CLI run `check` before a submit, as the JAX package's do, and
`analysis.preflight` calls `shim` first.

Searcher variants mirror schemas/expconf/v0/searcher.json:16-51: single,
random, grid, async_halving, adaptive_asha (+ legacy aliases adaptive,
adaptive_simple, sync_halving) and custom.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

SEARCHER_NAMES = {
    "single",
    "random",
    "grid",
    "async_halving",
    "adaptive_asha",
    # legacy aliases (reference legacy.go shims)
    "adaptive",
    "adaptive_simple",
    "sync_halving",
    "custom",
}

HPARAM_TYPES = {"const", "int", "double", "log", "categorical"}

STORAGE_TYPES = {"shared_fs", "directory", "gcs", "s3", "azure"}


def _is_hparam_spec(v: Any) -> bool:
    return isinstance(v, dict) and isinstance(v.get("type"), str)


def _validate_hparam(name: str, spec: Any, errors: List[str]) -> None:
    if not isinstance(spec, dict):
        return  # bare value == const
    t = spec.get("type")
    if t is None:
        # nested hparam group
        for k, v in spec.items():
            _validate_hparam(f"{name}.{k}", v, errors)
        return
    if t not in HPARAM_TYPES:
        errors.append(f"hyperparameters.{name}: unknown type {t!r}")
        return
    if t == "const" and "val" not in spec:
        errors.append(f"hyperparameters.{name}: const requires `val`")
    if t == "categorical" and not spec.get("vals"):
        errors.append(f"hyperparameters.{name}: categorical requires `vals`")
    if t in ("int", "double", "log"):
        for field in ("minval", "maxval"):
            if field not in spec:
                errors.append(f"hyperparameters.{name}: {t} requires `{field}`")
        if "minval" in spec and "maxval" in spec and spec["minval"] > spec["maxval"]:
            errors.append(f"hyperparameters.{name}: minval > maxval")


def _validate_mesh(mesh: Any, resources: Dict[str, Any], errors: List[str]) -> None:
    """`hyperparameters.mesh` is THE home of the allocation's mesh request
    (determined_tpu/parallel/mesh.py MeshConfig): axis name → size, -1 means
    "absorb the remaining chips" (at most one axis), product must match
    resources.slots_per_trial when fully specified."""
    if mesh is None:
        return
    from determined_tpu_torch.parallel.mesh import AXIS_ORDER

    if not isinstance(mesh, dict):
        errors.append("hyperparameters.mesh must be a mapping of axis -> size")
        return
    unknown = sorted(set(mesh) - set(AXIS_ORDER))
    if unknown:
        errors.append(
            f"hyperparameters.mesh: unknown axes {unknown}; valid: {list(AXIS_ORDER)}"
        )
    sizes = []
    n_unknown = 0
    for k, v in mesh.items():
        if isinstance(v, bool) or not isinstance(v, int) or v == 0 or v < -1:
            errors.append(
                f"hyperparameters.mesh.{k}: size must be a positive int or -1"
            )
            return
        if v == -1:
            n_unknown += 1
        else:
            sizes.append(v)
    # MeshConfig defaults an omitted `data` axis to -1 (absorb remaining
    # chips) — mirror that here so runtime-valid configs pass validation.
    if "data" not in mesh:
        n_unknown += 1
    if n_unknown > 1:
        errors.append("hyperparameters.mesh: at most one axis may be -1")
    # apply_defaults will set slots_per_trial=1 — validate against that same
    # default so a mesh asking for 8 chips with no resources block fails at
    # submit time, not at MeshConfig.resolve() mid-launch.
    slots = resources.get("slots_per_trial", 1)
    if isinstance(slots, int) and slots > 0 and not unknown:
        import math

        product = math.prod(sizes)
        if n_unknown == 0 and product != slots:
            errors.append(
                f"hyperparameters.mesh: axis product {product} != "
                f"resources.slots_per_trial {slots}"
            )
        elif n_unknown == 1 and slots % product != 0:
            errors.append(
                f"hyperparameters.mesh: slots_per_trial {slots} not divisible "
                f"by fixed axes product {product}"
            )


def _length_units(v: Any) -> Optional[int]:
    if isinstance(v, (int, float)):
        return int(v)
    if isinstance(v, dict):
        for unit in ("batches", "records", "epochs"):
            if unit in v:
                return int(v[unit])
    return None


def validate(config: Dict[str, Any]) -> List[str]:
    """Return a list of human-readable schema errors (empty = valid)."""
    errors: List[str] = []
    if not isinstance(config, dict):
        return ["config must be a mapping"]

    serving = config.get("serving")
    if serving is not None:
        _validate_serving(serving, errors)

    # Serving configs describe a deployment, not a training loop: the
    # entrypoint defaults to the serve task and there is no searcher.
    if not config.get("entrypoint") and serving is None:
        errors.append("entrypoint is required")

    searcher = config.get("searcher")
    if not isinstance(searcher, dict):
        if serving is None:
            errors.append("searcher is required")
    else:
        name = searcher.get("name")
        if name not in SEARCHER_NAMES:
            errors.append(f"searcher.name must be one of {sorted(SEARCHER_NAMES)}")
        if name != "custom":
            if not searcher.get("metric"):
                errors.append("searcher.metric is required")
            if _length_units(searcher.get("max_length")) in (None, 0):
                errors.append("searcher.max_length is required (batches)")
        if name == "random" and not searcher.get("max_trials"):
            errors.append("searcher.max_trials is required for random search")
        if name in ("async_halving", "sync_halving"):
            if not searcher.get("num_rungs"):
                errors.append("searcher.num_rungs is required for async_halving")
        if name in ("adaptive_asha", "adaptive", "adaptive_simple"):
            if not searcher.get("max_trials"):
                errors.append("searcher.max_trials is required for adaptive_asha")
        divisor = searcher.get("divisor")
        if divisor is not None and divisor <= 1:
            errors.append("searcher.divisor must be > 1")

    hparams = config.get("hyperparameters", {})
    if not isinstance(hparams, dict):
        errors.append("hyperparameters must be a mapping")
    else:
        for k, v in hparams.items():
            if k == "mesh":
                continue  # the mesh block is not an hparam search space
            _validate_hparam(k, v, errors)
        _validate_mesh(
            hparams.get("mesh"),
            config.get("resources", {}) if isinstance(config.get("resources"), dict)
            else {},
            errors,
        )
        if isinstance(searcher, dict) and searcher.get("name") == "grid":
            def needs_count(spec: Any) -> bool:
                if not _is_hparam_spec(spec):
                    if isinstance(spec, dict):
                        return any(needs_count(v) for v in spec.values())
                    return False
                return spec["type"] in ("int", "double", "log") and not spec.get("count")

            for k, v in hparams.items():
                if needs_count(v):
                    errors.append(
                        f"hyperparameters.{k}: grid search requires `count` on numeric ranges"
                    )

    res = config.get("resources", {})
    if not isinstance(res, dict):
        errors.append("resources must be a mapping")
    else:
        spt = res.get("slots_per_trial", 1)
        if not isinstance(spt, int) or spt < 0:
            errors.append("resources.slots_per_trial must be a non-negative int")
        _validate_elastic(res.get("elastic"), res, errors)

    storage = config.get("checkpoint_storage")
    if storage is not None:
        if not isinstance(storage, dict) or storage.get("type") not in STORAGE_TYPES:
            errors.append(
                f"checkpoint_storage.type must be one of {sorted(STORAGE_TYPES)}"
            )
        elif storage["type"] in ("gcs", "s3") and not storage.get("bucket"):
            errors.append("checkpoint_storage.bucket is required for cloud storage")
        elif storage["type"] == "azure" and not storage.get("container"):
            errors.append("checkpoint_storage.container is required for azure storage")

    mr = config.get("max_restarts")
    if mr is not None and (not isinstance(mr, int) or mr < 0):
        errors.append("max_restarts must be a non-negative int")

    _validate_registry(config.get("registry"), serving, errors)
    _validate_environment(config.get("environment"), errors)
    _validate_log_policies(config.get("log_policies"), errors)
    _validate_preflight(config.get("preflight"), errors)
    _validate_prefetch(config.get("prefetch"), errors)
    _validate_health(config.get("health"), errors)
    _validate_preemption(config.get("preemption"), errors)
    _validate_compile(config.get("compile"), errors)
    _validate_optimizations(config.get("optimizations"), errors)

    return errors


# The TPU meaning of the `optimizations:` block (the torch-era keys —
# aggregation_frequency etc. — are shimmed away; see shim()).
OPTIMIZATION_KEYS = ("attention_impl", "attention_bf16",
                     "overlap_allgather", "prepartition_inputs")
ATTENTION_IMPLS = ("auto", "pallas", "reference", "dense")


def _validate_optimizations(block: Any, errors: List[str]) -> None:
    """`optimizations:` — training-step performance knobs
    (docs/training-perf.md): attention kernel selection, the bf16
    attention path, the one-layer-ahead fsdp all-gather overlap, and
    pre-partitioned step inputs."""
    if block is None:
        return
    if not isinstance(block, dict):
        errors.append("optimizations must be a mapping")
        return
    unknown = sorted(set(block) - set(OPTIMIZATION_KEYS))
    if unknown:
        errors.append(
            f"optimizations: unknown keys {unknown}; valid: "
            f"{', '.join(OPTIMIZATION_KEYS)}")
    impl = block.get("attention_impl")
    if impl is not None and impl not in ATTENTION_IMPLS:
        errors.append(
            f"optimizations.attention_impl {impl!r} must be one of "
            f"{'|'.join(ATTENTION_IMPLS)}")
    for flag in ("attention_bf16", "overlap_allgather",
                 "prepartition_inputs"):
        if flag in block and not isinstance(block[flag], bool):
            errors.append(f"optimizations.{flag} must be a bool")


def _validate_compile(block: Any, errors: List[str]) -> None:
    """`compile:` — the compile farm (docs/compile-farm.md): artifact
    exchange (on by default), background AOT precompilation while trials
    queue (opt-in), and batch-size bucketing so sweeps share executables."""
    if block is None:
        return
    if isinstance(block, bool):
        return  # bare bool == enabled switch
    if not isinstance(block, dict):
        errors.append("compile must be a bool or a mapping")
        return
    valid = {"enabled", "background", "bucket_batch_sizes", "buckets",
             "max_executables", "upload"}
    unknown = sorted(set(block) - valid)
    if unknown:
        errors.append(
            f"compile: unknown keys {unknown}; valid: {sorted(valid)}")
    for flag in ("enabled", "background", "bucket_batch_sizes", "upload"):
        if flag in block and not isinstance(block[flag], bool):
            errors.append(f"compile.{flag} must be a bool")
    me = block.get("max_executables")
    if me is not None and (
        isinstance(me, bool) or not isinstance(me, int) or me < 1
    ):
        errors.append("compile.max_executables must be a positive int")
    buckets = block.get("buckets")
    if buckets is not None:
        if not isinstance(buckets, list) or not buckets or any(
            isinstance(b, bool) or not isinstance(b, int) or b < 1
            for b in buckets
        ):
            errors.append(
                "compile.buckets must be a non-empty list of positive ints")


def _validate_preemption(block: Any, errors: List[str]) -> None:
    """`preemption:` — spot-survival knobs (docs/checkpointing.md): the
    deadline-budgeted emergency checkpoint a trial takes when its node
    receives an infrastructure termination notice."""
    if block is None:
        return
    if isinstance(block, bool):
        return  # bare bool == emergency_checkpoint switch
    if not isinstance(block, dict):
        errors.append("preemption must be a bool or a mapping")
        return
    valid = {"emergency_checkpoint", "budget_safety_factor",
             "budget_margin_sec"}
    unknown = sorted(set(block) - valid)
    if unknown:
        errors.append(
            f"preemption: unknown keys {unknown}; valid: {sorted(valid)}")
    ec = block.get("emergency_checkpoint")
    if ec is not None and not isinstance(ec, bool):
        errors.append("preemption.emergency_checkpoint must be a bool")
    v = block.get("budget_safety_factor")
    if v is not None and (
        isinstance(v, bool) or not isinstance(v, (int, float)) or v < 1
    ):
        errors.append("preemption.budget_safety_factor must be a number >= 1")
    v = block.get("budget_margin_sec")
    if v is not None and (
        isinstance(v, bool) or not isinstance(v, (int, float)) or v < 0
    ):
        errors.append(
            "preemption.budget_margin_sec must be a non-negative number")


def _validate_elastic(block: Any, resources: Dict[str, Any],
                      errors: List[str]) -> None:
    """`resources.elastic:` — elastic re-meshing bounds (docs/elasticity.md).

    An elastic trial's allocation size is a scheduler decision inside
    [min_slots, max_slots]; `slots_per_trial` is the PREFERRED size. On
    capacity loss the scheduler offers a shrink instead of a requeue; on
    idle capacity it grows the trial back (resharding state through the
    declared PartitionSpecs either way)."""
    if block is None:
        return
    if not isinstance(block, dict):
        errors.append("resources.elastic must be a mapping")
        return
    valid = {"min_slots", "max_slots"}
    unknown = sorted(set(block) - valid)
    if unknown:
        errors.append(
            f"resources.elastic: unknown keys {unknown}; valid: "
            f"{sorted(valid)}")
    for key in valid:
        v = block.get(key)
        if v is not None and (
            isinstance(v, bool) or not isinstance(v, int) or v < 1
        ):
            errors.append(f"resources.elastic.{key} must be a positive int")
            return
    mn = block.get("min_slots", 1)
    spt = resources.get("slots_per_trial", 1)
    mx = block.get("max_slots", spt if isinstance(spt, int) else None)
    if isinstance(mn, int) and isinstance(mx, int) and mn > mx:
        errors.append("resources.elastic.min_slots > max_slots")
        return
    if isinstance(spt, int) and spt > 0:
        if isinstance(mn, int) and spt < mn:
            errors.append(
                "resources.slots_per_trial (the preferred size) is below "
                "resources.elastic.min_slots")
        if isinstance(mx, int) and spt > mx:
            errors.append(
                "resources.slots_per_trial (the preferred size) exceeds "
                "resources.elastic.max_slots")


def _validate_health(block: Any, errors: List[str]) -> None:
    """`health:` — the self-healing loop (docs/checkpointing.md): the
    divergence sentinel's on_nan policy and the step watchdog timeout."""
    if block is None:
        return
    if not isinstance(block, dict):
        errors.append("health must be a mapping")
        return
    valid = {"on_nan", "rollback_window", "max_rollbacks", "step_timeout_sec"}
    unknown = sorted(set(block) - valid)
    if unknown:
        errors.append(
            f"health: unknown keys {unknown}; valid: {sorted(valid)}")
    on_nan = block.get("on_nan")
    if on_nan is not None and on_nan not in ("warn", "rollback", "fail"):
        errors.append("health.on_nan must be one of warn|rollback|fail")
    for key in ("rollback_window", "max_rollbacks"):
        v = block.get(key)
        if v is not None and (
            isinstance(v, bool) or not isinstance(v, int) or v < 0
        ):
            errors.append(f"health.{key} must be a non-negative int")
    if block.get("max_rollbacks") == 0:
        errors.append("health.max_rollbacks must be >= 1")
    v = block.get("step_timeout_sec")
    if v is not None and (
        isinstance(v, bool) or not isinstance(v, (int, float)) or v < 0
    ):
        errors.append("health.step_timeout_sec must be a non-negative "
                      "number (0 disables the watchdog)")


def _validate_registry(block: Any, serving: Any,
                       errors: List[str]) -> None:
    """`registry:` — train→serve auto-promotion (docs/serving.md "Model
    lifecycle"): when the experiment COMPLETES, the master registers its
    winning checkpoint as the next version of `model` — the searcher-best
    validation checkpoint (`promote: best`, the default) or the newest
    COMPLETED one (`promote: latest`)."""
    if block is None:
        return
    if not isinstance(block, dict):
        errors.append("registry must be a mapping")
        return
    if serving is not None:
        errors.append(
            "registry: promotion belongs to training configs — a serving "
            "config consumes registered versions, it does not produce "
            "them")
    valid = {"model", "promote"}
    unknown = sorted(set(block) - valid)
    if unknown:
        errors.append(
            f"registry: unknown keys {unknown}; valid: {sorted(valid)}")
    model = block.get("model")
    if not isinstance(model, str) or not model:
        errors.append("registry.model must be a non-empty model name")
    elif ":" in model:
        errors.append(
            "registry.model must be a bare model name (the registry "
            "assigns the version number)")
    promote = block.get("promote")
    if promote is not None and promote not in ("best", "latest"):
        errors.append("registry.promote must be one of: best, latest")


def _validate_serving(block: Any, errors: List[str]) -> None:
    """`serving:` — a `det serve` deployment (docs/serving.md): which
    checkpoint to load, the model family/config to rebuild it into, and
    the continuous-batcher capacity knobs."""
    if not isinstance(block, dict):
        errors.append("serving must be a mapping")
        return
    valid = {"checkpoint", "trial_id", "model", "model_config",
             "max_batch_size", "max_seq_len", "kv_block_size",
             "kv_num_blocks", "prefix_cache", "attention_impl",
             "prefill_buckets", "queue_depth", "port", "seed",
             "stats_log_period_s", "replicas", "heartbeat_period_s",
             "trace_sample", "slo_ms", "warm_aot", "adapters", "canary",
             "model_version"}
    unknown = sorted(set(block) - valid)
    if unknown:
        errors.append(
            f"serving: unknown keys {unknown}; valid: {sorted(valid)}")
    ckpt = block.get("checkpoint")
    if ckpt is not None and not isinstance(ckpt, str):
        errors.append(
            "serving.checkpoint must be a checkpoint storage id or "
            "'latest'")
    model = block.get("model")
    if model is not None and model not in ("gpt2",):
        errors.append("serving.model must be one of: gpt2")
    mc = block.get("model_config")
    if mc is not None and not isinstance(mc, dict):
        errors.append("serving.model_config must be a mapping")
    for key in ("max_batch_size", "max_seq_len", "kv_block_size",
                "kv_num_blocks", "queue_depth"):
        v = block.get(key)
        if v is not None and (
            isinstance(v, bool) or not isinstance(v, int) or v < 1
        ):
            errors.append(f"serving.{key} must be a positive int")
    pc = block.get("prefix_cache")
    if pc is not None and not isinstance(pc, bool):
        errors.append("serving.prefix_cache must be a boolean")
    wa = block.get("warm_aot")
    if wa is not None and not isinstance(wa, bool):
        errors.append("serving.warm_aot must be a boolean")
    impl = block.get("attention_impl")
    if impl is not None and impl not in ("auto", "pallas", "reference",
                                         "dense"):
        errors.append(
            "serving.attention_impl must be one of: auto, pallas, "
            "reference, dense")
    for key in ("trial_id", "port", "seed"):
        v = block.get(key)
        if v is not None and (
            isinstance(v, bool) or not isinstance(v, int) or v < 0
        ):
            errors.append(f"serving.{key} must be a non-negative int")
    buckets = block.get("prefill_buckets")
    if buckets is not None:
        if (not isinstance(buckets, list) or not buckets or any(
                isinstance(b, bool) or not isinstance(b, int) or b < 1
                for b in buckets)):
            errors.append(
                "serving.prefill_buckets must be a non-empty list of "
                "positive ints")
        elif sorted(buckets) != buckets:
            errors.append("serving.prefill_buckets must be ascending")
    hb = block.get("heartbeat_period_s")
    if hb is not None and (
        isinstance(hb, bool) or not isinstance(hb, (int, float)) or hb <= 0
    ):
        errors.append("serving.heartbeat_period_s must be a positive number")
    # Request-path observability (docs/serving.md "Request latency &
    # SLOs"): span sampling fraction + the latency SLO that arms the
    # always-trace-slow path and the master's slow-request ring.
    ts = block.get("trace_sample")
    if ts is not None and (
        isinstance(ts, bool) or not isinstance(ts, (int, float))
        or not 0 <= ts <= 1
    ):
        errors.append("serving.trace_sample must be a number in [0, 1]")
    slo = block.get("slo_ms")
    if slo is not None and (
        isinstance(slo, bool) or not isinstance(slo, (int, float))
        or slo <= 0
    ):
        errors.append("serving.slo_ms must be a positive number")
    mv = block.get("model_version")
    if mv is not None and (not isinstance(mv, str) or not mv):
        errors.append(
            "serving.model_version must be a registry label "
            "('<model>' or '<model>:<version>')")
    _validate_serving_adapters(block.get("adapters"), errors)
    _validate_serving_canary(block.get("canary"), errors)
    _validate_serving_replicas(block.get("replicas"), errors)


def _validate_serving_adapters(adapters: Any, errors: List[str]) -> None:
    """`serving.adapters:` — multi-adapter replicas (docs/serving.md
    "Model lifecycle"): LoRA-style head-delta fine-tunes resident beside
    one base executable, routed per request by `model:` name. Each entry
    names an adapter and the committed checkpoint its weights come from."""
    if adapters is None:
        return
    if not isinstance(adapters, list):
        errors.append(
            "serving.adapters must be a list of {name, checkpoint}")
        return
    seen = set()
    for i, a in enumerate(adapters):
        if not isinstance(a, dict):
            errors.append(
                f"serving.adapters[{i}] must be a mapping with "
                "`name` and `checkpoint`")
            continue
        unknown = sorted(set(a) - {"name", "checkpoint"})
        if unknown:
            errors.append(
                f"serving.adapters[{i}]: unknown keys {unknown}; "
                "valid: name, checkpoint")
        name = a.get("name")
        if not isinstance(name, str) or not name:
            errors.append(
                f"serving.adapters[{i}].name must be a non-empty string")
        elif name in seen:
            # Duplicate names would make per-request `model:` routing
            # ambiguous — which fine-tune did the caller mean?
            errors.append(
                f"serving.adapters[{i}].name {name!r} is a duplicate "
                "(adapter names route requests and must be unique)")
        elif name == "base":
            errors.append(
                "serving.adapters: the name 'base' is reserved for the "
                "deployment's base checkpoint")
        else:
            seen.add(name)
        ck = a.get("checkpoint")
        if not isinstance(ck, str) or not ck:
            errors.append(
                f"serving.adapters[{i}].checkpoint must be a checkpoint "
                "storage id")


def _validate_serving_canary(block: Any, errors: List[str]) -> None:
    """`serving.canary:` — a config-declared canary split (docs/serving.md
    "Model lifecycle"): the deployment starts with `fraction` of traced
    generations routed to `model:version` (or `checkpoint`) replicas.
    The fraction rule is mirrored as DTL208 in native preflight — the
    deployment-create gate enforces it master-side."""
    if block is None:
        return
    if not isinstance(block, dict):
        errors.append("serving.canary must be a mapping")
        return
    valid = {"model", "version", "checkpoint", "fraction", "replicas"}
    unknown = sorted(set(block) - valid)
    if unknown:
        errors.append(
            f"serving.canary: unknown keys {unknown}; "
            f"valid: {sorted(valid)}")
    has_model = isinstance(block.get("model"), str) and block.get("model")
    has_ckpt = (isinstance(block.get("checkpoint"), str)
                and block.get("checkpoint"))
    if not has_model and not has_ckpt:
        errors.append(
            "serving.canary requires `model` (a registry name) or "
            "`checkpoint` (a storage id) naming the canary version")
    v = block.get("version")
    if v is not None and (
        isinstance(v, bool) or not isinstance(v, int) or v < 1
    ):
        errors.append(
            "serving.canary.version must be a positive int "
            "(a registered model version number)")
    if v is not None and not has_model:
        errors.append(
            "serving.canary.version requires `model` (versions are "
            "registry coordinates, not checkpoint ids)")
    frac = block.get("fraction")
    if frac is not None and (
        isinstance(frac, bool) or not isinstance(frac, (int, float))
        or not 0 < frac < 1
    ):
        errors.append(
            "serving.canary.fraction must be strictly inside (0, 1) "
            "(DTL208): 0 routes nothing, 1 is a rolling update")
    reps = block.get("replicas")
    if reps is not None and (
        isinstance(reps, bool) or not isinstance(reps, int) or reps < 1
    ):
        errors.append("serving.canary.replicas must be a positive int")


def _validate_serving_replicas(block: Any, errors: List[str]) -> None:
    """`serving.replicas:` — a deployment (docs/serving.md "Deployments &
    autoscaling"): the master keeps `target` replicas within [min, max],
    and the autoscaler moves target from sustained backpressure / idle
    cooldown when min < max. `min: 0` enables scale-to-zero: an idle
    deployment drains its last replica, and the router's demand wake
    respawns one within `cold_start_budget_s`. `on_demand_floor` replicas
    (default: min) avoid preemptible agents; everything above the floor
    is reclaimable spot surplus."""
    if block is None:
        return
    if not isinstance(block, dict):
        errors.append("serving.replicas must be a mapping")
        return
    valid = {"min", "max", "target", "scale_up_after_s",
             "scale_down_after_s", "scale_up_threshold",
             "scale_down_threshold", "on_demand_floor",
             "cold_start_budget_s"}
    unknown = sorted(set(block) - valid)
    if unknown:
        errors.append(
            f"serving.replicas: unknown keys {unknown}; "
            f"valid: {sorted(valid)}")
    counts = {}
    for key in ("min", "max", "target"):
        v = block.get(key)
        if v is None:
            continue
        if key == "max":
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                errors.append(
                    f"serving.replicas.{key} must be a positive int")
            else:
                counts[key] = v
        elif isinstance(v, bool) or not isinstance(v, int) or v < 0:
            # min: 0 (and target: 0 with it) is scale-to-zero, legal.
            errors.append(
                f"serving.replicas.{key} must be a non-negative int")
        else:
            counts[key] = v
    lo = counts.get("min", 1)
    hi = counts.get("max", max(lo, counts.get("target", lo), 1))
    target = counts.get("target", lo)
    if "min" in counts and "max" in counts and lo > hi:
        errors.append("serving.replicas.min must be <= max")
    elif not (lo <= target <= hi):
        errors.append(
            "serving.replicas.target must be within [min, max]")
    floor = block.get("on_demand_floor")
    if floor is not None:
        if isinstance(floor, bool) or not isinstance(floor, int) or floor < 0:
            errors.append(
                "serving.replicas.on_demand_floor must be a non-negative "
                "int")
        elif "max" in counts and floor > counts["max"]:
            errors.append(
                "serving.replicas.on_demand_floor must be <= max (a floor "
                "above max can never be satisfied)")
    budget = block.get("cold_start_budget_s")
    if budget is not None and (
        isinstance(budget, bool) or not isinstance(budget, (int, float))
        or budget <= 0
    ):
        errors.append(
            "serving.replicas.cold_start_budget_s must be a positive "
            "number")
    for key in ("scale_up_after_s", "scale_down_after_s"):
        v = block.get(key)
        if v is not None and (
            isinstance(v, bool) or not isinstance(v, (int, float)) or v < 0
        ):
            errors.append(
                f"serving.replicas.{key} must be a non-negative number")
    for key in ("scale_up_threshold", "scale_down_threshold"):
        v = block.get(key)
        if v is not None and (
            isinstance(v, bool) or not isinstance(v, (int, float))
            or not 0 < v <= 2
        ):
            errors.append(
                f"serving.replicas.{key} must be in (0, 2] (queue "
                "fraction + batch occupancy)")


def _validate_prefetch(block: Any, errors: List[str]) -> None:
    """`prefetch:` — the async input pipeline (determined_tpu/data): on by
    default; trials opt out or tune the queue depth here."""
    if block is None:
        return
    if isinstance(block, bool):
        return  # bare bool == enabled switch
    if not isinstance(block, dict):
        errors.append("prefetch must be a bool or a mapping")
        return
    unknown = sorted(set(block) - {"enabled", "depth", "shard"})
    if unknown:
        errors.append(
            f"prefetch: unknown keys {unknown}; valid: enabled, depth, shard")
    for flag in ("enabled", "shard"):
        if flag in block and not isinstance(block[flag], bool):
            errors.append(f"prefetch.{flag} must be a bool")
    depth = block.get("depth")
    if depth is not None and (
        isinstance(depth, bool) or not isinstance(depth, int) or depth < 1
    ):
        errors.append("prefetch.depth must be a positive int")


def _validate_preflight(block: Any, errors: List[str]) -> None:
    """`preflight:` — static-analyzer knobs (docs/preflight.md): the
    master-side create gate, config-level rule suppression, and the HBM
    budget that arms DTL004."""
    if block is None:
        return
    if not isinstance(block, dict):
        errors.append("preflight must be a mapping")
        return
    gate = block.get("gate")
    if gate is not None and gate not in ("error", "warn", "off"):
        errors.append("preflight.gate must be one of error|warn|off")
    suppress = block.get("suppress")
    if suppress is not None:
        import re as _re

        if not isinstance(suppress, list):
            errors.append("preflight.suppress must be a list of rule codes")
        else:
            for c in suppress:
                if not isinstance(c, str) or not _re.match(r"^DTL\d{3}$", c):
                    errors.append(
                        f"preflight.suppress entry {c!r} is not a DTLnnn "
                        "rule code")
    hbm = block.get("hbm_gb_per_device")
    if hbm is not None and (
        isinstance(hbm, bool) or not isinstance(hbm, (int, float)) or hbm <= 0
    ):
        errors.append("preflight.hbm_gb_per_device must be a positive number")


def cross_field_diagnostics(config: Dict[str, Any]):
    """The DTL2xx cross-field rules (batch/mesh divisibility, searcher
    budget vs ASHA rungs) as structured diagnostics rather than bare
    exceptions — the same set the native master enforces at experiment
    create (native/master/preflight.cc). Returns a list of
    analysis.Diagnostic."""
    from determined_tpu_torch.analysis import config_rules

    return config_rules.check_config(shim(config))


def _validate_log_policies(policies: Any, errors: List[str]) -> None:
    """`log_policies:` — regex actions on task logs (reference
    logpattern.go + schemas/expconf/v0/log-policy.json):
    [{pattern: regex, action: {type: cancel_retries|exclude_node}}]."""
    if policies is None:
        return
    if not isinstance(policies, list):
        errors.append("log_policies must be a list")
        return
    import re as _re

    for i, p in enumerate(policies):
        if not isinstance(p, dict) or not isinstance(p.get("pattern"), str):
            errors.append(f"log_policies[{i}]: requires a `pattern` string")
            continue
        try:
            _re.compile(p["pattern"])
        except _re.error as e:
            errors.append(f"log_policies[{i}].pattern: invalid regex: {e}")
        else:
            # The master matches with ECMAScript std::regex: python-only
            # constructs (named groups, inline flags) would be silently
            # inert there — reject them at submit time. (?: (?= (?! are
            # fine in both dialects.
            if _re.search(r"\(\?(?![:=!])", p["pattern"]):
                errors.append(
                    f"log_policies[{i}].pattern: named groups / inline "
                    "flags are not supported by the master's regex engine"
                )
        action = p.get("action")
        atype = action.get("type") if isinstance(action, dict) else action
        if atype not in ("cancel_retries", "exclude_node"):
            errors.append(
                f"log_policies[{i}].action.type must be cancel_retries or "
                "exclude_node"
            )


def _validate_environment(envcfg: Any, errors: List[str]) -> None:
    """`environment:` block (reference task-spec env rendering,
    master/pkg/tasks/task.go:194-234): flat "K": "V" pairs and/or
    environment_variables ["K=V", ...], plus TPU-native `venv` (interpreter
    activation) and `python_path` (extra package roots)."""
    if envcfg is None:
        return
    if not isinstance(envcfg, dict):
        errors.append("environment must be a mapping")
        return
    ev = envcfg.get("environment_variables")
    if ev is not None:
        if not isinstance(ev, list):
            errors.append("environment.environment_variables must be a list")
        else:
            for kv in ev:
                if not isinstance(kv, str) or "=" not in kv:
                    errors.append(
                        f"environment.environment_variables entry {kv!r} "
                        "must be a 'KEY=value' string"
                    )
    venv = envcfg.get("venv")
    if venv is not None and not isinstance(venv, str):
        errors.append("environment.venv must be a path string")
    pp = envcfg.get("python_path")
    if pp is not None and (
        not isinstance(pp, list) or not all(isinstance(p, str) for p in pp)
    ):
        errors.append("environment.python_path must be a list of path strings")
    for k, v in envcfg.items():
        if k in ("environment_variables", "venv", "python_path"):
            continue
        if not isinstance(v, str):
            errors.append(
                f"environment.{k}: flat entries are env vars and must be "
                "strings"
            )


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


def apply_defaults(config: Dict[str, Any]) -> Dict[str, Any]:
    """Fill schema defaults (reference: WithDefaults code-gen)."""
    c = copy.deepcopy(config)
    c.setdefault("name", "unnamed-experiment")
    c.setdefault("description", "")
    c.setdefault("labels", [])
    c.setdefault("hyperparameters", {})
    c.setdefault("max_restarts", 5)
    c.setdefault("scheduling_unit", 100)
    c.setdefault("records_per_epoch", 0)
    c.setdefault("min_validation_period", {"batches": 0})
    c.setdefault("min_checkpoint_period", {"batches": 0})
    c.setdefault("perform_initial_validation", False)
    res = c.setdefault("resources", {})
    res.setdefault("slots_per_trial", 1)
    res.setdefault("resource_pool", "default")
    res.setdefault("priority", 42)
    if isinstance(res.get("elastic"), dict):
        el = res["elastic"]
        el.setdefault("min_slots", 1)
        el.setdefault("max_slots", res["slots_per_trial"])
    if isinstance(c.get("serving"), dict):
        s = c["serving"]
        s.setdefault("checkpoint", "latest")
        s.setdefault("model", "gpt2")
        s.setdefault("max_batch_size", 8)
        s.setdefault("max_seq_len", 256)
        s.setdefault("kv_block_size", 16)
        s.setdefault("prefix_cache", True)
        s.setdefault("attention_impl", "auto")
        s.setdefault("queue_depth", 64)
        if isinstance(s.get("replicas"), dict):
            rep = s["replicas"]
            rep.setdefault("min", 1)
            rep.setdefault("target", rep["min"])
            # max must stay >= 1 even under min: 0 (scale-to-zero).
            rep.setdefault("max", max(rep["min"], rep["target"], 1))
        if isinstance(s.get("canary"), dict):
            cb = s["canary"]
            cb.setdefault("fraction", 0.05)
            cb.setdefault("replicas", 1)
        # No searcher/validation machinery for a deployment config.
        return c
    if isinstance(c.get("registry"), dict):
        c["registry"].setdefault("promote", "best")
    searcher = c.setdefault("searcher", {})
    searcher.setdefault("smaller_is_better", True)
    name = searcher.get("name")
    if name in ("async_halving", "sync_halving", "adaptive_asha", "adaptive",
                "adaptive_simple"):
        searcher.setdefault("divisor", 4)
        searcher.setdefault("mode", "standard")
        if name in ("async_halving", "sync_halving"):
            searcher.setdefault("num_rungs", 5)
        else:
            searcher.setdefault("max_rungs", 5)
    if name in ("random", "adaptive_asha", "adaptive", "adaptive_simple",
                "async_halving"):
        mt = searcher.get("max_trials", 16)
        searcher.setdefault("max_trials", mt)
        searcher.setdefault("max_concurrent_trials", min(mt, 16))
    c.setdefault("reproducibility", {})
    c.setdefault("environment", {})
    c.setdefault("profiling", {"enabled": False})
    pf = c.setdefault("prefetch", {})
    if isinstance(pf, dict):
        pf.setdefault("enabled", True)
        pf.setdefault("depth", 2)
    cc = c.setdefault("compile", {})
    if isinstance(cc, dict):
        cc.setdefault("enabled", True)
        cc.setdefault("background", False)
        cc.setdefault("bucket_batch_sizes", False)
        cc.setdefault("max_executables", 8)
        cc.setdefault("upload", True)
    opt = c.setdefault("optimizations", {})
    if isinstance(opt, dict):
        opt.setdefault("attention_impl", "auto")
        opt.setdefault("attention_bf16", False)
        opt.setdefault("overlap_allgather", False)
        opt.setdefault("prepartition_inputs", True)
    health = c.setdefault("health", {})
    if isinstance(health, dict):
        health.setdefault("on_nan", "warn")
        health.setdefault("rollback_window", 8)
        health.setdefault("max_rollbacks", 3)
        health.setdefault("step_timeout_sec", 0)
    pre = c.setdefault("preemption", {})
    if isinstance(pre, dict):
        pre.setdefault("emergency_checkpoint", True)
        pre.setdefault("budget_safety_factor", 1.5)
        pre.setdefault("budget_margin_sec", 2.0)
    return c


def merge(config: Dict[str, Any], defaults: Dict[str, Any]) -> Dict[str, Any]:
    """Merge cluster-level defaults under the user config (reference:
    task_container_defaults merging in pkg/schemas/expconf/merge logic).
    User values win; dicts merge recursively; lists replace."""
    out = copy.deepcopy(defaults)

    def _merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                _merge(dst[k], v)
            else:
                dst[k] = copy.deepcopy(v)

    _merge(out, config)
    return out


def check(config: Dict[str, Any]) -> Dict[str, Any]:
    """shim + validate + defaults; raises ValueError with all errors."""
    config = shim(config)
    errors = validate(config)
    if errors:
        raise ValueError("invalid experiment config:\n  " + "\n  ".join(errors))
    return apply_defaults(config)
