"""The DTL rule registry.

Counterpart of determined_tpu/analysis/rules.py: the same codes, names,
levels and engines, with the summaries of the AST rules (DTL1xx) said for
the port's traps. Code ranges by engine:
  DTL0xx — abstract trace (the trial's state and forward loss on the meta
           device, under the declared mesh)
  DTL1xx — AST lint of trial / model-def source
  DTL2xx — experiment-config cross-field checks (the JAX package's, which
           the native master also enforces at experiment create)

Levels: "error" rules describe trials that will waste or exhaust device
memory or step time with certainty; "warning" rules describe
likely-but-not-certain problems. A gate hard-fails only error-level rules,
and only when the experiment config opts in (`preflight: {gate: error}`).

Every rule is suppressible:
  - per line (AST rules):   `# det: noqa[DTL101]`  or  `# det: noqa`
  - per experiment config:  `preflight: {suppress: [DTL002, ...]}`
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from determined_tpu_torch.analysis.diagnostics import Diagnostic


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    level: str  # default level: "error" | "warning"
    engine: str  # "abstract" | "ast" | "config"
    summary: str

    def diag(self, message: str, **kw) -> Diagnostic:
        return Diagnostic(code=self.code, message=message, level=self.level,
                          engine=self.engine, **kw)


_ALL = [
    # -- engine 1: abstract trace ---------------------------------------
    Rule("DTL001", "state-not-donated", "error", "abstract",
         "train state is not donated to the jitted step (JAX package). The "
         "port never raises it: its step updates params and optimizer "
         "state in place (train/state.py `apply_gradients`), so there is "
         "no second copy to count and donation_extra_bytes is 0"),
    Rule("DTL002", "implicit-replication", "warning", "abstract",
         "a large parameter leaf has no sharded dimension under the declared "
         "mesh and is fully replicated on every device"),
    Rule("DTL003", "batch-mesh-mismatch", "error", "abstract",
         "the global batch produced by the data loader is not divisible by "
         "the mesh's batch (data x fsdp) axes; the ranks cannot hold equal "
         "blocks of it"),
    Rule("DTL004", "hbm-over-budget", "error", "abstract",
         "the estimated per-device memory lower bound (params + optimizer "
         "state + grads + batch) exceeds the configured per-device budget"),
    Rule("DTL005", "abstract-trace-failed", "warning", "abstract",
         "the train state or the forward loss could not be traced on the "
         "meta device (a host read of a device value, a shape that depends "
         "on the data, a kernel route without a meta implementation); "
         "memory and sharding analysis is incomplete"),
    # -- engine 2: AST lint ---------------------------------------------
    Rule("DTL101", "host-sync-in-step", "error", "ast",
         "host synchronization inside a step function (.item() / .cpu() / "
         ".tolist() / .numpy(), float()/int()/bool() on a tensor, "
         "torch.cuda.synchronize()): stalls the eager step every call, and "
         "breaks a step captured as a CUDA graph (make_multi_step)"),
    Rule("DTL102", "python-rng-in-step", "warning", "ast",
         "Python / numpy RNG inside a step function: make_multi_step "
         "captures the step once, so the value drawn at capture replays "
         "every step — draw with torch and the step's generator"),
    Rule("DTL103", "wall-clock-in-step", "warning", "ast",
         "wall-clock read inside a step function: the value read at "
         "make_multi_step's capture replays every step"),
    Rule("DTL104", "shape-branch-in-step", "warning", "ast",
         "Python branching on shapes inside a step function: the branch "
         "taken at capture is frozen into the CUDA graph, and each "
         "distinct shape costs make_multi_step a capture of its own"),
    Rule("DTL105", "device-transfer-in-data-loader", "warning", "ast",
         "build_training_data / build_validation_data moves batches to the "
         "device itself (.to('cuda') / .cuda()): the port's "
         "DevicePrefetcher already copies each host batch to the device "
         "(pinned, on its own stream), so the loader's copy is paid twice "
         "— yield host (numpy or CPU tensor) batches, or disable prefetch "
         "for this trial"),
    Rule("DTL106", "thread-stop-shadowing", "error", "ast",
         "a threading.Thread subclass defines an attribute, Event or method "
         "named `_stop`: CPython's Thread uses self._stop() internally "
         "(join / _wait_for_tstate_lock call it on thread exit), so "
         "shadowing it with an Event raises `TypeError: 'Event' object is "
         "not callable` when the thread finishes — name the flag "
         "`_stop_evt` (the convention used by core/_profiler.py and "
         "core/_preempt.py) instead"),
    Rule("DTL107", "hand-rolled-attention-in-trial", "warning", "ast",
         "trial code computes attention itself (a softmax(q @ k^T) @ v "
         "chain, or F.scaled_dot_product_attention) inside a step "
         "function of the trial: either route bypasses the "
         "`optimizations.attention_impl` knob and the hand-written flash "
         "kernels (ops/csrc/flash_attention.cu), so platform attention "
         "A/Bs silently measure nothing — route attention through the "
         "model library (ops/flash_attention.flash_attention) or suppress "
         "if the softmax is not attention"),
    # -- config cross-field checks --------------------------------------
    Rule("DTL201", "config-batch-mesh-mismatch", "error", "config",
         "hyperparameters.global_batch_size is not divisible by the mesh's "
         "batch (data x fsdp) axes resolved against resources.slots_per_trial"),
    Rule("DTL202", "searcher-budget-rungs", "error", "config",
         "searcher.max_length cannot populate the configured ASHA rungs "
         "(max_length < divisor^(num_rungs-1)); top rungs would be "
         "unreachable and the search degenerates"),
    Rule("DTL203", "restarts-without-checkpoints", "warning", "config",
         "min_checkpoint_period is explicitly 0 (op-boundary checkpoints "
         "only) while max_restarts > 0: a mid-op failure restarts from the "
         "previous op boundary or from scratch — restarts are configured "
         "but there is nothing recent to restart from"),
    Rule("DTL204", "elastic-size-infeasible", "error", "config",
         "an elastic config (resources.elastic) must be runnable at EVERY "
         "slot count in [min_slots, max_slots]: the mesh must resolve, "
         "global_batch_size must divide over the batch axes, and the "
         "per-device memory footprint must fit the budget at each size — a "
         "size that fails only surfaces mid-drain, exactly when the "
         "scheduler tries to shrink onto surviving capacity"),
    Rule("DTL205", "unbucketed-shape-sweep", "warning", "config",
         "the searcher sweeps shape-affecting hyperparameters (e.g. raw "
         "global_batch_size sampling) into more distinct executables than "
         "compile.max_executables: every distinct shape pays a compile "
         "(a CUDA graph capture on the port) and defeats sharing across "
         "the sweep — bucket batch sizes (compile.bucket_batch_sizes), "
         "sample fewer distinct shape values, or raise "
         "compile.max_executables if the compile cost is intended"),
    Rule("DTL206", "serving-kv-geometry", "error", "config",
         "a serving config's paged KV geometry is unusable: kv_block_size "
         "must divide max_seq_len (the block tables tile max_seq_len "
         "exactly), and an explicit kv_num_blocks must give the pool room "
         "for at least one max_seq_len sequence — otherwise the replica "
         "fails at engine startup (or requests can never be admitted) "
         "instead of at config time"),
    Rule("DTL207", "serving-capacity-knobs", "error", "config",
         "a deployment's capacity-loop knobs are unsatisfiable "
         "(docs/cluster-ops.md 'Capacity loop'): serving.replicas.min "
         "must be >= 0 (0 = scale-to-zero) and <= max, "
         "on_demand_floor must fit within [0, max] (a floor above max "
         "can never be met), and cold_start_budget_s must be a positive "
         "number — it bounds how long the router holds a request while a "
         "scale-from-zero replica restores"),
    Rule("DTL208", "serving-canary-fraction", "error", "config",
         "a config-declared canary split (serving.canary) must carry a "
         "traffic fraction strictly inside (0, 1): 0 routes nothing to "
         "the canary (it burns a replica for no signal) and 1 is a full "
         "rollout that should be a rolling update instead — the router's "
         "deterministic debt split is only meaningful for a real "
         "fraction (docs/serving.md 'Model lifecycle')"),
]

RULES: Dict[str, Rule] = {r.code: r for r in _ALL}


def get(code: str) -> Rule:
    return RULES[code]
