"""Single source of truth for every exported metric and span name.

Counterpart of determined_tpu/common/metric_names.py, copied whole: the
port's emitters (serve/http.py, serve/tracing.py, train/trainer.py,
core/_checkpoint.py) must publish exactly these names, as the JAX
package's do, and determined_tpu_torch/analysis/metric_lint.py checks it.

The master (C++), agent (C++), serving replicas (Python) and the harness
all publish observability data; this registry is what keeps them from
drifting apart on the same gauge (docs/observability.md). `make lint`
runs determined_tpu/analysis/metric_lint.py, which checks BOTH directions:

  - every `det_*` metric name and every span name emitted anywhere in the
    scanned sources must be registered here, and
  - every registered name must still be emitted somewhere (a stale
    registry row is drift too).

Naming rules (enforced by the lint):
  - metric names: snake_case, `det_` prefix; counters end `_total`;
    time/size-bearing names carry a unit suffix (`_seconds`, `_ms`,
    `_us`, `_bytes`, `_lines`);
  - span names: lowercase dot-separated segments
    (`component.phase[.subphase]`).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

# name -> (prometheus type, help)
MASTER_METRICS: Dict[str, Tuple[str, str]] = {
    "det_agents_alive": ("gauge", "Agents with a live heartbeat"),
    "det_slots_total": ("gauge", "Slots on alive agents"),
    "det_slots_free": ("gauge", "Enabled, unallocated slots on alive agents"),
    "det_slots_allocated": ("gauge", "Slots bound to an allocation"),
    "det_slots_draining": ("gauge", "Slots on DRAINING agents"),
    "det_scheduler_queue_depth": ("gauge", "Allocations waiting for resources"),
    "det_scheduler_queue_wait_seconds": (
        "histogram", "Submit-to-placement wait per allocation"),
    "det_allocations": ("gauge", "Allocations by state"),
    "det_experiments": ("gauge", "Experiments by state"),
    "det_preemptions_total": ("counter", "Allocation preemptions issued"),
    "det_resizes_total": ("counter", "Elastic allocation-size transitions"),
    "det_trial_requeues_total": (
        "counter", "Trial container restarts re-queued by the master"),
    "det_idempotency_replays_total": (
        "counter", "POSTs answered from the idempotency replay cache"),
    "det_stream_backlog_events": (
        "gauge", "Entity-change events buffered for /api/v1/stream"),
    "det_trial_spans_ingested_total": (
        "counter", "Trace spans accepted by POST /trials/{id}/spans"),
    "det_compile_jobs": (
        "gauge", "Compile-farm AOT jobs by state (docs/compile-farm.md)"),
    "det_compile_artifact_uploads_total": (
        "counter", "Compile-artifact batches stored by POST /compile_cache"),
    "det_compile_artifact_fetches_total": (
        "counter", "Compile-artifact fetches served by GET /compile_cache"),
    "det_compile_links_total": (
        "counter", "Fingerprint-verified executable shares between "
                   "signatures"),
    "det_deployment_replicas": (
        "gauge", "Serving-deployment replicas by state "
                 "(ready/starting/draining; docs/serving.md)"),
    "det_deployment_target_replicas": (
        "gauge", "Replica count the deployment controller is steering to"),
    "det_deployment_scale_events_total": (
        "counter", "Autoscaler/manual deployment scale decisions by "
                   "direction"),
    "det_serve_router_retries_total": (
        "counter", "Requests retried onto another replica after a "
                   "connection refusal"),
    "det_serve_router_ejections_total": (
        "counter", "Replica circuit-breaker ejections by the serve router"),
    "det_serve_request_seconds": (
        "histogram", "End-to-end serving request latency per deployment, "
        "merged from fresh replica heartbeats (docs/serving.md 'Request "
        "latency & SLOs')"),
    "det_request_spans_ingested_total": (
        "counter", "Serving request spans accepted by "
        "POST /allocations/{id}/request_spans"),
    "det_serve_slo_breaches_total": (
        "counter", "Routed generations whose wall time exceeded the "
        "deployment's serving.slo_ms"),
    "det_serve_cold_starts_total": (
        "counter", "Scale-from-zero demand wakes: the router bumped a "
        "deployment's target 0 -> 1 and held the request "
        "(docs/serving.md 'Scale to zero')"),
    "det_deployment_swaps_total": (
        "counter", "Completed rolling weight swaps: every serving "
        "replica reached the updated model version "
        "(docs/serving.md 'Model lifecycle')"),
    "det_model_versions_registered_total": (
        "counter", "Model versions registered (API registration + "
        "registry: auto-promotion on experiment completion)"),
    "det_serve_canary_requests_total": (
        "counter", "Routed generations by version group "
        "(canary/stable) per deployment while a canary split is active"),
    "det_provisioner_demand_slots": (
        "gauge", "Composed provisioner demand by pool and source "
        "(pending/elastic/serving/compile; docs/cluster-ops.md "
        "'Capacity loop')"),
    "det_provisioner_nodes": (
        "gauge", "Provisioner-managed cloud nodes by pool and state "
        "(CREATING/READY/DELETING)"),
    "det_provisioner_create_failures_total": (
        "counter", "Cloud node-create failures (each arms the per-pool "
        "exponential backoff)"),
    "det_api_requests_total": ("counter", "API requests by status code"),
    "det_api_request_seconds": (
        "histogram", "API request latency by route family"),
    "det_fenced_writes_total": (
        "counter", "State-mutating API calls rejected with 409 because the "
        "caller's X-Allocation-Epoch was superseded, by route "
        "(docs/cluster-ops.md 'Leases, fencing & split-brain'). Nonzero "
        "without a partition event means a zombie writer survived "
        "reassignment"),
    "det_lease_expirations_total": (
        "counter", "Agent ownership leases that lapsed without a heartbeat "
        "renewal; the agent is expected to have self-fenced its tasks"),
    "det_master_db_tx_total": (
        "counter", "Explicit DB transactions opened (BEGIN IMMEDIATE). The "
        "group-commit bench gates on the COUNTED ratio of this with "
        "batching on vs off (docs/cluster-ops.md 'Overload, quotas & "
        "fair use')"),
    "det_master_write_queue_depth": (
        "gauge", "Writes parked in the group-commit queue awaiting the "
        "next flush; at queue_cap new writes get 429 + Retry-After"),
    "det_master_write_batch_events": (
        "histogram", "Writes coalesced per group-commit flush (batch "
        "size distribution; 1 everywhere means batching is buying "
        "nothing)"),
    "det_master_write_flush_seconds": (
        "histogram", "Group-commit flush transaction latency — the "
        "brownout controller's 'DB write latency' signal"),
    "det_master_shed_total": (
        "counter", "Interactive requests shed with the brownout 503 by "
        "route family; trial-critical families NEVER appear here"),
    "det_rate_limited_total": (
        "counter", "Requests refused with 429 by the per-tenant token "
        "bucket, labeled by the charged principal"),
}

AGENT_METRICS: Dict[str, Tuple[str, str]] = {
    "det_agent_slots": ("gauge", "Slots this agent registered"),
    "det_agent_tasks": ("gauge", "Supervised tasks by state"),
    "det_agent_log_backlog_lines": (
        "gauge", "Task-log lines queued or in flight to the master"),
    "det_agent_draining": (
        "gauge", "1 after a termination notice was posted, else 0"),
    "det_agent_lease_remaining_seconds": (
        "gauge", "Seconds until this agent's ownership lease lapses and it "
        "self-fences its tasks (renewed by every heartbeat ack; "
        "docs/cluster-ops.md 'Leases, fencing & split-brain')"),
    "det_agent_uptime_seconds": ("gauge", "Seconds since the agent started"),
}

SERVE_METRICS: Dict[str, Tuple[str, str]] = {
    "det_serve_queue_depth": ("gauge", "Admission-queue depth"),
    "det_serve_active_requests": ("gauge", "Requests joined into the batch"),
    "det_serve_kv_blocks_free": ("gauge", "Free KV cache blocks"),
    "det_serve_kv_blocks_used": ("gauge", "KV cache blocks held by "
                                 "admitted sequences (paged layout)"),
    "det_serve_kv_blocks_total": ("gauge", "Total KV cache blocks"),
    "det_serve_prefix_cache_hit_rate": (
        "gauge", "Prompt tokens served from cached prefix blocks / prompt "
        "tokens seen (docs/serving.md 'Paged KV & prefix caching')"),
    "det_serve_requests_total": ("counter", "Requests completed"),
    "det_serve_tokens_total": ("counter", "Tokens generated"),
    "det_serve_draining": ("gauge", "1 while draining, else 0"),
    # Token-latency SLO histograms (docs/serving.md "Request latency &
    # SLOs") — also on the replica heartbeat, aggregated per deployment.
    "det_serve_ttft_seconds": (
        "histogram", "Submit to first generated token, per request"),
    "det_serve_tpot_seconds": (
        "histogram", "Mean inter-token interval per request "
        "(time-per-output-token)"),
    "det_serve_e2e_seconds": (
        "histogram", "Submit to final token, per request"),
    "det_serve_queue_wait_seconds": (
        "histogram", "Submit to batch admission, per request"),
}

# span name -> (emitting component, help)
SPAN_NAMES: Dict[str, Tuple[str, str]] = {
    "trial.lifecycle": (
        "master", "Root span: trial submit to terminal state"),
    "trial.queue_wait": (
        "master", "Allocation submit to placement (per container run)"),
    "agent.image_setup": (
        "agent", "Workdir + log-file preparation before fork"),
    "agent.container_start": (
        "agent", "Fork to the RUNNING report"),
    "agent.log_drain": (
        "agent", "Final log drain before the exit report"),
    "agent.cache_warm": (
        "agent", "Compile-farm artifact prefetch, overlapped with image "
                 "setup"),
    "agent.lease": (
        "agent", "Ownership-lease lapse to self-fence kill on a partitioned "
        "agent; lease_ttl_s and container_id in attrs (best-effort: lost "
        "when the partition is real, delivered in chaos runs)"),
    "harness.compile": (
        "harness", "First executable acquisition (AOT load or "
                   "trace+compile); cache_hit/signature/attention_impl "
                   "in attrs"),
    "harness.restore": (
        "harness", "Checkpoint restore (lineage walk included)"),
    "harness.reshard": (
        "harness", "Elastic in-process re-mesh: rebuild + resharding restore"),
    "harness.validate": (
        "harness", "One validation pass"),
    "harness.checkpoint.save": (
        "harness", "Checkpoint phase 1: synchronous orbax save portion"),
    "harness.checkpoint.commit": (
        "harness", "Checkpoint phase 2: manifest + COMMIT + COMPLETED report"),
    "harness.checkpoint.emergency": (
        "harness", "Deadline-budgeted emergency checkpoint on preemption"),
    "harness.resize.downtime": (
        "harness", "Resize signal to first post-resize readiness"),
    # Serving request-path spans (docs/observability.md "Request spans"):
    # one trace per served request, trace id == X-Request-Id.
    "serve.request": (
        "serve", "Root span: request submit to finish on the replica "
        "(span_id == request id)"),
    "serve.queue_wait": (
        "serve", "Admission-queue wait: submit to batch join"),
    "serve.prefill": (
        "serve", "Prompt prefill; bucket/suffix_len/prefix_cache_hit/"
        "blocks in attrs"),
    "serve.decode": (
        "serve", "Token generation: first token to finish; tokens/steps/"
        "occupancy_at_admit in attrs"),
    "serve.router.dispatch": (
        "master", "One router forward attempt: replica chosen, retries, "
        "breaker state in attrs (a retried request shows two)"),
    "serve.cold_start": (
        "master", "Scale-from-zero hold: how long the router parked the "
        "waking request and whether the replica's engine deserialized "
        "(warm AOT) or traced — wait_ms/budget_s/replica/engine_source "
        "in attrs"),
    "serve.swap": (
        "master", "One rolling weight swap, update to last stale "
        "replica drained — from/to versions and replicas_swapped in "
        "attrs (docs/serving.md 'Model lifecycle')"),
}

_METRIC_RE = re.compile(r"^det(_[a-z0-9]+)+$")
_SPAN_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")
_UNIT_SUFFIXES = ("_total", "_seconds", "_ms", "_us", "_bytes", "_lines",
                  "_events", "_depth", "_requests")
# Words that imply a measured quantity and therefore REQUIRE a unit suffix.
_UNIT_WORDS = ("seconds", "latency", "duration", "wait", "size", "backlog",
               "uptime")


def all_metrics() -> Dict[str, Tuple[str, str]]:
    out: Dict[str, Tuple[str, str]] = {}
    out.update(MASTER_METRICS)
    out.update(AGENT_METRICS)
    out.update(SERVE_METRICS)
    return out


def check_registry() -> list:
    """Self-consistency: names conform to the naming rules. Returns a list
    of violation strings (empty = clean)."""
    problems = []
    for name, (mtype, _) in all_metrics().items():
        if not _METRIC_RE.match(name):
            problems.append(f"metric {name!r}: not snake_case det_*")
        if mtype == "counter" and not name.endswith("_total"):
            problems.append(f"counter {name!r}: must end in _total")
        if any(w in name for w in _UNIT_WORDS) and not name.endswith(
                _UNIT_SUFFIXES):
            problems.append(
                f"metric {name!r}: measured quantity without a unit suffix "
                f"({'/'.join(_UNIT_SUFFIXES)})")
    for name in SPAN_NAMES:
        if not _SPAN_RE.match(name):
            problems.append(
                f"span {name!r}: must be lowercase dot-separated segments")
    return problems
