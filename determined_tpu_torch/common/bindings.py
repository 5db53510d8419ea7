"""The port's copy of determined_tpu/common/bindings.py, which
proto/gen_client.py generates from proto/openapi.json: one method per REST
operation over the port's `common.api.Session`. Path params are
positional, query params via `params=`, request bodies via `body=`.
tests/test_torch_client.py holds every method to the generated file's and
every call to the same (method, path, params, body).
"""

from typing import Any, Dict, Optional

from determined_tpu_torch.common.api import Session


class Bindings:
    """Typed surface over a Session (reference bindings.py role)."""

    def __init__(self, session: Session):
        self._session = session

    def get_agents(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/agents — List agents and slots"""
        return self._session.get("/api/v1/agents", params=params, timeout=timeout)

    def post_agents_register(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/agents/register — Agent registration (agent service account)"""
        return self._session.post("/api/v1/agents/register", body=body, params=params)

    def get_agents_id_actions(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/agents/{id}/actions — Agent action long-poll (agent service account)"""
        return self._session.get(f"/api/v1/agents/{id}/actions", params=params, timeout=timeout)

    def post_agents_id_allocations_aid_state(self, id: Any, aid: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/agents/{id}/allocations/{aid}/state — Report a container state change (agent service account)"""
        return self._session.post(f"/api/v1/agents/{id}/allocations/{aid}/state", body=body, params=params)

    def post_agents_id_disable(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/agents/{id}/disable — Drain: disable slots (admin)"""
        return self._session.post(f"/api/v1/agents/{id}/disable", body=body, params=params)

    def post_agents_id_enable(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/agents/{id}/enable — Enable slots (admin)"""
        return self._session.post(f"/api/v1/agents/{id}/enable", body=body, params=params)

    def post_agents_id_heartbeat(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/agents/{id}/heartbeat — Agent heartbeat + reconcile (agent service account)"""
        return self._session.post(f"/api/v1/agents/{id}/heartbeat", body=body, params=params)

    def post_agents_id_preempt_notice(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/agents/{id}/preempt_notice — Infrastructure termination notice: mark the agent DRAINING and push a deadline preemption to its allocations (agent service account)"""
        return self._session.post(f"/api/v1/agents/{id}/preempt_notice", body=body, params=params)

    def get_allocations_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/allocations/{id} — Introspect"""
        return self._session.get(f"/api/v1/allocations/{id}", params=params, timeout=timeout)

    def post_allocations_id_all_gather(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/allocations/{id}/all_gather — REST-level allgather barrier"""
        return self._session.post(f"/api/v1/allocations/{id}/all_gather", body=body, params=params)

    def post_allocations_id_exit_reason(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/allocations/{id}/exit_reason — Task names the cause of its imminent nonzero exit (step watchdog, divergence fail-stop)"""
        return self._session.post(f"/api/v1/allocations/{id}/exit_reason", body=body, params=params)

    def post_allocations_id_proxy_address(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/allocations/{id}/proxy_address — Register the task's proxy target (owner/agent)"""
        return self._session.post(f"/api/v1/allocations/{id}/proxy_address", body=body, params=params)

    def post_allocations_id_ready(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/allocations/{id}/ready — NotifyContainerRunning analogue"""
        return self._session.post(f"/api/v1/allocations/{id}/ready", body=body, params=params)

    def get_allocations_id_rendezvous(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/allocations/{id}/rendezvous — Block until all hosts are up; returns ranked addresses"""
        return self._session.get(f"/api/v1/allocations/{id}/rendezvous", params=params, timeout=timeout)

    def post_allocations_id_request_spans(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/allocations/{id}/request_spans — Serving request-span batch from a replica (serve.request/queue_wait/prefill/decode; trace id = X-Request-Id)"""
        return self._session.post(f"/api/v1/allocations/{id}/request_spans", body=body, params=params)

    def post_allocations_id_serve_stats(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/allocations/{id}/serve_stats — Serving-replica heartbeat: queue depth + occupancy + drain state + token-latency histograms (the router's least-loaded signal, the autoscaler's input, the deployment p50/p99 source)"""
        return self._session.post(f"/api/v1/allocations/{id}/serve_stats", body=body, params=params)

    def post_allocations_id_signals_ack_preemption(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/allocations/{id}/signals/ack_preemption — Ack preemption before checkpointing"""
        return self._session.post(f"/api/v1/allocations/{id}/signals/ack_preemption", body=body, params=params)

    def get_allocations_id_signals_preemption(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/allocations/{id}/signals/preemption — Preemption long-poll; elastic resize offers ride the same signal as {resize, target_slots, deadline_seconds}"""
        return self._session.get(f"/api/v1/allocations/{id}/signals/preemption", params=params, timeout=timeout)

    def get_allocations_id_size_history(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/allocations/{id}/size_history — Elastic allocation-size transitions (shrink on drain, grow-back), oldest first"""
        return self._session.get(f"/api/v1/allocations/{id}/size_history", params=params, timeout=timeout)

    def post_auth_login(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/auth/login — Log in; returns a bearer token"""
        return self._session.post("/api/v1/auth/login", body=body, params=params)

    def post_auth_logout(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/auth/logout — Invalidate the current token"""
        return self._session.post("/api/v1/auth/logout", body=body, params=params)

    def patch_checkpoints(self, *, body: Optional[Dict[str, Any]] = None) -> Any:
        """PATCH /api/v1/checkpoints — Batch state updates (GC)"""
        return self._session.patch("/api/v1/checkpoints", body=body)

    def post_checkpoints(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/checkpoints — Report checkpoint"""
        return self._session.post("/api/v1/checkpoints", body=body, params=params)

    def get_checkpoints_uuid(self, uuid: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/checkpoints/{uuid} — Get checkpoint"""
        return self._session.get(f"/api/v1/checkpoints/{uuid}", params=params, timeout=timeout)

    def get_commands(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/commands — List commands"""
        return self._session.get("/api/v1/commands", params=params, timeout=timeout)

    def post_commands(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/commands — Launch a command task (config.entrypoint/resources/environment/idle_timeout_s)"""
        return self._session.post("/api/v1/commands", body=body, params=params)

    def get_commands_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/commands/{id} — Get task"""
        return self._session.get(f"/api/v1/commands/{id}", params=params, timeout=timeout)

    def post_commands_id_kill(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/commands/{id}/kill — Kill (propagates down the task tree)"""
        return self._session.post(f"/api/v1/commands/{id}/kill", body=body, params=params)

    def get_compile_cache_signature(self, signature: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/compile_cache/{signature} — Fetch a signature's precompiled artifacts (?name= filters; agents pre-warm from this before a container starts)"""
        return self._session.get(f"/api/v1/compile_cache/{signature}", params=params, timeout=timeout)

    def post_compile_cache_signature(self, signature: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/compile_cache/{signature} — Store artifacts {files: {name: b64}} for a signature (marks its compile job DONE; idempotent per filename)"""
        return self._session.post(f"/api/v1/compile_cache/{signature}", body=body, params=params)

    def get_compile_jobs(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/compile_jobs — List AOT compile jobs (?state=&fingerprint=&experiment_id=)"""
        return self._session.get("/api/v1/compile_jobs", params=params, timeout=timeout)

    def post_compile_jobs_signature(self, signature: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/compile_jobs/{signature} — Worker/agent result report {state: DONE|FAILED, fingerprint, compile_ms, error}"""
        return self._session.post(f"/api/v1/compile_jobs/{signature}", body=body, params=params)

    def post_compile_jobs_signature_link(self, signature: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/compile_jobs/{signature}/link — Share another signature's artifacts ({from}) after a fingerprint match — executable sharing without recompiling"""
        return self._session.post(f"/api/v1/compile_jobs/{signature}/link", body=body, params=params)

    def get_debug_faults(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/debug/faults — List compiled-in fault points and the currently armed set"""
        return self._session.get("/api/v1/debug/faults", params=params, timeout=timeout)

    def post_debug_faults(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/debug/faults — Arm ({point, mode, count?, probability?} or {spec}) or disarm ({point, mode: off}; no point = disarm all) fault points at runtime"""
        return self._session.post("/api/v1/debug/faults", body=body, params=params)

    def get_deployments(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/deployments — List deployments (replica counts, target, smoothed load)"""
        return self._session.get("/api/v1/deployments", params=params, timeout=timeout)

    def post_deployments(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/deployments — Create a deployment from a serving config with serving.replicas"""
        return self._session.post("/api/v1/deployments", body=body, params=params)

    def get_deployments_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/deployments/{id} — Get deployment detail incl. per-replica health/breaker state, aggregated TTFT/TPOT/e2e/queue-wait p50/p99, and the slow-request ring (serving.slo_ms)"""
        return self._session.get(f"/api/v1/deployments/{id}", params=params, timeout=timeout)

    def post_deployments_id_canary(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/deployments/{id}/canary — Start ({model|checkpoint, fraction, replicas?}), promote ({promote: true}) or abort ({abort: true}) a canary traffic split with per-version latency aggregation"""
        return self._session.post(f"/api/v1/deployments/{id}/canary", body=body, params=params)

    def post_deployments_id_kill(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/deployments/{id}/kill — Kill the deployment and every replica (hard stop; scale to min first for a graceful teardown)"""
        return self._session.post(f"/api/v1/deployments/{id}/kill", body=body, params=params)

    def get_deployments_id_requests_rid_trace(self, id: Any, rid: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/deployments/{id}/requests/{rid}/trace — One served request's span tree (router dispatch + replica queue-wait/prefill/decode), ordered by start time — rendered by `det serve trace <deployment> <request-id>`"""
        return self._session.get(f"/api/v1/deployments/{id}/requests/{rid}/trace", params=params, timeout=timeout)

    def post_deployments_id_scale(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/deployments/{id}/scale — Manually set target replicas within [min, max]"""
        return self._session.post(f"/api/v1/deployments/{id}/scale", body=body, params=params)

    def post_deployments_id_update(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/deployments/{id}/update — Rolling blue-green weight swap to {model[:version]} or {checkpoint}: spawn-at-new before drain-at-old, one replica at a time, zero dropped (docs/serving.md 'Model lifecycle')"""
        return self._session.post(f"/api/v1/deployments/{id}/update", body=body, params=params)

    def get_experiments(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/experiments — List experiments"""
        return self._session.get("/api/v1/experiments", params=params, timeout=timeout)

    def post_experiments(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/experiments — Create experiment (managed, or unmanaged with unmanaged: true)"""
        return self._session.post("/api/v1/experiments", body=body, params=params)

    def delete_experiments_id(self, id: Any) -> Any:
        """DELETE /api/v1/experiments/{id} — Delete a terminal experiment"""
        return self._session.delete(f"/api/v1/experiments/{id}")

    def get_experiments_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/experiments/{id} — Get experiment"""
        return self._session.get(f"/api/v1/experiments/{id}", params=params, timeout=timeout)

    def post_experiments_id_activate(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/experiments/{id}/activate — Activate"""
        return self._session.post(f"/api/v1/experiments/{id}/activate", body=body, params=params)

    def post_experiments_id_archive(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/experiments/{id}/archive — Archive"""
        return self._session.post(f"/api/v1/experiments/{id}/archive", body=body, params=params)

    def post_experiments_id_cancel(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/experiments/{id}/cancel — Cancel"""
        return self._session.post(f"/api/v1/experiments/{id}/cancel", body=body, params=params)

    def get_experiments_id_checkpoints(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/experiments/{id}/checkpoints — List experiment checkpoints"""
        return self._session.get(f"/api/v1/experiments/{id}/checkpoints", params=params, timeout=timeout)

    def post_experiments_id_complete(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/experiments/{id}/complete — Close out an unmanaged experiment"""
        return self._session.post(f"/api/v1/experiments/{id}/complete", body=body, params=params)

    def get_experiments_id_file_tree(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/experiments/{id}/file_tree — List the model definition's files (content-cached by tarball hash)"""
        return self._session.get(f"/api/v1/experiments/{id}/file_tree", params=params, timeout=timeout)

    def post_experiments_id_kill(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/experiments/{id}/kill — Kill"""
        return self._session.post(f"/api/v1/experiments/{id}/kill", body=body, params=params)

    def get_experiments_id_model_def(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/experiments/{id}/model_def — Download the model definition tarball (base64)"""
        return self._session.get(f"/api/v1/experiments/{id}/model_def", params=params, timeout=timeout)

    def post_experiments_id_pause(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/experiments/{id}/pause — Pause"""
        return self._session.post(f"/api/v1/experiments/{id}/pause", body=body, params=params)

    def get_experiments_id_searcher_events(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/experiments/{id}/searcher_events — Custom-searcher event long-poll"""
        return self._session.get(f"/api/v1/experiments/{id}/searcher_events", params=params, timeout=timeout)

    def post_experiments_id_searcher_operations(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/experiments/{id}/searcher_operations — Submit custom-searcher operations"""
        return self._session.post(f"/api/v1/experiments/{id}/searcher_operations", body=body, params=params)

    def get_experiments_id_trials(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/experiments/{id}/trials — List trials (paginated: limit/offset)"""
        return self._session.get(f"/api/v1/experiments/{id}/trials", params=params, timeout=timeout)

    def post_experiments_id_trials(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/experiments/{id}/trials — Create a trial on an unmanaged experiment"""
        return self._session.post(f"/api/v1/experiments/{id}/trials", body=body, params=params)

    def post_experiments_id_unarchive(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/experiments/{id}/unarchive — Unarchive"""
        return self._session.post(f"/api/v1/experiments/{id}/unarchive", body=body, params=params)

    def get_generic_tasks(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/generic-tasks — List generic-tasks"""
        return self._session.get("/api/v1/generic-tasks", params=params, timeout=timeout)

    def post_generic_tasks(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/generic-tasks — Launch a generic-task task (config.entrypoint/resources/environment/idle_timeout_s)"""
        return self._session.post("/api/v1/generic-tasks", body=body, params=params)

    def get_generic_tasks_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/generic-tasks/{id} — Get task"""
        return self._session.get(f"/api/v1/generic-tasks/{id}", params=params, timeout=timeout)

    def post_generic_tasks_id_kill(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/generic-tasks/{id}/kill — Kill (propagates down the task tree)"""
        return self._session.post(f"/api/v1/generic-tasks/{id}/kill", body=body, params=params)

    def get_groups(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/groups — List user groups with members"""
        return self._session.get("/api/v1/groups", params=params, timeout=timeout)

    def post_groups(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/groups — Create group (admin)"""
        return self._session.post("/api/v1/groups", body=body, params=params)

    def delete_groups_id(self, id: Any) -> Any:
        """DELETE /api/v1/groups/{id} — Delete group (admin)"""
        return self._session.delete(f"/api/v1/groups/{id}")

    def post_groups_id_members(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/groups/{id}/members — Add member (admin)"""
        return self._session.post(f"/api/v1/groups/{id}/members", body=body, params=params)

    def delete_groups_id_members_uid(self, id: Any, uid: Any) -> Any:
        """DELETE /api/v1/groups/{id}/members/{uid} — Remove member (admin)"""
        return self._session.delete(f"/api/v1/groups/{id}/members/{uid}")

    def get_job_queues(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/job-queues — Queue introspection"""
        return self._session.get("/api/v1/job-queues", params=params, timeout=timeout)

    def post_job_queues_reorder(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/job-queues/reorder — Reorder ahead-of/behind (admin)"""
        return self._session.post("/api/v1/job-queues/reorder", body=body, params=params)

    def get_master(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/master — Cluster info (no auth required)"""
        return self._session.get("/api/v1/master", params=params, timeout=timeout)

    def post_master_cleanup_logs(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/master/cleanup_logs — Manual task-log retention sweep (admin)"""
        return self._session.post("/api/v1/master/cleanup_logs", body=body, params=params)

    def get_me(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/me — Current user"""
        return self._session.get("/api/v1/me", params=params, timeout=timeout)

    def get_models(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/models — List models"""
        return self._session.get("/api/v1/models", params=params, timeout=timeout)

    def post_models(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/models — Create model"""
        return self._session.post("/api/v1/models", body=body, params=params)

    def delete_models_name(self, name: Any) -> Any:
        """DELETE /api/v1/models/{name} — Archive model"""
        return self._session.delete(f"/api/v1/models/{name}")

    def get_models_name(self, name: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/models/{name} — Get model"""
        return self._session.get(f"/api/v1/models/{name}", params=params, timeout=timeout)

    def get_models_name_versions(self, name: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/models/{name}/versions — List versions"""
        return self._session.get(f"/api/v1/models/{name}/versions", params=params, timeout=timeout)

    def post_models_name_versions(self, name: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/models/{name}/versions — Register a COMMITTED checkpoint as the next immutable version (pins it against GC; docs/serving.md 'Model lifecycle')"""
        return self._session.post(f"/api/v1/models/{name}/versions", body=body, params=params)

    def get_models_name_versions_v(self, name: Any, v: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/models/{name}/versions/{v} — Get one version (checkpoint uuid + train provenance) — the resolution target of `det serve update <dep> <name>:<v>`"""
        return self._session.get(f"/api/v1/models/{name}/versions/{v}", params=params, timeout=timeout)

    def get_notebooks(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/notebooks — List notebooks"""
        return self._session.get("/api/v1/notebooks", params=params, timeout=timeout)

    def post_notebooks(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/notebooks — Launch a notebook task (config.entrypoint/resources/environment/idle_timeout_s)"""
        return self._session.post("/api/v1/notebooks", body=body, params=params)

    def get_notebooks_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/notebooks/{id} — Get task"""
        return self._session.get(f"/api/v1/notebooks/{id}", params=params, timeout=timeout)

    def post_notebooks_id_kill(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/notebooks/{id}/kill — Kill (propagates down the task tree)"""
        return self._session.post(f"/api/v1/notebooks/{id}/kill", body=body, params=params)

    def get_openapi(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/openapi — This document"""
        return self._session.get("/api/v1/openapi", params=params, timeout=timeout)

    def post_projects(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/projects — Create"""
        return self._session.post("/api/v1/projects", body=body, params=params)

    def delete_projects_id(self, id: Any) -> Any:
        """DELETE /api/v1/projects/{id} — Archive"""
        return self._session.delete(f"/api/v1/projects/{id}")

    def get_projects_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/projects/{id} — Get"""
        return self._session.get(f"/api/v1/projects/{id}", params=params, timeout=timeout)

    def get_rbac_assignments(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/rbac/assignments — List role assignments"""
        return self._session.get("/api/v1/rbac/assignments", params=params, timeout=timeout)

    def post_rbac_assignments(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/rbac/assignments — Grant viewer/editor/admin to a user or group, optionally workspace-scoped"""
        return self._session.post("/api/v1/rbac/assignments", body=body, params=params)

    def delete_rbac_assignments_id(self, id: Any) -> Any:
        """DELETE /api/v1/rbac/assignments/{id} — Revoke assignment"""
        return self._session.delete(f"/api/v1/rbac/assignments/{id}")

    def get_runs(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/runs — Flat runs view over trials"""
        return self._session.get("/api/v1/runs", params=params, timeout=timeout)

    def post_runs_move(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/runs/move — Move runs' experiments"""
        return self._session.post("/api/v1/runs/move", body=body, params=params)

    def get_serving(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/serving — List serving tasks (allocation state, proxy address, restarts)"""
        return self._session.get("/api/v1/serving", params=params, timeout=timeout)

    def post_serving(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/serving — Launch a serve replica (config.serving/resources/checkpoint_storage)"""
        return self._session.post("/api/v1/serving", body=body, params=params)

    def get_serving_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/serving/{id} — Get serving task"""
        return self._session.get(f"/api/v1/serving/{id}", params=params, timeout=timeout)

    def post_serving_id_kill(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/serving/{id}/kill — Kill the serving task (no respawn)"""
        return self._session.post(f"/api/v1/serving/{id}/kill", body=body, params=params)

    def get_shells(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/shells — List shells"""
        return self._session.get("/api/v1/shells", params=params, timeout=timeout)

    def post_shells(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/shells — Launch a shell task (config.entrypoint/resources/environment/idle_timeout_s)"""
        return self._session.post("/api/v1/shells", body=body, params=params)

    def get_shells_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/shells/{id} — Get task"""
        return self._session.get(f"/api/v1/shells/{id}", params=params, timeout=timeout)

    def post_shells_id_kill(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/shells/{id}/kill — Kill (propagates down the task tree)"""
        return self._session.post(f"/api/v1/shells/{id}/kill", body=body, params=params)

    def get_stream(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/stream — Long-poll entity-change events (since/entities/timeout_seconds)"""
        return self._session.get("/api/v1/stream", params=params, timeout=timeout)

    def post_task_logs(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/task/logs — Batched task-log shipping (agent / task owner)"""
        return self._session.post("/api/v1/task/logs", body=body, params=params)

    def get_tasks(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/tasks — List all tasks (trials/NTSC/generic/GC), optional ?type=; paginated: limit/offset"""
        return self._session.get("/api/v1/tasks", params=params, timeout=timeout)

    def get_tasks_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/tasks/{id} — Get task"""
        return self._session.get(f"/api/v1/tasks/{id}", params=params, timeout=timeout)

    def get_tasks_id_context(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/tasks/{id}/context — Model-def tarball for the task"""
        return self._session.get(f"/api/v1/tasks/{id}/context", params=params, timeout=timeout)

    def get_tasks_id_logs(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/tasks/{id}/logs — Task logs (offset/follow/timeout_seconds; limit caps the batch)"""
        return self._session.get(f"/api/v1/tasks/{id}/logs", params=params, timeout=timeout)

    def get_templates(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/templates — List"""
        return self._session.get("/api/v1/templates", params=params, timeout=timeout)

    def post_templates(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/templates — Create/replace"""
        return self._session.post("/api/v1/templates", body=body, params=params)

    def delete_templates_name(self, name: Any) -> Any:
        """DELETE /api/v1/templates/{name} — Delete"""
        return self._session.delete(f"/api/v1/templates/{name}")

    def get_templates_name(self, name: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/templates/{name} — Get"""
        return self._session.get(f"/api/v1/templates/{name}", params=params, timeout=timeout)

    def get_tensorboards(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/tensorboards — List tensorboards"""
        return self._session.get("/api/v1/tensorboards", params=params, timeout=timeout)

    def post_tensorboards(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/tensorboards — Launch a tensorboard task (config.entrypoint/resources/environment/idle_timeout_s)"""
        return self._session.post("/api/v1/tensorboards", body=body, params=params)

    def get_tensorboards_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/tensorboards/{id} — Get task"""
        return self._session.get(f"/api/v1/tensorboards/{id}", params=params, timeout=timeout)

    def post_tensorboards_id_kill(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/tensorboards/{id}/kill — Kill (propagates down the task tree)"""
        return self._session.post(f"/api/v1/tensorboards/{id}/kill", body=body, params=params)

    def get_trials_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/trials/{id} — Get trial"""
        return self._session.get(f"/api/v1/trials/{id}", params=params, timeout=timeout)

    def get_trials_id_checkpoints(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/trials/{id}/checkpoints — Checkpoint lineage, newest first; ?state= filters (COMPLETED = the restore-fallback chain); paginated: limit/offset"""
        return self._session.get(f"/api/v1/trials/{id}/checkpoints", params=params, timeout=timeout)

    def get_trials_id_logs(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/trials/{id}/logs — Trial log alias"""
        return self._session.get(f"/api/v1/trials/{id}/logs", params=params, timeout=timeout)

    def get_trials_id_metrics(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/trials/{id}/metrics — Read metrics"""
        return self._session.get(f"/api/v1/trials/{id}/metrics", params=params, timeout=timeout)

    def post_trials_id_metrics(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/trials/{id}/metrics — Report metrics (also maintains the summary rollups)"""
        return self._session.post(f"/api/v1/trials/{id}/metrics", body=body, params=params)

    def get_trials_id_progress(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/trials/{id}/progress — Searcher progress"""
        return self._session.get(f"/api/v1/trials/{id}/progress", params=params, timeout=timeout)

    def post_trials_id_progress(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/trials/{id}/progress — Report progress"""
        return self._session.post(f"/api/v1/trials/{id}/progress", body=body, params=params)

    def post_trials_id_run_prepare(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/trials/{id}/run_prepare — RunPrepareForReporting analogue"""
        return self._session.post(f"/api/v1/trials/{id}/run_prepare", body=body, params=params)

    def post_trials_id_runner_metadata(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/trials/{id}/runner/metadata — Runner heartbeat/state"""
        return self._session.post(f"/api/v1/trials/{id}/runner/metadata", body=body, params=params)

    def post_trials_id_searcher_completed_operation(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/trials/{id}/searcher/completed_operation — Report the searcher metric for a completed op"""
        return self._session.post(f"/api/v1/trials/{id}/searcher/completed_operation", body=body, params=params)

    def get_trials_id_searcher_operation(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/trials/{id}/searcher/operation — Long-poll the current searcher op (length to train to)"""
        return self._session.get(f"/api/v1/trials/{id}/searcher/operation", params=params, timeout=timeout)

    def post_trials_id_spans(self, id: Any, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/trials/{id}/spans — Ingest lifecycle-trace spans (idempotency-keyed batch; span_id deduped)"""
        return self._session.post(f"/api/v1/trials/{id}/spans", body=body, params=params)

    def get_trials_id_trace(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/trials/{id}/trace — Full lifecycle trace, ordered by start time"""
        return self._session.get(f"/api/v1/trials/{id}/trace", params=params, timeout=timeout)

    def get_users(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/users — List users"""
        return self._session.get("/api/v1/users", params=params, timeout=timeout)

    def post_users(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/users — Create user (admin)"""
        return self._session.post("/api/v1/users", body=body, params=params)

    def get_users_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/users/{id} — Get user"""
        return self._session.get(f"/api/v1/users/{id}", params=params, timeout=timeout)

    def patch_users_id(self, id: Any, *, body: Optional[Dict[str, Any]] = None) -> Any:
        """PATCH /api/v1/users/{id} — Patch user: active/role/password (admin; self for password)"""
        return self._session.patch(f"/api/v1/users/{id}", body=body)

    def get_webhooks(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/webhooks — List"""
        return self._session.get("/api/v1/webhooks", params=params, timeout=timeout)

    def post_webhooks(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/webhooks — Create (admin)"""
        return self._session.post("/api/v1/webhooks", body=body, params=params)

    def delete_webhooks_id(self, id: Any) -> Any:
        """DELETE /api/v1/webhooks/{id} — Delete (admin)"""
        return self._session.delete(f"/api/v1/webhooks/{id}")

    def get_workspaces(self, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/workspaces — List"""
        return self._session.get("/api/v1/workspaces", params=params, timeout=timeout)

    def post_workspaces(self, *, body: Optional[Dict[str, Any]] = None, params: Optional[Dict[str, Any]] = None) -> Any:
        """POST /api/v1/workspaces — Create"""
        return self._session.post("/api/v1/workspaces", body=body, params=params)

    def delete_workspaces_id(self, id: Any) -> Any:
        """DELETE /api/v1/workspaces/{id} — Archive"""
        return self._session.delete(f"/api/v1/workspaces/{id}")

    def get_workspaces_id(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/workspaces/{id} — Get"""
        return self._session.get(f"/api/v1/workspaces/{id}", params=params, timeout=timeout)

    def get_workspaces_id_projects(self, id: Any, *, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        """GET /api/v1/workspaces/{id}/projects — List projects"""
        return self._session.get(f"/api/v1/workspaces/{id}/projects", params=params, timeout=timeout)
