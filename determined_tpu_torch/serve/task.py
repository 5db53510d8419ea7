"""Serve-replica entry point: `python -m determined_tpu_torch.serve cfg.json`.

Counterpart of determined_tpu/serve/task.py. Launched by the master as a
serving task (config in DET_SERVING_CONFIG), or locally with a config file
on the command line. Lifecycle:

  1. build the model config (`serving.model` / `serving.model_config`);
  2. restore the params: `serving.checkpoint` names a COMPLETED checkpoint
     that the port's `Trainer.fit` wrote (an id, or "latest": the newest of
     the lineage), read from `checkpoint_storage` (type `shared_fs`) and
     verified against its manifest before a byte is used, with a fallback
     through the lineage (engine.load_checkpoint_params); or a `.npz` file
     written by `models.gpt2.save_params_npz`. Each `serving.adapters`
     entry is restored the same way, from the trial of its checkpoint id,
     else from the base checkpoint's trial (`_trial_id_for`);
  3. build the kernels and capture every call as a CUDA graph, start the
     batcher and the HTTP front-end; inside a cluster (DET_MASTER and
     DET_ALLOCATION_ID set) report the proxy address and readiness, push
     the load report on a heartbeat and ship request spans to the master;
  4. on SIGTERM or SIGINT, or on the allocation's preemption signal (the
     master's long-poll, through core's PreemptContext): stop admitting,
     report draining at once, finish every accepted request within the
     signal's deadline less DRAIN_SAFETY_MARGIN_S (DRAIN_BUDGET_S without
     one), and exit 0.

The config is JSON, or YAML when the file ends in .yaml/.yml (PyYAML is
imported only then). Not ported yet (ROADMAP.md): compile-farm warm AOT
and the cloud storage backends.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Dict, Optional

import torch

from determined_tpu_torch.core._context import checkpoint_base  # noqa: F401  (re-export)

logger = logging.getLogger("determined_tpu_torch.serve")

DRAIN_BUDGET_S = 60.0
DRAIN_SAFETY_MARGIN_S = 2.0
HEARTBEAT_PERIOD_S = 2.0


class ReplicaHeartbeat:
    """Pushes the replica's load report (queue depth, occupancy, KV
    blocks, drain state) to the master on a fixed period — the router's
    least-loaded signal and the deployment autoscaler's input. Loss-
    tolerant: a failed POST is logged and the next beat retries; the
    master treats stale reports as "no signal", never as "dead"."""

    def __init__(self, session, allocation_id: str, batcher,
                 period_s: float = HEARTBEAT_PERIOD_S):
        self._session = session
        self._allocation_id = allocation_id
        self._batcher = batcher
        self._period = max(0.2, float(period_s))
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        """One synchronous report. Called by the loop, and directly at
        drain start (the drain handshake: the master must see
        draining=true before the grace window burns down, so the router
        ejects the replica at once rather than at the next period)."""
        if self._session is None or not self._allocation_id:
            return
        try:
            stats = self._batcher.heartbeat_stats()
            # Echo the version label the master pinned at spawn, so the
            # deployment shows what each replica actually serves.
            mv = os.environ.get("DET_MODEL_VERSION")
            if mv:
                stats["model_version"] = mv
            adapters = self._batcher.engine.adapter_names
            if adapters:
                stats["adapters"] = list(adapters)
            self._session.post(
                f"/api/v1/allocations/{self._allocation_id}/serve_stats",
                body=stats)
        except Exception:
            logger.debug("serve_stats heartbeat failed", exc_info=True)

    def _run(self) -> None:
        while not self._stop_evt.wait(self._period):
            self.beat()

    def start(self) -> "ReplicaHeartbeat":
        if self._session is None or not self._allocation_id:
            return self  # local/masterless mode: nothing to report to
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serve-heartbeat")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def build_model(serving: Dict[str, Any]):
    """serving.model/model_config -> a models.gpt2.Config."""
    from determined_tpu_torch.models import gpt2

    family = serving.get("model", "gpt2")
    if family != "gpt2":
        raise ValueError(
            f"unknown serving.model {family!r}; supported: gpt2")
    mc = dict(serving.get("model_config") or {})
    size = mc.get("model_size", "small")
    base = {
        "tiny": gpt2.Config.tiny,
        "small": gpt2.Config.small,
        "medium": gpt2.Config.medium,
        "large": gpt2.Config.large,
    }[size]()
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    seq_len = int(mc.get("seq_len", base.n_positions))
    # Every architecture dim is overridable: the config must reproduce the
    # checkpoint's exact shapes or the engine's capture fails at startup.
    return gpt2.Config(
        vocab_size=int(mc.get("vocab_size", base.vocab_size)),
        n_positions=max(int(mc.get("n_positions", base.n_positions)),
                        seq_len),
        d_model=int(mc.get("d_model", base.d_model)),
        n_layer=int(mc.get("n_layer", base.n_layer)),
        n_head=int(mc.get("n_head", base.n_head)),
        dtype=dtypes[mc.get("dtype", "bfloat16")],
        num_experts=int(mc.get("num_experts", 1)),
        moe_top_k=int(mc.get("moe_top_k", 2)),
    )


def _trial_id_for(serving: Dict[str, Any]) -> int:
    """The trial whose lineage `serving.checkpoint` resolves in: the trial
    of a `trial{N}-step{M}` id, else `serving.trial_id`."""
    from determined_tpu_torch.core._checkpoint import _STATE_ID_RE

    m = _STATE_ID_RE.match(str(serving.get("checkpoint", "latest")))
    if m:
        return int(m.group(1))
    return int(serving.get("trial_id", 0))


def _restore(ckpt: str, base: str, trial_id: int) -> Dict[str, Any]:
    """Params from a `.npz` file, or from checkpoint `ckpt` (an id or
    "latest") of trial `trial_id`'s lineage under `base`. An id names its
    own trial."""
    from determined_tpu_torch.core._checkpoint import (
        _STATE_ID_RE, CheckpointContext)
    from determined_tpu_torch.models.gpt2 import load_params_npz
    from determined_tpu_torch.serve.engine import load_checkpoint_params

    if ckpt.endswith(".npz"):
        return load_params_npz(ckpt)
    m = _STATE_ID_RE.match(ckpt)
    ctx = CheckpointContext(base, trial_id=int(m.group(1)) if m else trial_id)
    return load_checkpoint_params(ctx, ckpt)


def build_replica(config: Dict[str, Any], device=None):
    """Config -> (engine, batcher). Shared by the task, tests and
    chip_smoke.py. `device` defaults to `serving.device`, then to CUDA
    (which raises without a card; pass "cpu" explicitly)."""
    from determined_tpu_torch.serve.engine import ServingEngine
    from determined_tpu_torch.serve.kv_cache import BlockManager
    from determined_tpu_torch.serve.scheduler import (
        AdmissionQueue, ContinuousBatcher)

    serving = config.get("serving") or {}
    cfg = build_model(serving)
    base = checkpoint_base(config.get("checkpoint_storage"))
    trial_id = _trial_id_for(serving)
    params = _restore(str(serving.get("checkpoint", "latest")), base,
                      trial_id)
    # Multi-adapter replicas: each serving.adapters entry restores a
    # head-tuned fine-tune through the same verified path, then lives as
    # one table of the engine's adapter stack, picked per request by its
    # `model:` name. An adapter that is not an explicit id resolves in the
    # base checkpoint's trial.
    adapters = {str(a["name"]): _restore(str(a["checkpoint"]), base,
                                         trial_id)
                for a in serving.get("adapters") or []}
    slots = int(serving.get("max_batch_size", 8))
    block_size = int(serving.get("kv_block_size", 16))
    num_blocks = serving.get("kv_num_blocks")
    engine = ServingEngine(
        params, cfg,
        slots=slots,
        max_seq_len=int(serving.get("max_seq_len",
                                    min(cfg.n_positions, 1024))),
        prefill_buckets=serving.get("prefill_buckets"),
        seed=int(serving.get("seed", 0)),
        attention_impl=str(serving.get("attention_impl", "auto")),
        kv_block_size=block_size,
        kv_num_blocks=int(num_blocks) if num_blocks else None,
        adapters=adapters or None,
        device=device if device is not None else serving.get("device"),
    )
    if engine.paged:
        # The device pool IS the budget: the manager mirrors it exactly.
        blocks = BlockManager(
            num_blocks=engine.num_blocks, block_size=engine.block_size,
            prefix_cache=bool(serving.get("prefix_cache", True)))
    else:
        # Dense layout: accounting only, slots lanes of max_seq tokens.
        blocks = BlockManager(
            num_blocks=slots * max(1, (engine.max_seq_len + block_size - 1)
                                   // block_size),
            block_size=block_size)
    queue = AdmissionQueue(maxsize=int(serving.get("queue_depth", 64)))
    batcher = ContinuousBatcher(engine, queue=queue, block_manager=blocks)
    return engine, batcher


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        raw = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml

        return yaml.safe_load(raw)
    return json.loads(raw)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    raw = os.environ.get("DET_SERVING_CONFIG")
    if raw:
        config = json.loads(raw)
    elif argv:
        config = load_config(argv[0])  # local mode: config file on the cli
    else:
        print("usage: python -m determined_tpu_torch.serve cfg.json "
              "(or DET_SERVING_CONFIG)", file=sys.stderr)
        return 1

    master = os.environ.get("DET_MASTER")
    allocation_id = os.environ.get("DET_ALLOCATION_ID") or ""
    session = None
    if master and allocation_id:
        from determined_tpu_torch.common.api import Session

        session = Session(master, os.environ.get("DET_SESSION_TOKEN"))

    engine, batcher = build_replica(config)
    serving = config.get("serving") or {}

    # Per-request span tracing: retire-time span trees batch-POST to the
    # master's request_spans store (kept locally without a master); errors
    # and SLO breaches always traced, the rest at serving.trace_sample
    # (0 disables).
    from determined_tpu_torch.serve.tracing import RequestTracer

    sample = float(serving.get("trace_sample", 1.0))
    tracer = None
    if sample > 0:
        tracer = RequestTracer(session, allocation_id, sample=sample,
                               slo_ms=serving.get("slo_ms"))
        batcher.tracer = tracer
        tracer.start()

    batcher.start()  # builds the kernels and captures every call first

    from determined_tpu_torch.serve.http import ServingServer

    server = ServingServer(batcher, port=int(serving.get("port", 0)))
    server.start()
    addr = f"http://{socket.gethostname()}:{server.port}"
    logger.info("serve replica up on port %d (device=%s, slots=%d, "
                "buckets=%s)", server.port, engine.device, engine.slots,
                engine.prefill_buckets)
    if session is not None:
        try:
            session.post(
                f"/api/v1/allocations/{allocation_id}/proxy_address",
                body={"rank": 0, "address": addr})
            session.post(f"/api/v1/allocations/{allocation_id}/ready")
        except Exception:
            logger.warning("proxy address / ready report failed",
                           exc_info=True)
    heartbeat = ReplicaHeartbeat(
        session, allocation_id, batcher,
        period_s=float(serving.get("heartbeat_period_s",
                                   HEARTBEAT_PERIOD_S))).start()

    # The allocation's preemption long-poll (a watcher thread inside a
    # cluster; nothing without a session) drains the replica as SIGTERM
    # does.
    from determined_tpu_torch.core._preempt import PreemptContext

    preempt = PreemptContext(session, allocation_id)
    drain_requested = threading.Event()

    def _on_signal(signum, frame):
        logger.info("signal %d: draining", signum)
        drain_requested.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    stats_every = float(serving.get("stats_log_period_s", 30.0))
    last_stats = time.monotonic()
    try:
        while not drain_requested.wait(0.5):
            if preempt.should_preempt():
                logger.info("preemption signal (%s): draining",
                            preempt.preemption_reason() or "unspecified")
                break
            if stats_every and time.monotonic() - last_stats >= stats_every:
                last_stats = time.monotonic()
                logger.info("stats: %s", json.dumps(batcher.stats()))
        # Drain: stop admitting (HTTP 503), report draining=true at once
        # (the router stops dispatching here without waiting a period),
        # finish accepted work inside the grace window, exit 0 either way:
        # a blown budget means the node is about to go.
        deadline = preempt.preemption_deadline()
        budget = (max(1.0, deadline - DRAIN_SAFETY_MARGIN_S)
                  if deadline is not None else DRAIN_BUDGET_S)
        t0 = time.monotonic()
        batcher.queue.drain()
        heartbeat.beat()
        finished = batcher.drain(timeout=budget)
        logger.info("drain %s in %.2fs (budget %.1fs): %s",
                    "complete" if finished else "TIMED OUT",
                    time.monotonic() - t0, budget,
                    json.dumps(batcher.stats()))
        return 0
    finally:
        heartbeat.stop()
        server.stop()
        batcher.stop()
        if tracer is not None:
            tracer.stop()  # final flush: drained requests keep traces
        preempt.close()


if __name__ == "__main__":
    sys.exit(main())
