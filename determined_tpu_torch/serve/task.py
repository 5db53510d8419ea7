"""Serve-replica entry point: `python -m determined_tpu_torch.serve cfg.json`.

Counterpart of determined_tpu/serve/task.py in local mode. Lifecycle:

  1. build the model config (`serving.model` / `serving.model_config`),
  2. load the params from `serving.checkpoint`, a `.npz` written by
     `models.gpt2.save_params_npz`,
  3. build the kernel and warm every call, start the batcher and the HTTP
     front-end,
  4. on SIGTERM or SIGINT: stop admitting, finish every accepted request
     within DRAIN_BUDGET_S, and exit 0.

The config is JSON, or YAML when the file ends in .yaml/.yml (PyYAML is
imported only then). The master-attached replica (heartbeat, preemption
long-poll, compile-farm warm start, orbax checkpoint restore through the
integrity lineage) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import json
import logging
import signal
import sys
import threading
import time
from typing import Any, Dict

import torch

logger = logging.getLogger("determined_tpu_torch.serve")

DRAIN_BUDGET_S = 60.0


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
    # checkpoint's exact shapes or the engine's warm-up fails at startup.
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


def build_replica(config: Dict[str, Any], device=None):
    """Config -> (engine, batcher). `device` defaults to `serving.device`,
    then to CUDA (which raises without a card; pass "cpu" explicitly)."""
    from determined_tpu_torch.serve.engine import (
        ServingEngine, load_checkpoint_params)
    from determined_tpu_torch.serve.kv_cache import BlockManager
    from determined_tpu_torch.serve.scheduler import (
        AdmissionQueue, ContinuousBatcher)

    serving = config.get("serving") or {}
    cfg = build_model(serving)
    ckpt = serving.get("checkpoint")
    if not ckpt:
        raise FileNotFoundError(
            "serving.checkpoint must name a params .npz "
            "(models.gpt2.save_params_npz)")
    params = load_checkpoint_params(str(ckpt))
    num_blocks = serving.get("kv_num_blocks")
    engine = ServingEngine(
        params, cfg,
        slots=int(serving.get("max_batch_size", 8)),
        max_seq_len=int(serving.get("max_seq_len",
                                    min(cfg.n_positions, 1024))),
        prefill_buckets=serving.get("prefill_buckets"),
        seed=int(serving.get("seed", 0)),
        attention_impl=str(serving.get("attention_impl", "auto")),
        kv_block_size=int(serving.get("kv_block_size", 16)),
        kv_num_blocks=int(num_blocks) if num_blocks else None,
        device=device if device is not None else serving.get("device"),
    )
    # The device pool IS the budget: the manager mirrors it exactly.
    blocks = BlockManager(
        num_blocks=engine.num_blocks, block_size=engine.block_size,
        prefix_cache=bool(serving.get("prefix_cache", True)))
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
    if not argv:
        print("usage: python -m determined_tpu_torch.serve cfg.json",
              file=sys.stderr)
        return 1
    config = load_config(argv[0])

    engine, batcher = build_replica(config)
    batcher.start()  # builds the kernel and warms every call first

    from determined_tpu_torch.serve.http import ServingServer

    serving = config.get("serving") or {}
    server = ServingServer(batcher, port=int(serving.get("port", 0)))
    server.start()
    logger.info("serve replica up on port %d (device=%s, slots=%d, "
                "buckets=%s)", server.port, engine.device, engine.slots,
                engine.prefill_buckets)

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
            if stats_every and time.monotonic() - last_stats >= stats_every:
                last_stats = time.monotonic()
                logger.info("stats: %s", json.dumps(batcher.stats()))
        # Drain: stop admitting (HTTP 503), finish accepted work, exit 0.
        t0 = time.monotonic()
        finished = batcher.drain(timeout=DRAIN_BUDGET_S)
        logger.info("drain %s in %.2fs (budget %.1fs): %s",
                    "complete" if finished else "TIMED OUT",
                    time.monotonic() - t0, DRAIN_BUDGET_S,
                    json.dumps(batcher.stats()))
        return 0
    finally:
        server.stop()
        batcher.stop()


if __name__ == "__main__":
    sys.exit(main())
