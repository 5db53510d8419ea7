"""The port's input-pipeline A/B harness (`determined_tpu_torch.data.
bench.ab_compare`) on the CPU, as tests/test_data_pipeline.py drives the
JAX package's: a host iterator that takes 20 ms a batch and a 50 ms step.
Prefetched, the input overlaps the step: at least 1.25x the synchronous
throughput, and the input wait falls from about the host's 20 ms to under
half of it."""

import time

import numpy as np

from determined_tpu_torch.data.bench import ab_compare

HOST_DELAY_S = 0.020
STEP_S = 0.050
N_STEPS = 12


def slow_host_iter():
    rng = np.random.default_rng(0)
    for _ in range(N_STEPS):
        time.sleep(HOST_DELAY_S)  # simulated host preprocessing
        yield {"x": rng.normal(size=(8, 16)).astype(np.float32)}


def test_throughput_prefetch_beats_sync():
    seen = []

    def step_fn(batch):
        seen.append(batch["x"].device.type)
        time.sleep(STEP_S)  # stands in for dispatched device compute

    result = ab_compare(slow_host_iter, step_fn, device="cpu", depth=2)
    assert seen == ["cpu"] * (2 * N_STEPS)
    assert result["sync"]["steps"] == result["prefetch"]["steps"] == N_STEPS
    assert result["speedup"] >= 1.25, result
    assert result["sync"]["input_wait_ms"] >= HOST_DELAY_S * 1e3 * 0.9, result
    assert result["prefetch"]["input_wait_ms"] < HOST_DELAY_S * 1e3 * 0.5, \
        result
    assert result["input_wait_ms_delta"] > 0
    assert result["depth"] == 2
