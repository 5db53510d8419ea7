"""ProfilerContext — system metrics and the device-utilization series.

Counterpart of determined_tpu/core/_profiler.py. A collector thread (on
between `on()` and `off()`) samples host memory and CPU from /proc and the
CUDA device's allocated memory, and reports them with the window's
`steps_per_second` and `device_flops_util` (model FLOPs per step times
steps per second over the card's peak) as the "profiling" metric group.
The peak comes from `PEAK_BF16_FLOPS` by `torch.cuda.get_device_name`:
an H100's dense bf16 tensor rate, 989 TFLOP/s (NVIDIA's data sheet, SXM
part, at the full 700 W power limit). The JAX package's `trace()`
(jax.profiler) is not ported.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional

logger = logging.getLogger("determined_tpu_torch.core")

# Dense bf16 peak FLOP/s per card by device-name prefix.
PEAK_BF16_FLOPS = {
    "NVIDIA H100": 989e12,
}


def peak_flops_per_device() -> Optional[float]:
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0)
    except Exception:
        return None
    for prefix, peak in PEAK_BF16_FLOPS.items():
        if name.startswith(prefix):
            return peak
    return None


def _read_proc_stat() -> tuple:
    with open("/proc/stat") as f:
        parts = f.readline().split()[1:8]
    vals = [int(p) for p in parts]
    return sum(vals), vals[3] + vals[4]


def collect_system_metrics() -> Dict[str, Any]:
    metrics: Dict[str, Any] = {}
    try:
        mem = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                mem[k] = int(v.strip().split()[0]) * 1024
        metrics["host_mem_used_bytes"] = mem["MemTotal"] - mem.get(
            "MemAvailable", 0)
        metrics["host_mem_total_bytes"] = mem["MemTotal"]
    except Exception:
        pass
    try:
        import torch

        for i in range(torch.cuda.device_count()):
            metrics[f"cuda{i}_mem_allocated_bytes"] = \
                torch.cuda.memory_allocated(i)
            metrics[f"cuda{i}_mem_total_bytes"] = \
                torch.cuda.get_device_properties(i).total_memory
    except Exception:
        pass
    return metrics


class _Collector(threading.Thread):
    def __init__(self, profiler: "ProfilerContext", interval: float):
        super().__init__(daemon=True, name="profiler-collector")
        self._profiler = profiler
        self._interval = interval
        self._stop_event = threading.Event()

    def run(self) -> None:
        prev = None
        while not self._stop_event.wait(self._interval):
            m = collect_system_metrics()
            try:
                total, idle = _read_proc_stat()
                if prev is not None and total > prev[0]:
                    m["host_cpu_util"] = 1.0 - (idle - prev[1]) / (
                        total - prev[0])
                prev = (total, idle)
            except Exception:
                pass
            m.update(self._profiler._utilization_window())
            try:
                self._profiler._train.report_metrics(
                    "profiling", self._profiler._step, m)
            except Exception:
                logger.debug("profiler report failed", exc_info=True)

    def close(self) -> None:
        self._stop_event.set()


class ProfilerContext:
    def __init__(self, train_context):
        self._train = train_context
        self._collector: Optional[_Collector] = None
        self._step = 0
        self._lock = threading.Lock()
        self._flops_per_step: Optional[float] = None
        self._n_devices = 1
        self._window_steps = 0
        self._window_seconds = 0.0
        self._input_wait_ms = 0.0
        self._input_h2d_ms = 0.0
        self._input_depth = 0.0
        self._input_batches = 0
        self._collector_interval = 5.0
        self._peak = peak_flops_per_device()

    def set_step(self, step: int) -> None:
        self._step = step

    def set_flops_per_step(self, flops: Optional[float],
                           n_devices: int = 1) -> None:
        """Model FLOPs per (global) optimizer step; enables the
        device_flops_util series."""
        self._flops_per_step = flops
        self._n_devices = max(1, n_devices)

    def observe_steps(self, n_steps: int, seconds: float) -> None:
        """The Trainer's window at each metrics flush: steps and wall time."""
        with self._lock:
            self._window_steps += n_steps
            self._window_seconds += seconds

    def observe_input(self, wait_ms_sum: float, h2d_ms_sum: float,
                      depth_sum: float, n_batches: int) -> None:
        """Input-pipeline window sums. The port's Trainer copies batches
        to the device without a prefetcher and reports none yet."""
        if not n_batches:
            return
        with self._lock:
            self._input_wait_ms += wait_ms_sum
            self._input_h2d_ms += h2d_ms_sum
            self._input_depth += depth_sum
            self._input_batches += n_batches

    def _utilization_window(self) -> Dict[str, Any]:
        with self._lock:
            steps, secs = self._window_steps, self._window_seconds
            self._window_steps, self._window_seconds = 0, 0.0
            in_wait, in_h2d = self._input_wait_ms, self._input_h2d_ms
            in_depth, in_n = self._input_depth, self._input_batches
            self._input_wait_ms = self._input_h2d_ms = 0.0
            self._input_depth, self._input_batches = 0.0, 0
        out: Dict[str, Any] = {}
        if in_n:
            out["input_wait_ms"] = in_wait / in_n
            out["h2d_ms"] = in_h2d / in_n
            out["prefetch_queue_depth"] = in_depth / in_n
        if steps and secs > 0:
            sps = steps / secs
            out["steps_per_second"] = sps
            if self._flops_per_step and self._peak:
                out["device_flops_util"] = (
                    self._flops_per_step * sps / (self._peak * self._n_devices))
        return out

    def on(self, sampling_interval: float = 5.0) -> None:
        if self._collector is None:
            self._collector_interval = sampling_interval
            self._collector = _Collector(self, sampling_interval)
            self._collector.start()

    def off(self) -> None:
        if self._collector is not None:
            collector, self._collector = self._collector, None
            collector.close()
            collector.join(timeout=self._collector_interval + 2.0)
            if collector.is_alive():
                logger.warning("profiler collector did not stop in time")

    def close(self) -> None:
        self.off()
