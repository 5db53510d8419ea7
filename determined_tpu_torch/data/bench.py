"""A/B harness for the input pipeline: synchronous feed vs DevicePrefetcher.

Counterpart of determined_tpu/data/bench.py: drive the SAME host iterator
and per-step consumer through both paths and report steady-state step
times and input-wait means, so the "prefetch moves the host-to-device
copy off the critical path" claim is a measured number.

`input_wait_ms` means the same thing on both sides: wall time the step
loop spends obtaining a ready batch on the device — the host iterator and
the copy inline (waited for) on the synchronous path, the queue wait on
the prefetched one.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Union

import torch

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.data.prefetch import DevicePrefetcher, _as_tensor, _map


def _put(batch: Any, device: torch.device) -> Any:
    """The batch's leaves on `device`, the copy waited for."""
    out = _map(batch, lambda x: _as_tensor(x).to(device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def _consume(it: Iterable[Any], step_fn: Callable[[Any], None],
             sync_device: Optional[torch.device] = None) -> Dict[str, float]:
    """Run step_fn over every batch, timing how long each batch took to
    obtain. sync_device: the device the synchronous path copies each batch
    to inline — what the unprefetched trainer loop pays a step."""
    it = iter(it)
    n = 0
    wait_ms = 0.0
    t0 = time.perf_counter()
    while True:
        w0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        if sync_device is not None:
            batch = _put(batch, sync_device)
        wait_ms += (time.perf_counter() - w0) * 1e3
        step_fn(batch)
        n += 1
    dt = time.perf_counter() - t0
    return {"steps": n, "total_s": round(dt, 4),
            "step_ms": round(dt / n * 1e3, 3) if n else 0.0,
            "input_wait_ms": round(wait_ms / n, 3) if n else 0.0}


def ab_compare(
    make_iter: Callable[[], Iterable[Any]],
    step_fn: Callable[[Any], None],
    device: Union[str, torch.device] = "cuda",
    depth: int = 2,
) -> Dict[str, Any]:
    """Run the same workload synchronously and prefetched onto `device`
    (CUDA unless "cpu" is asked for by name); return both sides plus the
    speedup. `make_iter` must return a fresh,
    identically-ordered finite iterable each call."""
    device = resolve_device(device)
    sync = _consume(make_iter(), step_fn, sync_device=device)

    pf = DevicePrefetcher(make_iter(), device, depth=depth, name="bench")
    try:
        prefetched = _consume(pf, step_fn)
        h2d = pf.window_metrics().get("h2d_ms")
        if h2d is not None:
            prefetched["h2d_ms"] = round(h2d, 3)
    finally:
        pf.close()

    speedup = (sync["step_ms"] / prefetched["step_ms"]
               if prefetched["step_ms"] else 0.0)
    return {
        "sync": sync,
        "prefetch": prefetched,
        "speedup": round(speedup, 3),
        "input_wait_ms_delta": round(
            sync["input_wait_ms"] - prefetched["input_wait_ms"], 3),
        "depth": depth,
    }
