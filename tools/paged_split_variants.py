#!/usr/bin/env python3
"""Variants of the paged split kernel against each other on one GPU: the
same inputs, each variant timed like `chip_smoke.time_cold`, in turns.

    python3 tools/paged_split_variants.py

Each variant is ops/csrc/paged_attention.cu with a few lines replaced (the
thread count, the loads) and a split size, built with the repository's
nvcc flags into build/chip/var/ and called through the same C interface.
It records why the kernel splits contexts into 512 keys with 256 threads
and streaming loads; a variant whose line no longer exists in the source
stops the script. It also times the shipped kernel after a flush that
leaves L2 clean (a 64 MB read) beside `time_cold`'s write.
"""

import ctypes
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from determined_tpu_torch.ops import _build  # noqa: E402
from determined_tpu_torch.ops import paged_attention as pa  # noqa: E402

SRC = os.path.join(ROOT, "determined_tpu_torch", "ops", "csrc",
                   "paged_attention.cu")
OUT = os.path.join(ROOT, "build", "chip", "var")
LDG = [("kr[u][v] = ld_stream(kp + v * G, policy);",
        "kr[u][v] = __ldg(kp + v * G);"),
       ("vr[u][v] = ld_stream(vp + v * G, policy);",
        "vr[u][v] = __ldg(vp + v * G);")]
T128 = [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")]
VARIANTS = {  # name: (source substitutions, split_keys)
    "c512": ([], 512),  # as shipped
    "c512_ldg": (LDG, 512),
    "c256": ([], 256),
    "c256_ldg": (LDG, 256),
    "t128_c256": (T128, 256),
    "t128_c128": (T128, 128),
}


def build(name):
    """Write and compile variant `name` -> its loaded library."""
    src = open(SRC).read()
    for old, new in VARIANTS[name][0]:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    cu = os.path.join(OUT, f"{name}.cu")
    so = os.path.join(OUT, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    out = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
                          cu], capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"build {name} failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dtt_paged_attention.argtypes = [vp] * 7 + [ci] * 8 + [
        ctypes.c_float, vp]
    lib.dtt_paged_attention.restype = ci
    return lib


def run(lib, split, q, kp, vp, tables, pos):
    slots, nh, dh = q.shape
    p, bs = kp.shape[:2]
    mb = tables.shape[1]
    out = torch.empty_like(q)
    n = -(-mb * bs // split)
    ws = torch.empty(slots * nh * n * (dh + 2), dtype=torch.float32,
                     device="cuda") if n > 1 else None
    err = lib.dtt_paged_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        slots, nh, dh, bs, mb, p, split, 1, 1.0 / dh ** 0.5,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: cudaError {err}")
    return out


def timed(fn, flush, iters=50, sleep=cs.SLEEP_CYCLES):
    """`chip_smoke.time_cold` with the flush as a function."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(sleep)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def main() -> int:
    cs.phase_device()
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    calls = {name: (lambda a, lib=libs[name], split=VARIANTS[name][1]:
                    run(lib, split, *a)) for name in VARIANTS}

    gen = torch.Generator(device="cuda").manual_seed(1)
    args, _ = cs.paged_inputs(8, 1000, gen)
    args[4][3], args[4][5] = 255, 0
    ref = pa.paged_attention_reference(*args)
    for name, call in calls.items():
        err = (call(args).float() - ref.float()).abs().max().item()
        print(f"{name}: max err vs plain {err:.3e}", flush=True)
        if err > 2e-2:
            return 1

    buf = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    dirty = buf.zero_

    def clean():
        buf.sum(dtype=torch.int64)  # reads 64 MB, writes 8 bytes

    t1 = torch.zeros(1, device="cuda")
    for label, flush in (("write", dirty), ("read", clean)):
        print(f"[{label} flush] empty kernel "
              f"{timed(lambda: t1.add_(1), flush):.4f} ms")
    for slots, pos in ((8, 1023), (8, 320), (1, 320), (1, 4095), (8, 4095)):
        args, _ = cs.paged_inputs(slots, pos, gen)
        res = {n: [] for n in VARIANTS}
        for order in (list(VARIANTS), list(reversed(VARIANTS))):
            for name in order:
                res[name].append(timed(lambda: calls[name](args), dirty))
        read = timed(lambda: calls["c512"](args), clean)
        print(f"slots{slots} pos{pos}: " + ", ".join(
            f"{n} {min(v):.4f}" for n, v in res.items())
            + f"; c512 after a read flush {read:.4f}", flush=True)
    layers = [cs.paged_inputs(8, 320, gen)[0] for _ in range(12)]
    for name, call in calls.items():
        ms = timed(lambda: [call(a) for a in layers], dirty,
                   sleep=4 * cs.SLEEP_CYCLES)
        print(f"12 layers pos320 {name}: {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
