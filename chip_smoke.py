#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout. It drives `determined_tpu_torch`, never the
JAX package, through these phases, and exits non-zero at the first that
fails:

  1. device: require CUDA; print the card's name and power limit as
     `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
     them; switch TF32 off for matmuls and cuDNN.
  2. build: compile every kernel from ops/csrc/ with nvcc (sm_90a) into
     build/kernels/.
  3. kernels against their plain versions at the serving shapes: the paged
     decode-attention kernel vs `paged_attention_reference` on the same
     GPU tensors, slots 1/8/32, H 12, Dh 64, block 16, 64 blocks a slot,
     permuted and shared pool blocks, an all-trash inactive slot, positions
     0, 15, 16 and 1023. Tolerances: fp32 atol=rtol=1e-5; bf16
     atol=rtol=2e-2 (the kernel keeps P in fp32 where the plain version
     casts the probabilities to bf16).
  4. the main path at full width: GPT-2 small (124M, random weights from a
     seed) saved with `save_params_npz`, served through `build_replica` and
     `ServingServer` in bf16 (8 slots, max_seq_len 1024, KV block 16,
     prefix cache on). Eight concurrent requests share a 256-token prefix
     and carry distinct 32-token suffixes (64 new tokens, temperature 0),
     plus one at temperature 0.8. Every response must be 200 with 64
     tokens, the prefix cache must hit, every decode step must launch the
     kernel once per layer, and the plain version must never run.
  5. end-to-end parity: the same weights in fp32, one prompt, 16 decode
     steps through the kernel and through the plain version (teacher-forced
     on the kernel run's tokens); the logits must agree to atol 1e-3.
  6. times on the card (CUDA events, L2 flushed before every launch): the
     kernel, its plain version, and one library call over the gathered
     lane (`scaled_dot_product_attention`, a yardstick the port never
     calls) at 8 slots and position 1023, beside the least time the card
     could take; and the main path's decode step, tokens/s and TTFT.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1


def phase_device():
    if not os.path.isdir(os.path.join(ROOT, "determined_tpu_torch")):
        fail("determined_tpu_torch/ not found beside chip_smoke.py: run it "
             "from the root of a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[device] {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return card


# ------------------------------------------------------------------ phase 2


def phase_build():
    from determined_tpu_torch.ops import _build

    t0 = time.monotonic()
    path = _build.build("paged_attention")
    _build.load("paged_attention")
    secs = time.monotonic() - t0
    say(f"[build] {path.relative_to(ROOT)} from "
        f"determined_tpu_torch/ops/csrc/paged_attention.cu for sm_90a in "
        f"{secs:.2f} s")
    seen = set()
    for line in _build.build_log.get("paged_attention", "").splitlines():
        if "Used" in line and "registers" in line and line not in seen:
            seen.add(line)
            say(f"[build]   {line.split(':', 1)[-1].strip()}")


# ------------------------------------------------------------------ phase 3


def make_case(slots, dtype, gen, H=12, Dh=64, bs=16, mb=64):
    """Kernel inputs at serving shapes: a permuted pool, slot 1 sharing the
    first half of slot 0's blocks, the last slot inactive (all-trash table,
    position 0) when there are several, positions 1023, 600, 0, 15, 16 and
    then random."""
    import torch

    P = slots * mb + 1  # + trash
    trash = P - 1
    dev = "cuda"
    q = torch.randn(slots, H, Dh, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, bs, H, Dh, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, bs, H, Dh, generator=gen, device=dev).to(dtype)
    tables = torch.randperm(trash, generator=gen, device=dev)
    tables = tables[:slots * mb].reshape(slots, mb).to(torch.int32)
    fixed = [1023, 600, 0, 15, 16]
    pos = torch.randint(0, mb * bs, (slots,), generator=gen, device=dev)
    pos[:min(slots, len(fixed))] = torch.tensor(fixed[:slots], device=dev)
    if slots > 2:
        tables[1, :mb // 2] = tables[0, :mb // 2]
    if slots > 1:
        tables[-1] = trash
        pos[-1] = 0
    return q, kp, vp, tables.contiguous(), pos.to(torch.int32)


def phase_kernel_check():
    import torch

    from determined_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for slots in (1, 8, 32):
            args = make_case(slots, dtype, gen)
            out = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            ref = paged_attention_reference(*args)
            err = (out.float() - ref.float()).abs()
            bad = err > tol[dtype] + tol[dtype] * ref.float().abs()
            max_err = float(err.max())
            worst = max(worst, max_err)
            say(f"[kernel] paged_attention {str(dtype)[6:]} slots={slots} "
                f"positions={args[4].tolist()[:5]}... max_abs_err="
                f"{max_err:.3e} (atol=rtol={tol[dtype]:g})")
            if not torch.isfinite(out.float()).all():
                fail(f"paged_attention {dtype} slots={slots}: non-finite "
                     "output")
            if bad.any():
                fail(f"paged_attention {dtype} slots={slots}: "
                     f"{int(bad.sum())} elements outside tolerance "
                     f"(max err {max_err:.3e})")
    return worst


# ------------------------------------------------------------------ phase 4


def _post(url, body, timeout=600.0):
    req = urllib.request.Request(
        url, method="POST", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(url, timeout=60.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def write_model(workdir):
    """GPT-2 small with random weights from SEED, saved as .npz."""
    import torch

    from determined_tpu_torch.models import gpt2

    cfg = gpt2.Config.small()
    t0 = time.monotonic()
    params = gpt2.init(torch.Generator().manual_seed(SEED), cfg)
    path = os.path.join(workdir, "gpt2_small.npz")
    gpt2.save_params_npz(path, params)
    say(f"[serve] GPT-2 small: {gpt2.param_count(cfg):,} params, init + "
        f"save {time.monotonic() - t0:.1f} s")
    return path


def phase_serve(workdir, ckpt):
    import numpy as np

    from determined_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)
    from determined_tpu_torch.serve.http import ServingServer
    from determined_tpu_torch.serve.task import build_replica, load_config

    cfg_path = os.path.join(workdir, "serve.json")
    with open(cfg_path, "w") as f:
        json.dump({"serving": {
            "model": "gpt2",
            "model_config": {"model_size": "small", "dtype": "bfloat16"},
            "checkpoint": ckpt,
            "max_batch_size": 8,
            "max_seq_len": 1024,
            "kv_block_size": 16,
            "prefix_cache": True,
            "seed": SEED,
        }}, f)
    config = load_config(cfg_path)

    # The main path runs from here: every count starts at 0.
    paged_attention_cuda.launches = 0
    paged_attention_reference.calls = 0
    t0 = time.monotonic()
    engine, batcher = build_replica(config)
    decode_s = []
    decode = engine.decode

    def timed_decode(*args):
        t = time.perf_counter()
        out = decode(*args)  # ends in a device-to-host copy: synchronised
        decode_s.append(time.perf_counter() - t)
        return out

    engine.decode = timed_decode
    batcher.start()
    say(f"[serve] replica built and warmed in {time.monotonic() - t0:.1f} s: "
        f"{json.dumps(engine.compile_stats)}")
    server = ServingServer(batcher, host="127.0.0.1", port=0).start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        rng = np.random.default_rng(SEED)
        vocab = engine.cfg.vocab_size
        prefix = rng.integers(0, vocab, 256).tolist()
        bodies = [{"tokens": prefix + rng.integers(0, vocab, 32).tolist(),
                   "max_new_tokens": 64, "temperature": 0.0}
                  for _ in range(8)]
        bodies.append({"tokens": rng.integers(0, vocab, 64).tolist(),
                       "max_new_tokens": 64, "temperature": 0.8})
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            results = list(pool.map(
                lambda b: _post(url + "/v1/generate", b), bodies))
        wall = time.perf_counter() - t0
        for i, (status, body) in enumerate(results):
            if status != 200:
                fail(f"request {i}: HTTP {status} {body}")
            toks = body["tokens"]
            if len(toks) != 64 or not all(0 <= t < vocab for t in toks):
                fail(f"request {i}: {len(toks)} tokens, expected 64 in "
                     f"[0, {vocab})")
        say(f"[serve] {len(results)} requests answered 200 with 64 tokens "
            "each")
        status, raw = _get(url + "/v1/stats")
        stats = json.loads(raw)
        m_status, metrics = _get(url + "/metrics")
        h_status, health = _get(url + "/healthz")
        if (status, m_status, h_status) != (200, 200, 200):
            fail(f"stats/metrics/healthz: {status}/{m_status}/{h_status}")
        if b"det_serve_prefix_cache_hit_rate" not in metrics:
            fail("/metrics lacks det_serve_prefix_cache_hit_rate")
    finally:
        server.stop()
        batcher.stop()
    kv = stats["kv_blocks"]
    est = stats["engine"]
    launches = paged_attention_cuda.launches
    say(f"[serve] kv_blocks: prefix_hit_tokens={kv['prefix_hit_tokens']} "
        f"prefix_hits={kv['prefix_hits']} hit_rate="
        f"{kv['prefix_cache_hit_rate']}")
    say(f"[serve] decode_steps={est['decode_steps']} attention_launches="
        f"{est['attention_launches']} (kernel launches on the whole path, "
        f"warm-up included: {launches}) reference calls="
        f"{paged_attention_reference.calls}")
    if kv["prefix_hit_tokens"] <= 0:
        fail("the shared 256-token prefix never hit the prefix cache")
    n_layer = engine.cfg.n_layer
    if est["decode_steps"] <= 0 or \
            est["attention_launches"] != n_layer * est["decode_steps"]:
        fail(f"attention_launches {est['attention_launches']} != "
             f"{n_layer} x decode_steps {est['decode_steps']}")
    if paged_attention_reference.calls != 0:
        fail(f"the plain version ran {paged_attention_reference.calls} "
             "times on the serving path")
    ttft = statistics.median(body["ttft_ms"] for _, body in results)
    tokens = sum(len(body["tokens"]) for _, body in results)
    return {"launches": launches, "decode_step_ms": statistics.median(
        decode_s) * 1e3, "decode_steps": len(decode_s),
        "tokens_per_s": tokens / wall, "tokens": tokens, "wall_s": wall,
        "ttft_p50_ms": ttft}


# ------------------------------------------------------------------ phase 5


def phase_parity(ckpt):
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.serve import model as smodel

    cfg = dataclasses.replace(gpt2.Config.small(), dtype=torch.float32)
    params = gpt2.params_from_numpy(gpt2.load_params_npz(ckpt), "cuda")
    bs, mb = 16, 64
    table = torch.arange(mb, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    prompt = rng.integers(0, cfg.vocab_size, 40)
    padded = torch.zeros(64, dtype=torch.int64, device="cuda")
    padded[:40] = torch.from_numpy(prompt)
    caches = {impl: smodel.init_paged_cache(cfg, mb + 1, bs, device="cuda")
              for impl in ("auto", "reference")}
    worst = 0.0
    with torch.inference_mode():
        first = {impl: smodel.paged_prefill(params, c, padded, 40, 0, table,
                                            cfg)[1]
                 for impl, c in caches.items()}
        tok = first["auto"].argmax()[None]
        pos = 40
        for _ in range(16):
            p = torch.tensor([pos], dtype=torch.int32, device="cuda")
            logits = {impl: smodel.paged_decode_step(
                params, c, tok, p, table[None], cfg, attention_impl=impl)[1]
                for impl, c in caches.items()}
            if not torch.isfinite(logits["auto"]).all():
                fail("parity: non-finite logits from the kernel path")
            worst = max(worst, float(
                (logits["auto"] - logits["reference"]).abs().max()))
            tok = logits["auto"].argmax(dim=-1)  # teacher-force the reference
            pos += 1
    say(f"[parity] fp32 GPT-2 small, 16 decode steps: kernel vs plain "
        f"max |logit diff| = {worst:.3e} (atol 1e-3)")
    if worst > 1e-3:
        fail(f"end-to-end logits differ by {worst:.3e} > 1e-3")


# ------------------------------------------------------------------ phase 6


def time_cold(fn, args, flush, iters=50):
    """Median ms of `fn(*args)` over `iters` launches, each timed with its
    own CUDA events after a write that evicts the 50 MB L2."""
    import torch

    for _ in range(3):
        fn(*args)
    times = []
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_times(card):
    import torch
    import torch.nn.functional as F

    from determined_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)

    dtype = torch.bfloat16
    slots, H, Dh, bs, mb = 8, 12, 64, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    P = slots * mb + 1
    q = torch.randn(slots, H, Dh, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(P, bs, H, Dh, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(P, bs, H, Dh, generator=gen, device="cuda").to(dtype)
    tables = torch.randperm(P - 1, generator=gen, device="cuda")
    tables = tables.reshape(slots, mb).to(torch.int32).contiguous()
    pos = torch.full((slots,), 1023, dtype=torch.int32, device="cuda")
    args = (q, kp, vp, tables, pos)
    # The library yardstick works on the gathered lane: [slots, H, S, Dh].
    k_lane = kp[tables.long()].reshape(slots, mb * bs, H, Dh).transpose(1, 2)
    v_lane = vp[tables.long()].reshape(slots, mb * bs, H, Dh).transpose(1, 2)
    k_lane, v_lane = k_lane.contiguous(), v_lane.contiguous()
    mask = (torch.arange(mb * bs, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]

    def sdpa(q4, k4, v4, m4):
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4)

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    launches0 = paged_attention_cuda.launches
    ms = time_cold(paged_attention_cuda, args, flush)
    plain_ms = time_cold(paged_attention_reference, args, flush)
    library_ms = time_cold(sdpa, (q[:, :, None, :], k_lane, v_lane, mask),
                           flush)
    # The serving run's contexts are 288..352 tokens: time that middle too.
    mid_ms = time_cold(paged_attention_cuda,
                       (q, kp, vp, tables, torch.full_like(pos, 320)), flush)
    paged_attention_cuda.launches = launches0  # timing runs do not count
    keys = int((pos.long() + 1).sum())
    itemsize = q.element_size()
    bytes_moved = (2 * q.numel() * itemsize            # q in, out
                   + 2 * keys * H * Dh * itemsize     # visible K and V
                   + tables.numel() * 4 + pos.numel() * 4)
    flops = 4 * keys * H * Dh
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S,
                   flops / PEAK_FLOPS[str(dtype)]) * 1e3
    bound_by = ("bytes" if bytes_moved / HBM_BYTES_PER_S
                >= flops / PEAK_FLOPS[str(dtype)] else "operations")
    say(f"[times] [{card}] paged_attention bf16 slots={slots} H={H} Dh={Dh} "
        f"bs={bs} pos=1023: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA over the gathered lane {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bytes_moved / 1e6:.2f} MB at 3.35 TB/s; "
        f"{bound_ms / ms * 100:.1f}% of bound)")
    say(f"[times] [{card}] paged_attention bf16 slots={slots} pos=320: "
        f"kernel {mid_ms:.4f} ms (x 12 layers = {12 * mid_ms:.3f} ms a "
        "decode step)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# ------------------------------------------------------------------ main


def main() -> int:
    card = phase_device()
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.monotonic()
    phase_build()
    max_err = phase_kernel_check()
    workdir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    ckpt = write_model(workdir)
    serve = phase_serve(workdir, ckpt)
    phase_parity(ckpt)
    times = phase_times(card)
    say(f"[times] [{card}] serving GPT-2 small bf16, 8 slots: decode step "
        f"p50 {serve['decode_step_ms']:.3f} ms over {serve['decode_steps']} "
        f"steps, {serve['tokens_per_s']:.1f} tokens/s ({serve['tokens']} "
        f"tokens in {serve['wall_s']:.2f} s), TTFT p50 "
        f"{serve['ttft_p50_ms']:.1f} ms")
    say(f"[done] all phases passed in {time.monotonic() - t_start:.1f} s")
    say(json.dumps({"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "determined_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "determined_tpu/ops/paged_attention.py:99",
        "launches": serve["launches"],
        "max_abs_err": max_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
