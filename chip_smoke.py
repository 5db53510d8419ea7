#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout. It drives `determined_tpu_torch`, never the
JAX package, through these phases, and exits non-zero at the first that
fails:

  1. device: require CUDA; print the card's name and power limit as
     `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
     them; switch TF32 off for matmuls and cuDNN.
  2. build: compile every kernel source in ops/csrc/ with nvcc (sm_90a)
     into build/kernels/, one nvcc per source, all started together; print
     each kernel function's registers and spill bytes from ptxas.
  3. the paged decode-attention kernels (the split kernel and the combine
     of the splits) against their plain version at the serving shapes:
     slots 1/8/32, H 12, Dh 64, block 16, 64 blocks a slot, permuted and
     shared pool blocks, an all-trash inactive slot, positions 0, 15, 16
     and 1023; then long contexts of 4096 keys (256 blocks, 8 splits of
     512) at slots 1 and 8 with positions at the splits' edges (511, 512,
     513, 1023, 1024, 4095). Tolerances: fp32 atol=rtol=1e-5; bf16
     atol=rtol=2e-2 (the kernel keeps P in fp32 where the plain version
     casts the probabilities to bf16). Every case is launched twice and
     the two outputs must be bit-identical (the splits merge in a fixed
     order).
  4. the flash-attention kernels (forward, dQ, dK/dV) against their plain
     versions on the same GPU tensors: the training shape (B 8, H 12, S
     1024, D 64, causal), a non-causal case, S 128 and D 128, each in fp32
     and bf16 with `bf16` off and on. Tolerances (atol, rtol): fp32 with
     `bf16` off, those of tests/test_ops.py: forward 2e-5 / 1e-4, backward
     2e-3 / 2e-3. Otherwise, set from this script's readings at these
     shapes (outputs one bf16 ulp apart, a few 1e-4 at most beyond it):
     forward and backward 1e-3 / 1e-2, except the forward output with bf16
     inputs and `bf16` on, 1e-2 / 1e-2: there the kernel rounds each k
     tile's exp(s - m) to bf16, as the Pallas kernel does, and the plain
     version the normalised probabilities, which puts up to 6e-3 beyond
     1e-2 |o| between them. lse 1e-4 / 1e-5. The plain versions compute
     the kernels' functions (fp32 logits of the inputs, fp32 P unless
     `bf16`), not `reference_attention`'s bf16 rounding. Then planted
     faults at the training shape, which each check must refuse: dQ and
     dK scaled by 1.1 (what a dS 10 % off gives), o scaled by 1.05, and
     the backward kernels run with the other `bf16` setting (P and dS
     rounded where they must not be, or not rounded where they must).
     For bf16 inputs with `bf16` off, also the share of o, dq, dk and dv
     values whose bf16 value differs from the plain version's must stay
     within `MISMATCH_LIMIT` (0.5 %): the tensor-core kernels split each
     fp32 operand exactly into three bf16 terms, so they differ only near
     rounding ties. (dq's first row is left out of that share when
     causal: its exact value is 0, one key with P = 1 gives dS = dP -
     delta = 0, so both versions hold fp32 noise there; atol holds it.)
     The three kernels run with one term of the split on the same tensors
     (P and dS rounded once) must differ in at least 10x that share: the
     one rounding atol 1e-3 cannot see in o.
  5. serving at full width through CUDA graphs: GPT-2 small (124M, random
     weights from a seed) saved with `save_params_npz`, served through
     `build_replica` and `ServingServer` in bf16 (8 slots, max_seq_len
     1024, KV block 16, prefix cache on). `compile()` must have captured
     decode (holding the paged kernel's 12 launches), every prefill bucket
     and the block copy, and prepared the sampler (`sample_s`). Eight concurrent requests share a 256-token prefix
     and carry distinct 32-token suffixes (64 new tokens, temperature 0),
     plus one at temperature 0.8. Every response must be 200 with 64
     tokens, the prefix cache must hit, every replayed decode step must
     launch the paged kernel once per layer (`attention_launches == 12 x
     decode_steps`), and its plain version must never run. Then, in turns
     with new prompts, the same burst with the engine's functions called
     eagerly (no graphs) and through the graphs again: decode step p50,
     tokens/s and TTFT of each; and one decode step at a fixed state (8
     slots at position 320) as a replay and as `paged_decode_step` called
     eagerly: host time, and device time under torch.profiler.
 5b. graphs against eager calls at full width: GPT-2 small in fp32, then
     bf16, 8 slots, max_seq_len 1024: two prefills (buckets 512 and 64,
     the second after a 256-token prefix-cache hit) and 16 decode steps
     through the engine's graphs and through the module functions eagerly
     on a copy of the same pool. Greedy tokens must be equal, fp32 logits
     within 1e-3 (phase 6's bound); whether they are bitwise equal is
     printed.
 5c. the dense layout at full width: GPT-2 small fp32, `attention_impl:
     dense`, captured like the paged engine: the same two prompts (no
     prefix hit) and 16 decode steps must give the paged engine's greedy
     tokens, logits within 1e-3.
  6. serving parity: the same weights in fp32, one prompt, 16 decode steps
     through the kernel and through the plain version (teacher-forced on
     the kernel run's tokens); the logits must agree to atol 1e-3.
  7. training at full width: `GPT2Trial` (examples/gpt2_cuda/model_def.py),
     GPT-2 small, seq_len 1024, global batch 8, bf16, remat "dots",
     attention_impl auto, through `core.init(max_length=30)` and
     `Trainer.fit`, on a memmapped token stream of repeated random 64-token
     phrases written from a seed. The loss must be finite and fall; each
     step must launch the flash forward kernel 24 times (12 layers, again
     in the remat recompute) and the dQ and dK/dV kernels 12 times each,
     the op-end validation 12 forward launches a batch; the plain
     attention must never run; the op end must leave one COMMITTED
     checkpoint that `restore_state` reads back bit-identical; the
     profiled steps must show all three flash kernels on their
     tensor-core (wgmma) kernel functions.
 7b. a replica restored from phase 7's checkpoints: `build_replica` with
     `checkpoint: latest` and one adapter, a second committed checkpoint of
     the trained params with `wte` perturbed from the seed; a newer
     checkpoint is committed and corrupted first, and `latest` must fall
     back past it. GPT-2 small fp32, 8 slots, max_seq_len 256. Requests for
     the base and the adapter answered over HTTP (200, routed by name);
     the adapter-routed logits must equal a direct replica of the
     fine-tune's full params within fp32 1e-3, and differ from the base's.
     Then the same replica as a cluster runs it, a process of its own
     (`python -m determined_tpu_torch.serve`) attached to an in-process
     fake master: with 4 requests accepted (200 new tokens each) the
     master answers the allocation's preemption long-poll; the replica
     must ack, report draining, answer all 4 in full and exit 0.
 7c. a managed trial: phase 7's trial and hparams as a cluster trial
     (`DET_MASTER`, `DET_TRIAL_ID`, `DET_ALLOCATION_ID`,
     `DET_SESSION_TOKEN`, `DET_HPARAMS`, `DET_EXPERIMENT_CONFIG` with
     `shared_fs` storage under build/smoke, set for the phase only) against
     an in-process stdlib fake master that records every request; the
     prefetcher and async checkpoints on, one searcher op of 30 steps, a
     report every 5. Run A: the master answers the preemption long-poll
     (deadline 120 s) once it has seen the report of step 15; `fit` must
     ack, save, commit and register trial1-step15 (PARTIAL, then
     COMPLETED) and return at step 15; its losses at steps 5, 10 and 15
     are held to phase 7's (same init, data and kernels: atol 1e-5, and
     whether they are bitwise equal is printed). Run B: a fresh
     `core.init()` with `DET_LATEST_CHECKPOINT` = the registered id; the
     checkpoint must restore A's params and Adam moments bitwise; `fit`
     trains to 30, commits trial1-step30 and completes the op, and the
     searcher answers `done`. The master's record must hold both
     `run_prepare`s, training reports at 5-30, two COMPLETED checkpoints,
     one completed op, spans and progress; the flash launches over A and
     B must equal phase 7's formula and the plain attention never run.
     Prints each report window's step, `input_wait_ms`, `h2d_ms` and
     `prefetch_queue_depth`.
 7d. information, not a claim: 15-step fits of phase 7's trial, prefetcher
     off and on in turns (off, on, on, off), each with an async checkpoint
     at step 10 whose write overlaps steps 11-15: fit's step per report
     window, and the ms the loop spent on that save (in `save_state`, and
     blocked in the wait that committed it, from its spans), against a
     synchronous save (`async_save` off) of the same state.
  8. GPT-2 training across processes and as CUDA-graph replay.
 8a. `make_multi_step` (steps_per_call 4) against 4 `make_train_step`
     calls from the same state and batches: GPT-2 small, B 8, S 1024,
     bf16, remat "dots", two windows (the first runs step 0 eagerly and
     captures the step, the second only replays). Window-mean losses,
     grad norms and all_finite are held to rtol 1e-6 and the params to
     atol 1e-6 (the replay holds the eager step's kernels, fed the same
     floats: expected bitwise equal); whether they are bitwise equal is
     printed. The captured step must hold the flash kernels' launches
     (24 forward, 12 dQ, 12 dK/dV) and the replays must have launched
     them 7 times over. Then, information: the step replayed and eager in
     turns (host clock a window) and torch.profiler's device time a step.
 8b. the five remat policies (None, "nothing", "dots", "dots_saveable",
     "everything") at full width and 2 layers, B 8, S 1024, bf16: loss
     (rtol 1e-6) and grad norm (rtol 1e-4) held to "dots"'s, the flash
     forward launched twice a layer (once under "everything"), and the
     peak memory of each printed.
 8c. the example trial launched through `python -m
     determined_tpu_torch.launch.torch_distributed` with
     `DET_SLOT_IDS="[0]"` against the fake master of 7c (10 steps at
     phase 7's hparams): the worker must see `CUDA_VISIBLE_DEVICES=0`,
     form an NCCL process group of one with its gloo control group
     (an allgather and a broadcast of bytes over it), a DeviceMesh of the
     world, launch the flash kernels by phase 7's formula, report through
     the chief (losses at 5 and 10 held to phase 7's, atol 1e-5, bitwise
     printed) and commit a checkpoint the master registers; a serve
     replica restores it, and its logits must equal the restored params'
     forward (fp32, 1e-3). Two ranks cannot share this one card
     (`tools/two_ranks_one_card.py`: NCCL refuses a second rank on a
     device; gloo takes all_reduce, broadcast, all_gather_into_tensor and
     reduce_scatter_tensor on CUDA tensors, but both ranks die (SIGSEGV)
     in DTensor's all-gather of a shard, which the fsdp path runs before
     every block), so the two-rank fsdp run needs a host with two cards
     and is not part of this script.
  9. training parity in fp32: the same GPT-2 small-width params (2 layers)
     and batches through the kernels and through the plain attention.
     Every leaf's step-0 gradient must agree to 1e-5 of that leaf's
     largest element. Then 3 optimizer steps (lr 0, then 1e-5): losses
     must agree to 1e-5, grad_norm to 1e-4 of itself and params to 1e-6
     (Adam moves a weight by about lr a step whatever the gradient's
     scale, so the params see a gradient's signs; the gradients and
     grad_norm see its size).
  10. times on the card (CUDA events, L2 flushed before every launch, the
     host's launch work hidden behind a device-side wait): each
     kernel, its plain version and one library call (a yardstick the port
     never calls): `scaled_dot_product_attention` over the gathered lane
     for the paged kernel (at slots 1 and 8 and positions 320, 1023 and
     4095, and 12 launches over 12 layers' pools as a decode step makes
     them), SDPA(is_causal) forward for the flash forward,
     and SDPA's autograd backward (dQ, dK and dV together) for both flash
     backward kernels; each beside the least time the card could take,
     the larger of the bytes it must move at 3.35 TB/s and its products
     at 989 TFLOP/s bf16, a product with P or dS in it counted as three
     bf16 products (`flash_bound`). Each flash kernel is timed again with
     `bf16=True`, which rounds P and dS as SDPA does. Then the
     main paths: the decode step, tokens/s and TTFT of serving, through
     the graphs and eager; the
     training step of `Trainer.fit` as it runs (its `steps_per_second`
     over the report windows after the first), tokens/s, MFU
     (`flops_per_token` against 989 TFLOP/s), and the device's idle share
     of that step from the device time of 3 more steps under
     torch.profiler. Also the first graph burst's tokens/s against the
     second's, and the managed trial's checkpoint costs.

The line before the last is a JSON object with one entry per kernel
(`kernel_route` says which units the kernel ran on: "wgmma" tensor cores
or "ffma" CUDA cores); the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
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


KERNEL_SOURCES = ("paged_attention", "flash_attention")


def phase_build():
    from determined_tpu_torch.ops import _build

    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        paths = dict(zip(KERNEL_SOURCES, pool.map(_build.build,
                                                  KERNEL_SOURCES)))
    for name in KERNEL_SOURCES:
        _build.load(name)
    secs = time.monotonic() - t0
    for name, path in paths.items():
        say(f"[build] {path.relative_to(ROOT)} from "
            f"determined_tpu_torch/ops/csrc/{name}.cu for sm_90a "
            f"({_build.build_seconds[name]:.2f} s)")
        for line in ptxas_summary(_build.build_log.get(name, "")):
            say(f"[build]   {line}")
    say(f"[build] all kernels built and loaded in {secs:.2f} s")


def _demangle(names):
    """Readable kernel names (c++filt where the host has it)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        readable = out.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        readable = []
    if len(readable) != len(names):
        return list(names)
    return [n.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for n in readable]


def ptxas_summary(log):
    """One line per kernel of nvcc's `-Xptxas -v` output: registers and
    spill bytes, plus any ptxas warning (e.g. wgmma serialised)."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, f"{m.group(1)} registers, {spill}"))
            name = None
    readable = _demangle([n for n, _ in rows])
    lines = [f"{n}: {info}" for n, (_, info) in zip(readable, rows)]
    return lines + [line.strip() for line in log.splitlines()
                    if "warning" in line.lower()]


# ------------------------------------------------------------------ phase 3


def make_case(slots, dtype, gen, H=12, Dh=64, bs=16, mb=64,
              fixed=(1023, 600, 0, 15, 16)):
    """Kernel inputs at serving shapes: a permuted pool, slot 1 sharing the
    first half of slot 0's blocks, the last slot inactive (all-trash table,
    position 0) when there are several, positions `fixed` and then
    random."""
    import torch

    P = slots * mb + 1  # + trash
    trash = P - 1
    dev = "cuda"
    q = torch.randn(slots, H, Dh, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, bs, H, Dh, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, bs, H, Dh, generator=gen, device=dev).to(dtype)
    tables = torch.randperm(trash, generator=gen, device=dev)
    tables = tables[:slots * mb].reshape(slots, mb).to(torch.int32)
    pos = torch.randint(0, mb * bs, (slots,), generator=gen, device=dev)
    n = min(slots, len(fixed))
    pos[:n] = torch.tensor(fixed[:n], device=dev)
    if slots > 2:
        tables[1, :mb // 2] = tables[0, :mb // 2]
    if slots > 1:
        tables[-1] = trash
        pos[-1] = 0
    return q, kp, vp, tables.contiguous(), pos.to(torch.int32)


# (slots, mb, positions): the serving shapes, then contexts of 4096 keys
# (8 splits of 512) with positions at the splits' edges.
PAGED_CASES = (
    (1, 64, (1023, 600, 0, 15, 16)), (8, 64, (1023, 600, 0, 15, 16)),
    (32, 64, (1023, 600, 0, 15, 16)), (1, 256, (4095,)), (1, 256, (512,)),
    (8, 256, (4095, 511, 512, 513, 1023, 1024, 4000)))


def phase_kernel_check():
    import torch

    from determined_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for slots, mb, fixed in PAGED_CASES:
            args = make_case(slots, dtype, gen, mb=mb, fixed=fixed)
            out = paged_attention_cuda(*args)
            again = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            ref = paged_attention_reference(*args)
            err = (out.float() - ref.float()).abs()
            bad = err > tol[dtype] + tol[dtype] * ref.float().abs()
            max_err = float(err.max())
            worst = max(worst, max_err)
            same = torch.equal(out, again)
            say(f"[kernel] paged_attention {str(dtype)[6:]} slots={slots} "
                f"keys={mb * 16} positions={args[4].tolist()[:8]}"
                f"{'...' if slots > 8 else ''} max_abs_err={max_err:.3e} "
                f"(atol=rtol={tol[dtype]:g}); two launches bit-identical: "
                f"{same}")
            if not torch.isfinite(out.float()).all():
                fail(f"paged_attention {dtype} slots={slots}: non-finite "
                     "output")
            if bad.any():
                fail(f"paged_attention {dtype} slots={slots} keys="
                     f"{mb * 16}: {int(bad.sum())} elements outside "
                     f"tolerance (max err {max_err:.3e})")
            if not same:
                fail(f"paged_attention {dtype} slots={slots} keys="
                     f"{mb * 16}: two launches on the same inputs differ")
    return worst


# ------------------------------------------------------------------ phase 4


FLASH_CASES = (  # (B, S, H, D, causal): the training shape first
    (8, 1024, 12, 64, True), (2, 512, 4, 64, False), (4, 128, 12, 64, True),
    (2, 256, 4, 128, True))


def flash_inputs(b, s, h, d, dtype, gen):
    """q, k, v as the per-head views of one fused [B, S, 3*H*D] product
    (the strides the model hands the kernels), and a contiguous dO."""
    import torch

    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda")
    q, k, v = (t.view(b, s, h, d) for t in qkv.to(dtype).split(h * d, -1))
    dout = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    return q, k, v, dout


def flash_tolerances(dtype, bf16):
    """(atol, rtol) of o, lse and the gradients (see the docstring)."""
    import torch

    if dtype == torch.float32 and not bf16:
        return {"o": (2e-5, 1e-4), "lse": (1e-4, 1e-5), "grad": (2e-3, 2e-3)}
    o_tol = (1e-2, 1e-2) if dtype == torch.bfloat16 and bf16 else (1e-3, 1e-2)
    return {"o": o_tol, "lse": (1e-4, 1e-5), "grad": (1e-3, 1e-2)}


# The share of bf16 elements of o, dq, dk and dv that may differ from the
# plain version's bf16 value, for bf16 inputs with `bf16` off. The exact
# split differs from the fp32 plain version only in the order of its sums,
# so a bf16 value differs only near a rounding tie: a calibration run
# measured 0.104-0.113 % (o, dk, dv) and 0.112 % (dq) at the training
# shape, where the kernels run with one term of the split (P and dS rounded
# to bf16 once) differ in 38.7-42.1 %.
MISMATCH_LIMIT = 0.005


def mismatch(got, want):
    """Share of elements whose values differ (both in the output dtype)."""
    return float((got != want).float().mean())


def dq_rows(t, causal):
    """dq [B, S, H, D] without its first row when causal: there the exact
    gradient is 0 (one key, P = 1, dS = dP - delta = 0) and both versions
    hold fp32 noise, which no bf16 comparison can hold; atol does."""
    return t[:, 1:] if causal else t


def held(got, want, atol, rtol):
    """(max abs error, the largest share of its allowance an element uses:
    err / (atol + rtol |want|), at most 1 when every element is held)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return float(err.max()), float((err / (atol + rtol * want.abs())).max())


def phase_flash_check():
    import torch

    from determined_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for b, s, h, d, causal in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for bf16 in (False, True):
                q, k, v, dout = flash_inputs(b, s, h, d, dtype, gen)
                o, lse = fa.flash_fwd_cuda(q, k, v, causal, bf16)
                delta = fa.flash_delta(dout, o)
                dq = fa.flash_dq_cuda(q, k, v, dout, lse, delta, causal, bf16)
                dk, dv = fa.flash_dkv_cuda(q, k, v, dout, lse, delta, causal,
                                           bf16)
                torch.cuda.synchronize()
                o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, bf16)
                dq_ref = fa.flash_dq_reference(q, k, v, dout, lse, delta,
                                               causal, bf16)
                dk_ref, dv_ref = fa.flash_dkv_reference(
                    q, k, v, dout, lse, delta, causal, bf16)
                tol = flash_tolerances(dtype, bf16)
                checks = (("fwd", "o", o, o_ref, tol["o"]),
                          ("fwd", "lse", lse, lse_ref, tol["lse"]),
                          ("dq", "dq", dq, dq_ref, tol["grad"]),
                          ("dkv", "dk", dk, dk_ref, tol["grad"]),
                          ("dkv", "dv", dv, dv_ref, tol["grad"]))
                errs = []
                for kernel, what, got, want, (atol, rtol) in checks:
                    if not torch.isfinite(got.float()).all():
                        fail(f"flash {what} B{b} S{s} H{h} D{d} {dtype} "
                             f"bf16={bf16}: non-finite output")
                    max_err, share = held(got, want, atol, rtol)
                    worst[kernel] = max(worst[kernel], max_err)
                    errs.append(f"{what} {max_err:.2e} ({share:.2f} of "
                                f"{atol:g}+{rtol:g}|x|)")
                    if share > 1.0:
                        fail(f"flash {what} B{b} S{s} H{h} D{d} causal="
                             f"{causal} {dtype} bf16={bf16}: max err "
                             f"{max_err:.3e} outside atol={atol:g} "
                             f"rtol={rtol:g} ({share:.2f} of the allowance)")
                say(f"[flash] B{b} S{s} H{h} D{d} causal={causal} "
                    f"{str(dtype)[6:]} bf16={bf16}: max_abs_err "
                    + ", ".join(errs))
                if dtype == torch.bfloat16 and not bf16:
                    shares = {what: mismatch(got, want) for what, got, want in
                              (("o", o, o_ref),
                               ("dq", dq_rows(dq, causal),
                                dq_rows(dq_ref, causal)),
                               ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
                    say("[flash]   bf16 values that differ from the plain "
                        "version's: " + ", ".join(
                            f"{w} {x * 100:.3f}%" for w, x in shares.items())
                        + f" (each held to {MISMATCH_LIMIT * 100:g}%; dq "
                        f"without row 0 when causal)")
                    for what in ("o", "dq", "dk", "dv"):
                        if shares[what] > MISMATCH_LIMIT:
                            fail(f"flash {what} B{b} S{s} H{h} D{d} bf16 "
                                 f"inputs: {shares[what] * 100:.3f}% of the "
                                 "bf16 values differ from the plain "
                                 f"version's (limit {MISMATCH_LIMIT * 100:g}%)")
                if (b, s, h, d, causal) == FLASH_CASES[0] and \
                        dtype == torch.bfloat16:
                    planted_faults(fa, (q, k, v, dout, lse, delta), tol,
                                   bf16, o_ref, dq_ref, dk_ref, dv_ref,
                                   o, dq, dk, causal)
    return worst


def planted_faults(fa, args, tol, bf16, o_ref, dq_ref, dk_ref, dv_ref, o,
                   dq, dk, causal):
    """Wrong results the checks above must refuse, at the training shape:
    fails the run if any of them would pass."""
    import torch

    q, k, v, dout, lse, delta = args
    dq_x = fa.flash_dq_cuda(q, k, v, dout, lse, delta, True, not bf16)
    dk_x, dv_x = fa.flash_dkv_cuda(q, k, v, dout, lse, delta, True, not bf16)
    torch.cuda.synchronize()
    faults = (("dQ x 1.1 (dS 10% off)", dq * 1.1, dq_ref, tol["grad"]),
              ("dK x 1.1 (dS 10% off)", dk * 1.1, dk_ref, tol["grad"]),
              ("o x 1.05", o * 1.05, o_ref, tol["o"]),
              (f"dQ with bf16={not bf16}", dq_x, dq_ref, tol["grad"]),
              (f"dK with bf16={not bf16}", dk_x, dk_ref, tol["grad"]),
              (f"dV with bf16={not bf16}", dv_x, dv_ref, tol["grad"]))
    seen = []
    for what, got, want, (atol, rtol) in faults:
        _, share = held(got, want, atol, rtol)
        seen.append(f"{what}: {share:.2f}")
        if share <= 1.0:
            fail(f"planted fault '{what}' (bf16={bf16}) passes the check "
                 f"at atol={atol:g} rtol={rtol:g}")
    say(f"[flash] planted faults at the training shape, bf16 inputs, "
        f"bf16={bf16}, each refused (share of the allowance, > 1 = "
        "refused): " + "; ".join(seen))
    if bf16:
        return
    # One term of the split where there must be three: P and dS rounded to
    # bf16 once. Only the share of differing bf16 values can see it in o.
    o_x = fa.flash_fwd_cuda(q, k, v, True, True)[0]
    torch.cuda.synchronize()
    seen = []
    for what, got, want in (("o", o_x, o_ref),
                            ("dq", dq_rows(dq_x, causal),
                             dq_rows(dq_ref, causal)),
                            ("dk", dk_x, dk_ref), ("dv", dv_x, dv_ref)):
        share = mismatch(got, want)
        seen.append(f"{what} {share * 100:.3f}%")
        if share <= 10 * MISMATCH_LIMIT:
            fail(f"planted fault '{what} with one term of the split' differs "
                 f"in {share * 100:.3f}% of its values: not 10x the limit "
                 f"of {MISMATCH_LIMIT * 100:g}%")
    say("[flash] planted fault, one term of the split (round_bf16=1 on the "
        "same tensors), refused by the share of differing bf16 values "
        f"(limit {MISMATCH_LIMIT * 100:g}%, needs 10x): " + ", ".join(seen))


# ------------------------------------------------------------------ phase 5


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


def serve_burst(url, rng, vocab):
    """The phase's traffic over HTTP: 8 concurrent requests sharing a
    256-token prefix with distinct 32-token suffixes (64 new tokens,
    temperature 0), plus one unrelated at temperature 0.8. Checks every
    answer -> (responses, wall seconds)."""
    prefix = rng.integers(0, vocab, 256).tolist()
    bodies = [{"tokens": prefix + rng.integers(0, vocab, 32).tolist(),
               "max_new_tokens": 64, "temperature": 0.0} for _ in range(8)]
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
    return [body for _, body in results], wall


def burst_summary(bodies, wall, step_s):
    tokens = sum(len(b["tokens"]) for b in bodies)
    return {"decode_step_ms": statistics.median(step_s) * 1e3,
            "decode_steps": len(step_s), "tokens_per_s": tokens / wall,
            "tokens": tokens, "wall_s": wall,
            "ttft_p50_ms": statistics.median(b["ttft_ms"] for b in bodies)}


def phase_serve(workdir, ckpt, card):
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
    say(f"[serve] replica built and captured in {time.monotonic() - t0:.1f} "
        f"s: {json.dumps(engine.compile_stats)}")
    if "sample_s" not in engine.compile_stats:
        fail("compile() did not prepare the sampler")
    n_layer = engine.cfg.n_layer
    graphs = engine.stats()["cuda_graphs"]
    want = {"decode", "copy_block"} | {
        f"prefill_{b}" for b in engine.prefill_buckets}
    say(f"[serve] CUDA graphs captured (paged-kernel launches each holds): "
        f"{graphs}")
    if set(graphs) != want or graphs["decode"] != n_layer:
        fail(f"captured graphs {graphs}: expected {sorted(want)} with "
             f"{n_layer} paged launches in decode")
    server = ServingServer(batcher, host="127.0.0.1", port=0).start()
    url = f"http://127.0.0.1:{server.port}"
    vocab = engine.cfg.vocab_size
    rng = np.random.default_rng(SEED)
    captured = engine._graphs
    runs = {"graph": [], "eager": []}
    try:
        bodies, wall = serve_burst(url, rng, vocab)
        status, raw = _get(url + "/v1/stats")
        stats = json.loads(raw)
        wrapper_launches = paged_attention_cuda.launches
        ref_calls = paged_attention_reference.calls
        m_status, metrics = _get(url + "/metrics")
        h_status, health = _get(url + "/healthz")
        if (status, m_status, h_status) != (200, 200, 200):
            fail(f"stats/metrics/healthz: {status}/{m_status}/{h_status}")
        if b"det_serve_prefix_cache_hit_rate" not in metrics:
            fail("/metrics lacks det_serve_prefix_cache_hit_rate")
        say(f"[serve] {len(bodies)} requests answered 200 with 64 tokens "
            "each")
        runs["graph"].append(burst_summary(bodies, wall, decode_s))
        # In turns (graph, eager, eager, graph), with new prompts each time:
        # the same burst with the engine's functions called eagerly (its CPU
        # branch: no graphs) and through the graphs. The eager runs launch
        # the kernel through its wrapper: timing runs do not count.
        for mode in ("eager", "eager", "graph"):
            engine._graphs = None if mode == "eager" else captured
            decode_s.clear()
            bodies_m, wall_m = serve_burst(url, rng, vocab)
            runs[mode].append(burst_summary(bodies_m, wall_m, decode_s))
    finally:
        engine._graphs = captured
        server.stop()
        batcher.stop()
    kv = stats["kv_blocks"]
    est = stats["engine"]
    replayed = est["attention_launches"]
    # + the decode graph's one replay at compile (not through decode()).
    launches = wrapper_launches + replayed + graphs["decode"]
    say(f"[serve] kv_blocks: prefix_hit_tokens={kv['prefix_hit_tokens']} "
        f"prefix_hits={kv['prefix_hits']} hit_rate="
        f"{kv['prefix_cache_hit_rate']}")
    say(f"[serve] decode_steps={est['decode_steps']} attention_launches="
        f"{replayed} (replayed from the decode graph); paged kernel launches "
        f"on the whole path: {launches} ({wrapper_launches} through the "
        f"wrapper: the warm-up and the capture; {graphs['decode']} in the "
        f"replay at compile) reference calls={ref_calls}")
    if kv["prefix_hit_tokens"] <= 0:
        fail("the shared 256-token prefix never hit the prefix cache")
    if est["decode_steps"] <= 0 or replayed != n_layer * est["decode_steps"]:
        fail(f"attention_launches {replayed} != {n_layer} x decode_steps "
             f"{est['decode_steps']}")
    if ref_calls != 0:
        fail(f"the plain version ran {ref_calls} times on the serving path")
    for mode in ("graph", "eager"):
        for i, r in enumerate(runs[mode]):
            say(f"[serve] [{card}] burst {mode} #{i + 1}: decode step p50 "
                f"{r['decode_step_ms']:.3f} ms over {r['decode_steps']} "
                f"steps, {r['tokens_per_s']:.1f} tokens/s ({r['tokens']} "
                f"tokens in {r['wall_s']:.2f} s), TTFT p50 "
                f"{r['ttft_p50_ms']:.1f} ms")
    steps = decode_step_times(engine, card)
    engine_stats = engine.compile_stats
    paged_attention_cuda.launches = wrapper_launches
    del engine, batcher, captured
    _free_cuda()
    return {"launches": launches, "runs": runs, "steps": steps,
            "compile_stats": dict(engine_stats), **runs["graph"][0]}


def _free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def decode_step_times(engine, card, n=30):
    """One decode step two ways at one state of the serving engine (8
    slots at position 320 over their own blocks, greedy): the replayed
    graph (`engine.decode`: inputs copied in, replay, sample, one
    device-to-host copy) and `smodel.paged_decode_step` called eagerly on
    the same engine state, then the same sampler and copy. Host clock
    around each step, in turns (graph, eager, eager, graph); then the
    device time of one step each: CUDA events around 20 back-to-back
    replays of the decode graph alone, and torch.profiler over 5 steps of
    each (kernel time summed, kernels counted)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from determined_tpu_torch.serve import model as smodel

    slots, mb = engine.slots, engine.max_blocks_per_seq
    tables = np.arange(slots * mb, dtype=np.int32).reshape(slots, mb)
    engine._tables[:] = tables
    tokens = np.random.default_rng(SEED + 9).integers(
        0, engine.cfg.vocab_size, slots).astype(np.int32)
    positions = np.full((slots,), 320, np.int32)
    temps = np.zeros((slots,), np.float32)
    dev = engine.device
    t_tokens, t_pos, t_tables = (torch.from_numpy(a).to(dev)
                                 for a in (tokens, positions, tables))
    t_temps = torch.from_numpy(temps).to(dev)

    def graph_step():
        return engine.decode(tokens, positions, temps)

    def eager_step():
        with torch.inference_mode():
            logits = smodel.paged_decode_step(
                engine.params, engine._cache, t_tokens, t_pos, t_tables,
                engine.cfg, attention_impl=engine.attention_impl)[1]
            return smodel.sample(logits, t_temps, engine._generator).cpu()

    fns = {"graph": graph_step, "eager": eager_step}
    host = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        fns[mode]()
        for _ in range(n):
            t = time.perf_counter()
            fns[mode]()
            host[mode].append(time.perf_counter() - t)
    graph = engine._graphs["decode"][0]
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(20):
        graph.replay()
    e1.record()
    e1.synchronize()
    replay_ms = e0.elapsed_time(e1) / 20
    device = {}
    for mode, fn in fns.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        us, kernels, top = 0.0, 0, []
        for ev in prof.key_averages():
            if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
                continue
            t = getattr(ev, "self_device_time_total", None)
            t = ev.self_cuda_time_total if t is None else t
            if t > 0:
                us += t
                kernels += ev.count
                top.append((t / 1e3 / 5, ev.count / 5, ev.key))
        device[mode] = {"device_ms": us / 1e3 / 5, "kernels": kernels / 5,
                        "top": sorted(top, reverse=True)[:8]}
    out = {mode: {"host_p50_ms": statistics.median(v) * 1e3, **device[mode]}
           for mode, v in host.items()}
    out["replay_event_ms"] = replay_ms
    for mode in ("graph", "eager"):
        r = out[mode]
        say(f"[serve] [{card}] decode step at 8 slots, position 320, "
            f"{mode}: host p50 {r['host_p50_ms']:.3f} ms over {2 * n} steps; "
            f"device {r['device_ms']:.3f} ms a step in {r['kernels']:.0f} "
            f"kernels (torch.profiler, 5 steps; sampler and copies included)")
        for ms, count, name in r["top"]:
            say(f"[serve]   {ms:7.4f} ms a step in {count:5.1f} kernels  "
                f"{name[:100]}")
    say(f"[serve] [{card}] one replay of the decode graph alone: "
        f"{replay_ms:.3f} ms of device time (CUDA events, 20 replays back "
        "to back)")
    return out


# ------------------------------------------------------------ phase 5b, 5c


class EagerTwin:
    """The module functions called eagerly on a copy of an engine's paged
    cache, with the inputs the engine's graphs read: the graphs' yardstick.
    It takes the engine's block tables as they stand after each prefill."""

    def __init__(self, engine):
        self.engine = engine
        self.cache = {k: v.clone() for k, v in engine._cache.items()}

    def prefill_logits(self, slot, tokens, block_table, cached_len):
        import torch

        from determined_tpu_torch.serve import model as smodel

        e, dev = self.engine, self.engine.device
        suffix = tokens[cached_len:]
        padded = torch.zeros(e.bucket_for(len(suffix)), dtype=torch.int32,
                             device=dev)
        padded[:len(suffix)] = torch.from_numpy(suffix).to(dev)
        table = torch.from_numpy(block_table).to(dev)
        with torch.inference_mode():
            return smodel.paged_prefill(e.params, self.cache, padded,
                                        len(suffix), cached_len, table,
                                        e.cfg)[1]

    def decode_logits(self, tokens, positions):
        import torch

        from determined_tpu_torch.serve import model as smodel

        e, dev = self.engine, self.engine.device
        t, p, tbl = (torch.from_numpy(a).to(dev)
                     for a in (tokens, positions, e._tables))
        with torch.inference_mode():
            return smodel.paged_decode_step(
                e.params, self.cache, t, p, tbl, e.cfg,
                attention_impl=e.attention_impl)[1]


def two_prompts(engine, rng):
    """Prompt A (300 tokens: bucket 512) for slot 0 over slot 0's blocks;
    prompt B = A's first 256 tokens + 40 (a prefix-cache hit of 16 blocks,
    its suffix in bucket 64) for slot 1, sharing A's first 16 blocks."""
    import numpy as np

    a = rng.integers(0, engine.cfg.vocab_size, 300).astype(np.int32)
    b = np.concatenate([a[:256], rng.integers(0, engine.cfg.vocab_size, 40)
                        ]).astype(np.int32)
    mb = engine.max_blocks_per_seq
    table_a = np.arange(mb, dtype=np.int32)
    table_b = np.concatenate([table_a[:16], np.arange(
        2 * mb, 3 * mb - 16, dtype=np.int32)])
    return ((0, a, table_a, 0), (1, b, table_b, 256))


def generate_logits(engine, prompts, steps, twin=None):
    """Greedy generation through `engine.prefill_logits` / `decode_logits`
    (the graphs) of `prompts` [(slot, tokens, table, cached_len)], and the
    same inputs through `twin` when given (fed the engine's tokens) ->
    (tokens per slot, engine logits, twin logits, all steps' equal argmax)."""
    import numpy as np

    slots = engine.slots
    last = np.zeros((slots,), np.int32)
    positions = np.zeros((slots,), np.int32)
    got, want, same = [], [], True
    for slot, tokens, table, cached in prompts:
        g = engine.prefill_logits(slot, tokens, block_table=table,
                                  cached_len=cached).clone()
        got.append(g[None])
        if twin is not None:
            w = twin.prefill_logits(slot, tokens, table, cached)
            want.append(w[None])
            same &= int(w.argmax()) == int(g.argmax())
        last[slot], positions[slot] = int(g.argmax()), len(tokens)
    active = [slot for slot, *_ in prompts]
    out_tokens = {slot: [int(last[slot])] for slot in active}
    for _ in range(steps):
        g = engine.decode_logits(last, positions)[active].clone()
        got.append(g)
        if twin is not None:
            w = twin.decode_logits(last, positions)[active]
            want.append(w)
            same &= bool((w.argmax(-1) == g.argmax(-1)).all())
        nxt = g.argmax(-1).int().cpu().numpy()
        for i, slot in enumerate(active):
            last[slot] = nxt[i]
            positions[slot] += 1
            out_tokens[slot].append(int(nxt[i]))
    for slot in active:
        engine.release_slot(slot)
    return out_tokens, got, want, same


def max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def phase_graph_vs_eager(ckpt, card):
    """GPT-2 small at full width, fp32 then bf16, 8 slots, max_seq_len
    1024: two prefills (buckets 512 and 64, the second a prefix-cache hit)
    and 16 decode steps through the engine's graphs and through the module
    functions eagerly on a copy of the same pool. Greedy tokens must be
    equal; fp32 logits within 1e-3 (phase 6's bound). Returns the fp32
    engine's greedy generation for phase 5c."""
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.serve.engine import ServingEngine

    params = gpt2.load_params_npz(ckpt)
    fp32_ref = None
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(gpt2.Config.small(), dtype=dtype)
        engine = ServingEngine(params, cfg, slots=8, max_seq_len=1024,
                               kv_block_size=16, seed=SEED, device="cuda")
        t0 = time.monotonic()
        engine.compile()
        capture_s = time.monotonic() - t0
        prompts = two_prompts(engine, np.random.default_rng(SEED + 10))
        toks, got, want, same = generate_logits(
            engine, prompts, 16, twin=EagerTwin(engine))
        worst = max_diff(got, want)
        bitwise = all(torch.equal(x, y) for x, y in zip(got, want))
        say(f"[graphs] [{card}] GPT-2 small {str(dtype)[6:]}: captured in "
            f"{capture_s:.1f} s; prefills (bucket 512, bucket 64 after a "
            f"256-token prefix hit) + 16 decode steps, graph vs eager: greedy "
            f"tokens equal {same}, max |logit diff| {worst:.3e}, bitwise "
            f"equal {bitwise}")
        if not same:
            fail(f"graph and eager greedy tokens differ ({dtype})")
        if dtype == torch.float32:
            if worst > 1e-3:
                fail(f"graph vs eager fp32 logits differ by {worst:.3e} > "
                     "1e-3")
            # Phase 5c's yardstick: the same two prompts without the
            # prefix hit (the dense layout has no prefix cache), each over
            # its own slot's blocks.
            mb = engine.max_blocks_per_seq
            no_hit = [(s, t, np.arange(s * mb, (s + 1) * mb, dtype=np.int32),
                       0) for s, t, _, _ in prompts]
            toks, got, _, _ = generate_logits(engine, no_hit, 16)
            fp32_ref = (no_hit, toks, got)
        del engine
        _free_cuda()
    return fp32_ref


def phase_dense(ckpt, paged_ref, card):
    """The dense layout at full width: GPT-2 small fp32, attention_impl
    dense, 8 slots, max_seq_len 1024, captured like the paged engine. The
    same two prompts must give the paged replica's greedy tokens, and
    logits within 1e-3."""
    import dataclasses

    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.serve.engine import ServingEngine

    cfg = dataclasses.replace(gpt2.Config.small(), dtype=torch.float32)
    engine = ServingEngine(gpt2.load_params_npz(ckpt), cfg, slots=8,
                           max_seq_len=1024, attention_impl="dense",
                           seed=SEED, device="cuda")
    engine.compile()
    graphs = engine.stats()["cuda_graphs"]
    prompts, want_toks, want = paged_ref
    toks, got, _, _ = generate_logits(engine, prompts, 16)
    worst = max_diff(got, want)
    say(f"[dense] [{card}] GPT-2 small fp32, attention_impl dense, graphs "
        f"{sorted(graphs)}: the two prompts (300 and 296 tokens) + 16 "
        f"decode steps, greedy tokens equal the paged replica's "
        f"{toks == want_toks}, max |logit diff| {worst:.3e} (atol 1e-3)")
    if toks != want_toks or worst > 1e-3:
        fail(f"the dense layout differs from the paged one: tokens equal "
             f"{toks == want_toks}, max |logit diff| {worst:.3e}")
    del engine
    _free_cuda()


# ------------------------------------------------------------------ phase 6


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


# ------------------------------------------------------------------ phase 7


TRAIN_STEPS = 30
TRAIN_REPORT_PERIOD = 5


def write_tokens(workdir, vocab, n_phrases=64, phrase_len=64,
                 n_tokens=1 << 20):
    """A learnable int32 token stream, memmapped: random choices among
    `n_phrases` fixed random phrases (uniform random tokens would sit at
    ln V and show nothing)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    phrases = rng.integers(0, vocab, size=(n_phrases, phrase_len))
    stream = phrases[rng.integers(0, n_phrases, n_tokens // phrase_len)]
    path = os.path.join(workdir, "tokens.int32")
    mm = np.memmap(path, dtype=np.int32, mode="w+", shape=(stream.size,))
    mm[:] = stream.reshape(-1)
    mm.flush()
    del mm
    return path


def train_hparams(workdir):
    """Phase 7's hparams: GPT-2 small, S 1024, B 8, bf16, remat, lr 3e-4,
    on the learnable token stream."""
    return {"model_size": "small", "seq_len": 1024,
            "global_batch_size": 8, "learning_rate": 3e-4,
            "warmup_steps": 5, "decay_steps": 10000, "remat": True,
            "attention_impl": "auto",
            "tokens_path": write_tokens(workdir, 50257)}


def gpt2_trial_class():
    sys.path.insert(0, os.path.join(ROOT, "examples", "gpt2_cuda"))
    from model_def import GPT2Trial

    return GPT2Trial


def phase_train(workdir, hparams):
    import shutil

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    GPT2Trial = gpt2_trial_class()
    ckpt_dir = os.path.join(workdir, "train_checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ctx = core.init(max_length=TRAIN_STEPS, checkpoint_dir=ckpt_dir)
    trial = GPT2Trial(TrialContext(hparams=hparams, core_context=ctx))
    cfg = trial.cfg
    say(f"[train] GPT-2 small: {gpt2.param_count(cfg):,} params, seq_len "
        f"1024, batch 8, {str(cfg.dtype)[6:]}, remat {cfg.remat_policy!r}, "
        f"attention_impl {cfg.attention_impl!r}, {TRAIN_STEPS} steps")
    trainer = Trainer(trial, core_context=ctx)

    # The main path runs from here: every count starts at 0.
    for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
        fn.launches = 0
    fa.reference_attention.calls = 0
    t0 = time.monotonic()
    state = trainer.fit(report_period=TRAIN_REPORT_PERIOD)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"fwd": fa.flash_fwd_cuda.launches,
                "dq": fa.flash_dq_cuda.launches,
                "dkv": fa.flash_dkv_cuda.launches}
    ref_calls = fa.reference_attention.calls

    reports = ctx.train.local_training_metrics
    losses = [r["metrics"]["loss"] for r in reports]
    val = ctx.train.local_validation_metrics
    say(f"[train] fit: {state.step} steps in {wall:.1f} s; loss every "
        f"{TRAIN_REPORT_PERIOD} steps: {[round(x, 4) for x in losses]}; "
        f"validation {val[-1]['metrics'] if val else None}")
    if state.step != TRAIN_STEPS or \
            len(losses) != TRAIN_STEPS // TRAIN_REPORT_PERIOD:
        fail(f"fit ran {state.step} steps with {len(losses)} reports")
    if not all(isinstance(x, float) and x == x and abs(x) != float("inf")
               for x in losses):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0] - 0.5:
        fail(f"the loss did not fall: {losses}")
    n_val = sum(1 for _ in trial.build_validation_data())
    want = {"fwd": (2 * TRAIN_STEPS + n_val) * cfg.n_layer,
            "dq": TRAIN_STEPS * cfg.n_layer, "dkv": TRAIN_STEPS * cfg.n_layer}
    say(f"[train] flash launches {launches} (expected {want}: forward 24 a "
        f"step with the remat recompute, + {cfg.n_layer} a validation "
        f"batch x {n_val}); reference_attention calls {ref_calls}")
    if launches != want:
        fail(f"flash launches {launches} != {want}")
    if ref_calls != 0:
        fail(f"the plain attention ran {ref_calls} times on the training "
             "path")

    # One COMMITTED checkpoint at the op end, read back bit-identical.
    lineage = ctx.checkpoint.lineage()
    sid = f"trial0-step{TRAIN_STEPS}"
    states = [r["state"] for r in ctx.checkpoint.local_reported]
    if lineage != [sid] or states != ["COMPLETED"] or not os.path.exists(
            os.path.join(ckpt_dir, sid, "COMMIT")):
        fail(f"checkpoints: lineage {lineage}, reports {states}")
    restored = ctx.checkpoint.restore_state(sid, state)
    mu, nu = state.opt_state[1]["mu"], state.opt_state[1]["nu"]
    r_mu, r_nu = restored.opt_state[1]["mu"], restored.opt_state[1]["nu"]
    same = (restored.step == state.step
            and restored.opt_state[1]["count"] == state.opt_state[1]["count"]
            and all(torch.equal(a, b) for a, b in zip(
                restored.leaves() + r_mu + r_nu,
                state.leaves() + mu + nu)))
    say(f"[train] checkpoint {sid}: COMMITTED, restore_state bit-identical "
        f"(params, Adam moments, counts): {same}")
    if not same:
        fail("the restored checkpoint differs from the trained state")
    ctx.close()
    # The step time of fit as it runs: its own `steps_per_second` of each
    # report window (host clock from one flush's device-to-host copy to
    # the next's), summed over every window after the first, which holds
    # the warm-up.
    window_s = [TRAIN_REPORT_PERIOD / r["metrics"]["steps_per_second"]
                for r in reports[1:]]
    n_timed = TRAIN_REPORT_PERIOD * len(window_s)
    step_ms = sum(window_s) / n_timed * 1e3
    breakdown = profile_train_steps(trainer, trial)
    # Which route each flash kernel took on the main path, from the kernel
    # functions the profiler saw: bf16 at D 64 must run all three on the
    # tensor cores.
    routes = {}
    for key in ("fwd", "dq", "dkv"):
        names = [g for g in breakdown["groups"]
                 if g.startswith(f"flash_{key}_")]
        if not names:
            fail(f"the profiler saw no flash {key} kernel in the training "
                 "steps")
        routes[key] = "wgmma" if all("wgmma" in n for n in names) else "ffma"
    say(f"[train] flash kernel routes on the main path: {routes}")
    if any(route != "wgmma" for route in routes.values()):
        fail(f"bf16 at D 64 must run the wgmma kernels, ran {routes}")
    idle = max(0.0, 1.0 - breakdown["busy_ms"] / step_ms)
    say(f"[train] fit's step time over steps {TRAIN_REPORT_PERIOD + 1}-"
        f"{TRAIN_STEPS}: {step_ms:.2f} ms a step (report windows "
        f"{[round(w * 1e3 / TRAIN_REPORT_PERIOD, 2) for w in window_s]} ms "
        f"a step); device busy {breakdown['busy_ms']:.2f} ms of it (the "
        f"profiled steps), idle share {idle * 100:.1f}%")
    tokens_per_s = 8 * 1024 / (step_ms / 1e3)
    mfu = gpt2.flops_per_token(cfg, 1024) * tokens_per_s / PEAK_FLOPS[
        "torch.bfloat16"]
    del trainer, state, restored
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms,
            "tokens_per_s": tokens_per_s, "mfu": mfu, "steps": n_timed,
            "idle_share": idle, "breakdown": breakdown, "routes": routes,
            "ckpt_dir": ckpt_dir, "n_val": n_val,
            "losses": {r["steps_completed"]: r["metrics"]["loss"]
                       for r in reports}}


def phase_restored_replica(ckpt_dir, card):
    """A replica restored from `Trainer.fit`'s own checkpoints (phase 7's
    storage): `checkpoint: latest` for the base and one adapter, a second
    committed checkpoint of the trained params whose `wte` is perturbed
    from the seed (trial 1). A newer checkpoint of trial 0 is committed and
    then corrupted first: `latest` must fall back to phase 7's. GPT-2
    small, fp32, 8 slots, max_seq_len 256 (the capture covers 4 buckets).
    Requests for the base and the adapter are answered over HTTP; the
    adapter-routed logits must equal a direct replica of the fine-tune's
    full params within fp32 1e-3 (logits, not tokens)."""
    import numpy as np
    import torch

    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)
    from determined_tpu_torch.serve.http import ServingServer
    from determined_tpu_torch.serve.task import build_replica
    from determined_tpu_torch.train.state import TrainState

    base_ctx = CheckpointContext(ckpt_dir, trial_id=0)
    trained_sid = base_ctx.lineage()[0]
    trained = base_ctx.restore_params(trained_sid)
    gen = torch.Generator().manual_seed(SEED + 8)
    ft = dict(trained)
    ft["wte"] = trained["wte"] + 0.02 * torch.randn(
        trained["wte"].shape, generator=gen)
    ft_sid = CheckpointContext(ckpt_dir, trial_id=1).save_state(
        TrainState(step=TRAIN_STEPS, params=ft, opt_state=None), TRAIN_STEPS)
    bad_sid = base_ctx.save_state(
        TrainState(step=TRAIN_STEPS + 1, params=ft, opt_state=None),
        TRAIN_STEPS + 1)
    victim = os.path.join(ckpt_dir, bad_sid, "state", "state.pt")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    serving = {"model_config": {"model_size": "small", "dtype": "float32"},
               "max_batch_size": 8, "max_seq_len": 256, "kv_block_size": 16,
               "seed": SEED}
    storage = {"type": "shared_fs", "host_path": ckpt_dir}

    # This path runs from here: its counts start at 0.
    paged_attention_cuda.launches = 0
    paged_attention_reference.calls = 0
    engine, batcher = build_replica({
        "serving": {**serving, "checkpoint": "latest",
                    "adapters": [{"name": "ft", "checkpoint": ft_sid}]},
        "checkpoint_storage": storage})
    fell_back = torch.equal(engine.params["wte"].cpu(), trained["wte"])
    say(f"[restore] lineage {base_ctx.lineage()}: the newest, {bad_sid}, "
        f"truncated; `latest` restored {trained_sid}'s params: {fell_back}; "
        f"adapter 'ft' from {ft_sid}")
    if not fell_back:
        fail("checkpoint: latest did not fall back past the corrupt newest "
             "checkpoint")
    batcher.start()
    server = ServingServer(batcher, host="127.0.0.1", port=0).start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    rng = np.random.default_rng(SEED + 11)
    vocab = engine.cfg.vocab_size
    try:
        bodies = [{"tokens": rng.integers(0, vocab, 48).tolist(),
                   "max_new_tokens": 32, "model": m}
                  for m in ("base", "ft", "base", "ft")]
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            results = list(pool.map(lambda b: _post(url, b), bodies))
        status, raw = _get(url.replace("/v1/generate", "/v1/stats"))
        stats = json.loads(raw)
    finally:
        server.stop()
        batcher.stop()
    launches = stats["engine"]["attention_launches"]
    ref_calls = paged_attention_reference.calls
    for i, (code, body) in enumerate(results):
        if code != 200 or len(body.get("tokens", [])) != 32:
            fail(f"restored replica, request {i} ({bodies[i]['model']}): "
                 f"HTTP {code} {body}")
    say(f"[restore] [{card}] 4 requests over HTTP answered 200 with 32 "
        f"tokens, routed {stats['adapter_requests']}; decode steps "
        f"{stats['engine']['decode_steps']}, paged launches replayed "
        f"{launches}, reference calls {ref_calls}")
    if stats["adapter_requests"] != {"base": 2, "ft": 2} or launches <= 0 \
            or ref_calls != 0:
        fail(f"restored replica: routing {stats['adapter_requests']}, "
             f"launches {launches}, reference calls {ref_calls}")
    direct, _ = build_replica({
        "serving": {**serving, "checkpoint": ft_sid},
        "checkpoint_storage": storage})
    direct.compile()
    prompt = rng.integers(0, vocab, 40).astype(np.int32)
    logits = {}
    for name, eng, adapter in (("routed", engine, 1), ("direct", direct, 0)):
        out = [eng.prefill_logits(0, prompt, adapter=adapter).clone()]
        tokens = np.zeros((eng.slots,), np.int32)
        positions = np.zeros((eng.slots,), np.int32)
        for step in range(16):
            # The direct replica is fed the routed run's tokens.
            tokens[0] = int((logits["routed"][step] if name == "direct"
                             else out[-1]).argmax())
            positions[0] = len(prompt) + step
            out.append(eng.decode_logits(tokens, positions)[0].clone())
        logits[name] = out
    worst = max_diff(logits["routed"], logits["direct"])
    base_gap = float((logits["routed"][0] - engine.prefill_logits(
        1, prompt).float()).abs().max())
    say(f"[restore] [{card}] fp32, adapter-routed vs a direct replica of the "
        f"fine-tune, prefill + 16 decode steps (the direct one fed the "
        f"routed tokens): max |logit diff| {worst:.3e} (atol 1e-3); the "
        f"adapter moves the prefill logits from the base's by {base_gap:.3f}")
    if worst > 1e-3 or base_gap < 1e-2:
        fail(f"adapter routing: max |logit diff| {worst:.3e} against a direct "
             f"replica, {base_gap:.3e} against the base")
    del engine, batcher, direct
    _free_cuda()
    replica_drains_on_preemption(
        {**serving, "checkpoint": "latest",
         "adapters": [{"name": "ft", "checkpoint": ft_sid}]}, storage, card)


# ------------------------------------------------------------ phase 7c / 7d


class FakeMaster:
    """An in-process stdlib master speaking the endpoints a managed trial
    and a serve replica call, every request recorded as (method, path,
    query, body). The searcher hands out one op of `length`, then `done`;
    COMPLETED checkpoint reports go into a registry that the lineage
    query returns, newest first. The preemption long-poll is held until
    `arm()` (or, with `preempt_after`, until the training report of that
    step has arrived: that report's answer waits until the signal is out,
    so the trial sees it at that step's poll)."""

    def __init__(self, length=0, preempt_after=None, deadline_s=120):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.requests = []
        self.registry = []
        self.length = length
        self.preempt_after = preempt_after
        self.deadline_s = deadline_s
        self._armed = threading.Event()
        self._sent = threading.Event()
        self._closed = threading.Event()
        master = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _answer(self):
                url = urllib.parse.urlsplit(self.path)
                query = dict(urllib.parse.parse_qsl(url.query))
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n)) if n else None
                out = master.answer(self.command, url.path, query, body)
                data = json.dumps(out).encode()
                try:
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    return  # the client left: a process exited mid-poll
                if out.get("preempt"):
                    master._sent.set()

            do_GET = do_POST = _answer

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    def arm(self):
        self._armed.set()

    def answer(self, method, path, query, body):
        if path.endswith("/signals/preemption"):
            end = time.monotonic() + float(query.get("timeout_seconds", 60))
            while not (self._armed.is_set() or self._closed.is_set()) and \
                    time.monotonic() < end:
                self._armed.wait(0.05)
            if self._armed.is_set():
                return {"preempt": True, "deadline_seconds": self.deadline_s,
                        "reason": "chip_smoke"}
            time.sleep(0.05)
            return {}
        self.requests.append((method, path, query, body))
        if path.endswith("/searcher/operation"):
            return ({"done": True} if int(query["last"]) >= self.length
                    else {"op": {"length": self.length}})
        if path == "/api/v1/checkpoints" and body["state"] == "COMPLETED":
            self.registry.insert(0, body["uuid"])
        if path.endswith("/checkpoints"):
            return {"checkpoints": [{"uuid": u} for u in self.registry]}
        if path.endswith("/metrics") and body["group"] == "training" and \
                body["steps_completed"] == self.preempt_after and \
                not self._armed.is_set():
            self.arm()
            if not self._sent.wait(30):
                fail("the trial never long-polled for preemption")
            time.sleep(0.2)  # the watcher takes the signal in
        return {}

    def posted(self, suffix):
        return [b for m, p, q, b in self.requests
                if m == "POST" and p.endswith(suffix)]

    def release(self):
        """Answer held long-polls at once, so a closing watcher exits."""
        self._closed.set()

    def close(self):
        self.release()
        self._server.shutdown()
        self._server.server_close()


class cluster_env:
    """The `DET_*` variables an agent sets, for the `with` block only."""

    def __init__(self, **env):
        self._env = env

    def __enter__(self):
        self._saved = {k: os.environ.get(k) for k in self._env}
        os.environ.update(self._env)

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def state_tensors(state):
    from determined_tpu_torch.core._checkpoint import _map_tensors

    out = []
    _map_tensors(state, out.append)
    return out


MANAGED_TRIAL = 1
MANAGED_PREEMPT_AT = 15


def phase_managed_trial(workdir, hparams, train, card):
    """GPT-2 small trained as a cluster trial against an in-process fake
    master: `core.init()` reads the `DET_*` environment, the prefetcher
    and async checkpoints are on. Run A is preempted (deadline 120 s)
    after the report of step 15 and must ack, save, commit and register
    trial1-step15 and return there; its losses at 5, 10 and 15 are held
    to phase 7's. Run B, a fresh `core.init()` with
    `DET_LATEST_CHECKPOINT`, restores A's state bitwise, trains to 30,
    commits trial1-step30 and completes the op; the searcher then says
    `done`."""
    import shutil

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    GPT2Trial = gpt2_trial_class()
    storage = os.path.join(workdir, "managed_checkpoints")
    shutil.rmtree(storage, ignore_errors=True)
    sid = f"trial{MANAGED_TRIAL}-step{MANAGED_PREEMPT_AT}"
    base_env = {
        "DET_TRIAL_ID": str(MANAGED_TRIAL), "DET_EXPERIMENT_ID": "1",
        "DET_ALLOCATION_ID": "smoke-alloc", "DET_SESSION_TOKEN": "smoke",
        "DET_HPARAMS": json.dumps(hparams),
        "DET_EXPERIMENT_CONFIG": json.dumps({"checkpoint_storage": {
            "type": "shared_fs", "host_path": storage}})}

    def run(master, **extra):
        with cluster_env(DET_MASTER=master.url, **base_env, **extra):
            ctx = core.init()
            if ctx.info is None or ctx.checkpoint._session is None:
                fail("core.init() did not take the cluster environment")
            trainer = Trainer(GPT2Trial(TrialContext(
                hparams=ctx.hparams, core_context=ctx)), core_context=ctx)
            return ctx, trainer

    # This path runs from here: its counts start at 0.
    for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
        fn.launches = 0
    fa.reference_attention.calls = 0
    master_a = FakeMaster(TRAIN_STEPS, preempt_after=MANAGED_PREEMPT_AT)
    t0 = time.monotonic()
    try:
        ctx, trainer = run(master_a)
        state_a = trainer.fit(report_period=TRAIN_REPORT_PERIOD,
                              preempt_period=TRAIN_REPORT_PERIOD)
        ctx.train.report_progress(state_a.step / TRAIN_STEPS)
        master_a.release()
        ctx.close()
    finally:
        master_a.close()
    wall_a = time.monotonic() - t0
    ckpts_a = [(c["uuid"], c["state"])
               for c in master_a.posted("/api/v1/checkpoints")]
    say(f"[managed] run A: fit returned at step {state_a.step} in "
        f"{wall_a:.1f} s; preemption acked "
        f"{len(master_a.posted('/signals/ack_preemption'))}x; checkpoint "
        f"reports {ckpts_a}; registry {master_a.registry}")
    if state_a.step != MANAGED_PREEMPT_AT or ckpts_a != [
            (sid, "PARTIAL"), (sid, "COMPLETED")] or \
            master_a.registry != [sid] or \
            not master_a.posted("/signals/ack_preemption") or \
            master_a.posted("/searcher/completed_operation"):
        fail("run A did not stop at the preemption with a committed, "
             "registered checkpoint")
    reports_a = [b for b in master_a.posted("/metrics")
                 if b["group"] == "training" and "loss" in b["metrics"]]
    worst = 0.0
    for r in reports_a:
        step = r["steps_completed"]
        diff = abs(r["metrics"]["loss"] - train["losses"][step])
        worst = max(worst, diff)
        say(f"[managed] run A step {step}: loss {r['metrics']['loss']:.6f}, "
            f"phase 7 {train['losses'][step]:.6f}, |diff| {diff:.3e}")
    say(f"[managed] run A losses against phase 7's: max |diff| {worst:.3e} "
        f"(tolerance 1e-5; bitwise equal: {worst == 0.0})")
    if [r["steps_completed"] for r in reports_a] != [5, 10, 15] or \
            worst > 1e-5:
        fail(f"run A's losses differ from phase 7's by {worst:.3e}")

    master_b = FakeMaster(TRAIN_STEPS)
    t0 = time.monotonic()
    try:
        ctx, trainer = run(master_b, DET_LATEST_CHECKPOINT=sid)
        if ctx.latest_checkpoint != sid:
            fail(f"DET_LATEST_CHECKPOINT read as {ctx.latest_checkpoint}")
        restored = ctx.checkpoint.restore_state(sid, state_a)
        got, want = state_tensors(restored), state_tensors(state_a)
        same = len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))
        say(f"[managed] run B: {sid} restored bitwise equal to run A's "
            f"final state ({len(got)} tensors: params and Adam moments): "
            f"{same}")
        if not same:
            fail("the registered checkpoint differs from run A's state")
        del restored, got, want
        state_b = trainer.fit(report_period=TRAIN_REPORT_PERIOD,
                              preempt_period=TRAIN_REPORT_PERIOD)
        ctx.train.report_progress(state_b.step / TRAIN_STEPS)
        master_b.release()
        ctx.close()
    finally:
        master_b.close()
    torch.cuda.synchronize()
    wall_b = time.monotonic() - t0
    launches = {"fwd": fa.flash_fwd_cuda.launches,
                "dq": fa.flash_dq_cuda.launches,
                "dkv": fa.flash_dkv_cuda.launches}
    ref_calls = fa.reference_attention.calls
    end = f"trial{MANAGED_TRIAL}-step{TRAIN_STEPS}"
    ckpts_b = [(c["uuid"], c["state"])
               for c in master_b.posted("/api/v1/checkpoints")]
    ops = master_b.posted("/searcher/completed_operation")
    polls = [q["last"] for m, p, q, b in master_b.requests
             if p.endswith("/searcher/operation")]
    say(f"[managed] run B: fit returned at step {state_b.step} in "
        f"{wall_b:.1f} s; checkpoint reports {ckpts_b}; completed op {ops}; "
        f"searcher polls last={polls}")
    if state_b.step != TRAIN_STEPS or ckpts_b != [
            (end, "PARTIAL"), (end, "COMPLETED")] or len(ops) != 1 or \
            ops[0]["length"] != TRAIN_STEPS or polls != ["0", "30"]:
        fail("run B did not resume, finish the op and stop at done")

    record = master_a.requests + master_b.requests
    steps = sorted(b["steps_completed"] for b in master_a.posted("/metrics")
                   + master_b.posted("/metrics")
                   if b["group"] == "training" and "loss" in b["metrics"])
    counts = {name: sum(1 for m, p, q, b in record if p.endswith(name))
              for name in ("/run_prepare", "/spans", "/progress",
                           "/ack_preemption")}
    completed = [u for u in master_a.registry + master_b.registry]
    say(f"[managed] the master's record: {len(record)} requests; training "
        f"reports at steps {steps}; COMPLETED checkpoints {completed}; "
        f"{counts}; validation reports "
        f"{[b['steps_completed'] for b in master_b.posted('/metrics') if b['group'] == 'validation']}")
    if steps != list(range(5, 31, 5)) or len(completed) != 2 or \
            counts["/run_prepare"] != 2 or counts["/spans"] == 0 or \
            counts["/progress"] != 2 or counts["/ack_preemption"] != 1:
        fail(f"the master's record is incomplete: {steps} {counts}")
    n_layer = trainer.trial.cfg.n_layer
    want = {"fwd": (2 * TRAIN_STEPS + train["n_val"]) * n_layer,
            "dq": TRAIN_STEPS * n_layer, "dkv": TRAIN_STEPS * n_layer}
    say(f"[managed] flash launches over runs A and B {launches} (expected "
        f"{want}); reference_attention calls {ref_calls}")
    if launches != want or ref_calls != 0:
        fail(f"managed trial: flash launches {launches} != {want} or plain "
             f"attention calls {ref_calls}")
    for name, master in (("A", master_a), ("B", master_b)):
        for b in master.posted("/metrics"):
            m = b["metrics"]
            if b["group"] == "training" and "input_wait_ms" in m:
                say(f"[managed] [{card}] run {name} window to step "
                    f"{b['steps_completed']}: "
                    f"{1e3 / m['steps_per_second']:.2f} ms a step, "
                    f"input_wait_ms {m['input_wait_ms']:.4f}, h2d_ms "
                    f"{m['h2d_ms']:.4f}, prefetch_queue_depth "
                    f"{m['prefetch_queue_depth']:.2f}")
    del trainer, state_a, state_b
    _free_cuda()
    return launches


def _span_ms(spans, name, storage_id):
    return sum((s["end_us"] - s["start_us"]) / 1e3 for s in spans
               if s["name"] == name
               and s["attrs"].get("storage_id") == storage_id)


def phase_prefetch_pairs(workdir, hparams, card):
    """Information, not a claim: 15-step fits of phase 7's trial in local
    mode with the prefetcher off and on in turns (off, on, on, off), a
    periodic async checkpoint at step 10 (its write overlaps steps 11-15),
    and fit's step per report window; then the blocking cost of that
    async save (the part save_state paid plus the wait that committed it,
    from the checkpoint spans) against a synchronous save of the same
    state (`async_save` off)."""
    import shutil

    from determined_tpu_torch import core
    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    GPT2Trial = gpt2_trial_class()
    ckpt_dir = os.path.join(workdir, "pair_checkpoints")
    rows = []
    for i, mode in enumerate(("off", "on", "on", "off")):
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        ctx = core.init(max_length=15, checkpoint_dir=ckpt_dir)
        trial = GPT2Trial(TrialContext(hparams=hparams, core_context=ctx))
        trial.prefetch = mode == "on"
        state = Trainer(trial, core_context=ctx).fit(
            report_period=TRAIN_REPORT_PERIOD, checkpoint_period=10)
        ctx.close()
        reports = ctx.train.local_training_metrics
        windows = [1e3 / r["metrics"]["steps_per_second"] for r in reports]
        spans = ctx.tracer.local_spans
        sid = "trial0-step10"
        save_ms = _span_ms(spans, "harness.checkpoint.save", sid)
        commit_ms = _span_ms(spans, "harness.checkpoint.commit", sid)
        rows.append((mode, windows, save_ms, commit_ms, reports[-1]))
        say(f"[pairs] [{card}] #{i + 1} prefetch {mode}: fit's step by "
            f"window (1-5, 6-10, 11-15 with the step-10 write in flight) "
            f"{[round(w, 2) for w in windows]} ms; async save of step 10: "
            f"{save_ms:.1f} ms in save_state + {commit_ms:.1f} ms blocked "
            f"in the wait that committed it")
        if len(windows) != 3:
            fail(f"prefetch pair {i + 1}: {len(windows)} report windows")
        last_state = state
    sync = CheckpointContext(os.path.join(workdir, "sync_checkpoint"),
                             async_save=False)
    sync.save_state(last_state, 15)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shutil.rmtree(os.path.join(workdir, "sync_checkpoint"),
                  ignore_errors=True)
    async_ms = statistics.median(r[2] + r[3] for r in rows)
    size_gb = sum(t.numel() * t.element_size()
                  for t in state_tensors(last_state)) / 1e9
    say(f"[pairs] [{card}] checkpoint of GPT-2 small's train state "
        f"({size_gb:.3f} GB): synchronous last_save_ms "
        f"{sync.last_save_ms:.1f}; async, the loop blocked {async_ms:.1f} "
        f"ms (median of 4)")
    sync_ms = sync.last_save_ms
    del last_state, state, sync
    _free_cuda()
    return {"rows": rows, "sync_ms": sync_ms, "async_ms": async_ms}


REPLICA_PROMPT, REPLICA_NEW_TOKENS = 48, 200


def replica_drains_on_preemption(serving, storage, card):
    """The replica as a cluster runs it (`python -m
    determined_tpu_torch.serve`, a process of its own) attached to a fake
    master: with requests in flight the master answers the allocation's
    preemption long-poll; the replica must ack, report draining, finish
    every accepted request and exit 0."""
    import numpy as np

    from determined_tpu_torch.serve.task import build_model

    vocab = build_model(serving).vocab_size
    master = FakeMaster()
    env = dict(os.environ, PYTHONPATH=ROOT, DET_MASTER=master.url,
               DET_ALLOCATION_ID="smoke-replica",
               DET_SERVING_CONFIG=json.dumps({
                   "serving": {**serving, "heartbeat_period_s": 30},
                   "checkpoint_storage": storage}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "determined_tpu_torch.serve"], cwd=ROOT,
        env=env, stderr=subprocess.PIPE, text=True)
    lines, up = [], threading.Event()

    def read_stderr():
        for line in proc.stderr:
            lines.append(line)
            if "serve replica up on port" in line:
                up.set()

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    try:
        if not up.wait(600):
            fail("the replica process never came up: "
                 + "".join(lines[-20:]))
        port = int(re.search(r"serve replica up on port (\d+)",
                             [x for x in lines if "up on port" in x][0])
                   .group(1))
        url = f"http://127.0.0.1:{port}"
        rng = np.random.default_rng(SEED + 12)
        bodies = [{"tokens": rng.integers(0, vocab, REPLICA_PROMPT).tolist(),
                   "max_new_tokens": REPLICA_NEW_TOKENS, "model": m}
                  for m in ("base", "ft", "base", "ft")]
        pool = concurrent.futures.ThreadPoolExecutor(len(bodies))
        futures = [pool.submit(_post, url + "/v1/generate", b)
                   for b in bodies]
        deadline = time.monotonic() + 120
        while True:
            stats = json.loads(_get(url + "/v1/stats")[1])
            if stats["active"] + stats["completed"] == len(bodies):
                break
            if time.monotonic() > deadline:
                fail(f"the replica never admitted the requests: {stats}")
            time.sleep(0.02)
        in_flight = stats["active"]
        t0 = time.monotonic()
        master.arm()
        rc = proc.wait(timeout=300)
        drain_s = time.monotonic() - t0
        results = [f.result(timeout=60) for f in futures]
        pool.shutdown()
    finally:
        master.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=30)
    est = stats["engine"]
    acks = master.posted("/signals/ack_preemption")
    beats = master.posted("/serve_stats")
    say(f"[restore] [{card}] replica process: {len(bodies)} requests "
        f"accepted, {in_flight} in flight when the master sent the "
        f"preemption; exit code {rc} {drain_s:.2f} s later; answers "
        f"{[(c, len(b.get('tokens', []))) for c, b in results]}; acked "
        f"{len(acks)}x, last heartbeat draining="
        f"{beats[-1]['draining'] if beats else None}; paged launches "
        f"replayed before the drain {est['attention_launches']}, reference "
        f"calls {est['attention_reference_calls']}")
    if rc != 0 or not acks or not beats or not beats[-1]["draining"] or \
            any(c != 200 or len(b.get("tokens", [])) != REPLICA_NEW_TOKENS
                for c, b in results) or est["attention_launches"] <= 0 or \
            est["attention_reference_calls"] != 0:
        fail("the replica did not drain cleanly on the preemption signal: "
             + "".join(lines[-20:]))


def profile_train_steps(trainer, trial, n_steps=3):
    """Device time of `n_steps` more training steps by kernel group, under
    torch.profiler (one stream: kernels do not overlap, so their sum is
    the busy time). The profiler slows the host, so the wall time and
    idle share of these steps are the profiled loop's, not fit's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from determined_tpu_torch.train.trainer import _to_device

    data = iter(trial.build_training_data())
    batches = [_to_device(next(data), trainer.device) for _ in range(n_steps)]
    rng = torch.Generator(device="cuda").manual_seed(SEED)
    step = trainer._train_step
    state = step(trainer.state, batches[0], rng)[0]  # warm, unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            state = step(state, batch, rng)[0]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # One group per flash kernel function (its name and template
    # arguments, so the route that ran shows), then GEMMs and the rest.
    groups = {"gemm": 0.0, "other": 0.0}
    per_kernel = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0:
            continue
        name = ev.key
        per_kernel[name] = per_kernel.get(name, 0.0) + us / 1e3
        flash = re.search(r"flash_\w+_kernel(<[^>]*>)?", name)
        if flash:
            groups[flash.group(0)] = groups.get(flash.group(0), 0.0) + us / 1e3
        elif "gemm" in name.lower() or "sm90_xmma" in name or \
                "cutlass" in name.lower():
            groups["gemm"] += us / 1e3
        else:
            groups["other"] += us / 1e3
    busy = sum(groups.values())
    out = {"groups": {k: v / n_steps for k, v in groups.items()}}
    out["busy_ms"] = busy / n_steps
    out["wall_ms"] = wall_ms / n_steps
    out["idle_share"] = max(0.0, 1.0 - busy / wall_ms)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    say(f"[profile] {n_steps} training steps under torch.profiler: wall "
        f"{out['wall_ms']:.2f} ms a step (the profiled loop), device busy "
        f"{out['busy_ms']:.2f} ms, idle share under the profiler "
        f"{out['idle_share'] * 100:.1f}%; device ms a step by group: "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["groups"].items()))
    for name, ms in top:
        say(f"[profile]   {ms / n_steps:8.3f} ms/step  {name[:110]}")
    return out


# ------------------------------------------------------------ phase 8a-8c


MULTI_STEPS = 4      # steps_per_call of 8a
MULTI_WINDOWS = 2    # the first captures, the second only replays
# 8a's limits, eager against replayed steps from the same state: the
# window-mean loss, grad_norm and all_finite rtol 1e-6, params atol 1e-6.
# The replay holds the eager step's kernels in the eager step's order,
# fed the same optimizer floats (as a device tensor both ways), so the
# two are expected bitwise equal; a calibration run found them so
# (`make_train_step` and the replays, GPT-2 small bf16 and 2 layers fp32).
MULTI_RTOL, MULTI_PARAM_ATOL = 1e-6, 1e-6


def example_tx():
    """The example trial's optimizer chain at phase 7's hparams."""
    from determined_tpu_torch.train import optim

    return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(
        optim.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 10000), b2=0.95,
        weight_decay=0.1))


def token_windows(tokens_path, n_windows, steps, b=8, s=1024, seed=SEED + 21):
    """`n_windows` stacks of `steps` batches [steps, b, s+1] from the token
    stream, on the card."""
    import numpy as np
    import torch

    stream = np.memmap(tokens_path, dtype=np.int32, mode="r")
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_windows):
        starts = rng.integers(0, len(stream) - s - 1, (steps, b))
        win = np.stack([[stream[i:i + s + 1] for i in row] for row in starts])
        out.append(torch.from_numpy(win.astype(np.int32)).cuda())
    return out


def device_ms_per_step(run, n_steps):
    """Kernel time a step of `run()` (n_steps steps) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    busy = 0.0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        busy += max(0.0, us) / 1e3
    return busy / n_steps


def step_order_sum(values):
    """fp32 sum in step order, ((m0 + m1) + m2) + m3, as the replays
    accumulate their metrics."""
    total = values[0].float()
    for v in values[1:]:
        total = total + v.float()
    return total


def phase_multi_step(hparams, card, depth=12):
    """8a: `make_multi_step` (steps_per_call 4) against 4 `make_train_step`
    calls from the same state and batches, GPT-2 small at full width, B 8,
    S 1024, bf16, remat "dots": the first window runs step 0 eagerly and
    captures the step, the second only replays. Window-mean losses and
    grad norms and the params after both windows are held to the eager
    run's (MULTI_RTOL, MULTI_PARAM_ATOL); whether they are bitwise equal is
    printed. The flash kernels must have run inside the replays (the
    launches the captured step holds, times the replays). Then, as
    information: the step time replayed and eager in turns (replay,
    eager, eager, replay), host clock over a window, and torch.profiler's
    device time a step of each."""
    import dataclasses

    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train.state import create_train_state
    from determined_tpu_torch.train.step import make_multi_step, make_train_step

    cfg = dataclasses.replace(gpt2.Config.small(), n_layer=depth)

    def loss(p, b, r):
        return gpt2.loss_fn(p, b, cfg)

    def state_of(tx):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
        return create_train_state(lambda g: gpt2.init(g, cfg), tx, gen,
                                  device="cuda")

    windows = token_windows(hparams["tokens_path"], MULTI_WINDOWS,
                            MULTI_STEPS)
    tx_r, tx_e = example_tx(), example_tx()
    multi = make_multi_step(loss, tx_r, steps_per_call=MULTI_STEPS)
    step = make_train_step(loss, tx_e)
    rng = torch.Generator(device="cuda").manual_seed(SEED + 22)

    # The main path of 8a runs from here: every count starts at 0.
    for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
        fn.launches = 0
    fa.reference_attention.calls = 0
    replayed = state_of(tx_r)
    means_r = []
    for w in windows:
        replayed, m = multi(replayed, {"tokens": w}, rng)
        means_r.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    wrapper = {"fwd": fa.flash_fwd_cuda.launches,
               "dq": fa.flash_dq_cuda.launches,
               "dkv": fa.flash_dkv_cuda.launches}
    in_replays = dict(multi.replayed_launches)
    ref_calls = fa.reference_attention.calls
    eager = state_of(tx_e)
    means_e = []
    for w in windows:
        ms = []
        for i in range(MULTI_STEPS):
            eager, m = step(eager, {"tokens": w[i]}, rng)
            ms.append(m)
        means_e.append({k: float(step_order_sum([x[k] for x in ms])
                                 / MULTI_STEPS) for k in ms[0]})
    torch.cuda.synchronize()
    L = cfg.n_layer
    replays = MULTI_STEPS * MULTI_WINDOWS - 1
    want_graph = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L}
    say(f"[multi] [{card}] GPT-2 small width, {L} layers, B 8, S 1024, bf16, "
        f"remat 'dots': make_multi_step(steps_per_call={MULTI_STEPS}) x "
        f"{MULTI_WINDOWS} windows = 1 eager warm-up step + {replays} "
        f"replays ({multi.replays}); the captured step holds "
        f"{multi._graph_launches} flash launches (expected {want_graph}); "
        f"launched inside the replays {in_replays}; the wrappers' own "
        f"counts (warm-up + capture) {wrapper}; reference calls "
        f"{ref_calls}")
    if multi.replays != replays or multi._graph_launches != want_graph or \
            in_replays != {k: v * replays for k, v in want_graph.items()} \
            or ref_calls:
        fail("the flash kernels did not run inside the multi-step replays")
    worst_rel = 0.0
    for mr, me in zip(means_r, means_e):
        for k in ("loss", "grad_norm", "all_finite"):
            worst_rel = max(worst_rel, abs(mr[k] - me[k]) / max(abs(me[k]),
                                                               1e-12))
    flat_r = gpt2._flatten(replayed.params)
    flat_e = gpt2._flatten(eager.params)
    worst_p, worst_name = 0.0, ""
    for name in flat_e:
        d = float((flat_r[name] - flat_e[name]).detach().abs().max())
        if d > worst_p:
            worst_p, worst_name = d, name
    bitwise = worst_p == 0.0 and all(
        mr[k] == me[k] for mr, me in zip(means_r, means_e) for k in mr)
    say(f"[multi] [{card}] replayed vs eager, {MULTI_STEPS * MULTI_WINDOWS} "
        f"steps: window-mean losses {[m['loss'] for m in means_r]} vs "
        f"{[m['loss'] for m in means_e]}, max rel diff of loss / grad_norm / "
        f"all_finite {worst_rel:.3e} (rtol {MULTI_RTOL}); max |param diff| "
        f"{worst_p:.3e} ({worst_name or 'none'}; atol {MULTI_PARAM_ATOL}); "
        f"bitwise equal: {bitwise}")
    if worst_rel > MULTI_RTOL or worst_p > MULTI_PARAM_ATOL:
        fail("make_multi_step's replays differ from make_train_step's steps")

    # Information: the step replayed against eager, in turns.
    w = windows[0]

    def run_replay():
        multi(replayed, {"tokens": w}, rng)

    def run_eager():
        for i in range(MULTI_STEPS):
            step(eager, {"tokens": w[i]}, rng)

    host = {"replay": [], "eager": []}
    for mode in ("replay", "eager", "eager", "replay"):
        fn = run_replay if mode == "replay" else run_eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host[mode].append((time.perf_counter() - t0) * 1e3 / MULTI_STEPS)
    dev = {"replay": device_ms_per_step(run_replay, MULTI_STEPS),
           "eager": device_ms_per_step(run_eager, MULTI_STEPS)}
    for mode in ("replay", "eager"):
        say(f"[multi] [{card}] {mode}: host {host[mode][0]:.2f} / "
            f"{host[mode][1]:.2f} ms a step (two windows of {MULTI_STEPS}, "
            f"in turns), device {dev[mode]:.2f} ms a step (torch.profiler), "
            f"idle share {max(0.0, 1 - dev[mode] / min(host[mode])) * 100:.1f}"
            f"% of the faster window")
    del replayed, eager, multi
    _free_cuda()
    return {"host": host, "device": dev, "bitwise": bitwise}


REMAT_POLICY_NAMES = (None, "nothing", "dots", "dots_saveable", "everything")
# 8b's limits against "dots": the forward is the same arithmetic under
# every policy (loss rtol 1e-6); the backward differs only in what it
# recomputes with the same kernels (grad_norm rtol 1e-4).
REMAT_LOSS_RTOL, REMAT_NORM_RTOL = 1e-6, 1e-4


def phase_remat_policies(card, depth=2):
    """8b: the five remat policies at full width and 2 layers (B 8, S 1024,
    bf16): loss and grad norm of one forward and backward, held to
    "dots"'s, with the peak memory of each and its flash forward launches
    (two a layer when the recompute runs the kernel again, one under
    "everything")."""
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train import optim

    base = dataclasses.replace(gpt2.Config.small(), n_layer=depth)
    params = gpt2.init(torch.Generator(device="cuda").manual_seed(SEED + 23),
                       base)
    rng = np.random.default_rng(SEED + 24)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, base.vocab_size, (8, 1025)).astype(np.int32)).cuda()}
    leaves = list(gpt2._flatten(params).values())
    for t in leaves:
        t.requires_grad_(True)
    out = {}
    for policy in REMAT_POLICY_NAMES:
        cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fa.flash_fwd_cuda.launches = 0
        loss = gpt2.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        norm = float(optim.global_norm(grads))
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        out[policy] = (float(loss.detach()), norm, peak,
                       fa.flash_fwd_cuda.launches)
        del loss, grads
    ref_loss, ref_norm = out["dots"][:2]
    for policy, (loss, norm, peak, fwd) in out.items():
        want_fwd = depth * (1 if policy == "everything" else 2)
        say(f"[remat] [{card}] {str(policy):13s} loss {loss:.6f} grad_norm "
            f"{norm:.6f} (vs dots: loss {loss - ref_loss:+.2e}, grad_norm "
            f"rel {(norm - ref_norm) / ref_norm:+.2e}); peak memory above "
            f"the params {peak:.3f} GiB; flash forward launches {fwd} "
            f"(expected {want_fwd})")
        if abs(loss - ref_loss) > REMAT_LOSS_RTOL * abs(ref_loss) or \
                abs(norm - ref_norm) > REMAT_NORM_RTOL * ref_norm or \
                fwd != want_fwd:
            fail(f"remat policy {policy!r} differs from 'dots'")
    del params, leaves
    _free_cuda()
    return out


LAUNCHED_TRIAL = 3
LAUNCHED_STEPS = 10
# One rank of 8c's launched trial: the example's GPT2Trial under
# core.init() from the launcher's and the agent's environment. Written
# into build/smoke at run time and started by the port's launcher.
LAUNCHED_WORKER = r'''
import json, os, sys
ROOT = sys.argv[1]
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples", "gpt2_cuda"))
import torch
import torch.distributed as dist
from determined_tpu_torch import core
from determined_tpu_torch.ops import flash_attention as fa
from determined_tpu_torch.train import Trainer
from determined_tpu_torch.train.trial import TrialContext
from model_def import GPT2Trial

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ctx = core.init()
d = ctx.distributed
chief = d.is_chief
out = {"rank": d.rank, "size": d.size, "backend": d.backend,
       "group_backend": dist.get_backend(),
       "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
       "device": torch.cuda.get_device_name(torch.cuda.current_device()),
       "allgather": [b.decode() for b in d.transport.allgather_bytes(
           f"rank{d.rank}".encode())],
       "broadcast": d.transport.broadcast_bytes(
           b"from the chief" if chief else b"", chief).decode()}
trial = GPT2Trial(TrialContext(hparams=ctx.hparams, core_context=ctx,
                               n_devices=d.size))
trainer = Trainer(trial, core_context=ctx)
for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
    fn.launches = 0
fa.reference_attention.calls = 0
state = trainer.fit(report_period=5, preempt_period=5)
torch.cuda.synchronize()
out.update(mesh=dict(zip(trainer.mesh.mesh_dim_names,
                         trainer.mesh.mesh.shape)),
           step=state.step,
           launches={"fwd": fa.flash_fwd_cuda.launches,
                     "dq": fa.flash_dq_cuda.launches,
                     "dkv": fa.flash_dkv_cuda.launches},
           reference_calls=fa.reference_attention.calls)
print("RESULT " + json.dumps(out), flush=True)
ctx.close()
'''


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_trial(workdir, hparams, storage, nproc, slots, backend=None,
                 trial_id=LAUNCHED_TRIAL, timeout=900):
    """The example trial through `python -m
    determined_tpu_torch.launch.torch_distributed` against a fresh fake
    master with one op of LAUNCHED_STEPS: -> (each rank's RESULT, the
    master, the launcher's exit code, its output)."""
    script = os.path.join(workdir, "launched_worker.py")
    with open(script, "w") as f:
        f.write(LAUNCHED_WORKER)
    master = FakeMaster(LAUNCHED_STEPS)
    env = dict(os.environ)
    env.update({
        "DET_MASTER": master.url, "DET_TRIAL_ID": str(trial_id),
        "DET_EXPERIMENT_ID": "1", "DET_ALLOCATION_ID": f"launched-{nproc}",
        "DET_SESSION_TOKEN": "smoke", "DET_HPARAMS": json.dumps(hparams),
        "DET_EXPERIMENT_CONFIG": json.dumps({"checkpoint_storage": {
            "type": "shared_fs", "host_path": storage}}),
        "DET_TORCH_MASTER_PORT": str(free_port()),
        "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", "")})
    for k in ("DET_SLOT_IDS", "DET_TORCH_BACKEND", "CUDA_VISIBLE_DEVICES"):
        env.pop(k, None)
    if slots is not None:
        env["DET_SLOT_IDS"] = slots
    if backend is not None:
        env["DET_TORCH_BACKEND"] = backend
    try:
        proc = subprocess.run(
            [sys.executable, "-m",
             "determined_tpu_torch.launch.torch_distributed",
             "--nproc-per-node", str(nproc), "--", sys.executable, script,
             ROOT], env=env, cwd=ROOT, capture_output=True, text=True,
            timeout=timeout)
    finally:
        master.release()
        master.close()
    results = {}
    for line in proc.stdout.splitlines():
        if "RESULT " in line:
            r = json.loads(line.split("RESULT ", 1)[1])
            results[r["rank"]] = r
    return results, master, proc.returncode, proc.stdout + proc.stderr


def phase_launched_trial(workdir, hparams, card, train=None):
    """8c: the example GPT-2 trial launched by the port's launcher on GPU
    slot 0 (`DET_SLOT_IDS="[0]"`) against the fake master of 7c, 10 steps
    at phase 7's hparams: the worker must see its slot, form a real NCCL
    process group (with the gloo control group beside it) and a
    DeviceMesh of the world, run the flash kernels, report through the
    chief and commit a checkpoint the master registers; a serve replica
    then restores it and its logits must equal the restored params'
    forward (fp32, 1e-3)."""
    import shutil

    import numpy as np
    import torch

    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.serve.task import build_replica

    storage = os.path.join(workdir, "launched_checkpoints")
    shutil.rmtree(storage, ignore_errors=True)
    t0 = time.monotonic()
    results, master, rc, log = launch_trial(workdir, hparams, storage, 1,
                                            "[0]")
    wall = time.monotonic() - t0
    with open(os.path.join(workdir, "launched_trial.log"), "w") as f:
        f.write(log)
    if rc != 0 or list(results) != [0]:
        say(log[-3000:])
        fail(f"the launched trial exited {rc} with results from ranks "
             f"{list(results)}")
    r = results[0]
    sid = f"trial{LAUNCHED_TRIAL}-step{LAUNCHED_STEPS}"
    losses = [b["metrics"]["loss"] for b in master.posted("/metrics")
              if b["group"] == "training" and "loss" in b["metrics"]]
    ops = [q for m, p, q, b in master.requests
           if p.endswith("/searcher/operation")]
    L = 12
    n_val = 4
    want = {"fwd": (2 * LAUNCHED_STEPS + n_val) * L,
            "dq": LAUNCHED_STEPS * L, "dkv": LAUNCHED_STEPS * L}
    say(f"[launch] [{card}] 1 slot: the worker saw CUDA_VISIBLE_DEVICES="
        f"{r['cuda_visible_devices']} ({r['device']}), rank {r['rank']} of "
        f"{r['size']}, process group {r['group_backend']}, DeviceMesh "
        f"{r['mesh']}; gloo control plane: allgather {r['allgather']}, "
        f"broadcast {r['broadcast']!r}; searcher polls {len(ops)}, losses "
        f"{[round(x, 4) for x in losses]}, step {r['step']}, registry "
        f"{master.registry}, flash launches {r['launches']} (expected "
        f"{want}), reference calls {r['reference_calls']}; {wall:.1f} s")
    if r["cuda_visible_devices"] != "0" or r["group_backend"] != "nccl" \
            or r["size"] != 1 or r["mesh"].get("data") != 1 or \
            r["allgather"] != ["rank0"] or \
            r["broadcast"] != "from the chief" or r["step"] != \
            LAUNCHED_STEPS or master.registry != [sid] or \
            r["launches"] != want or r["reference_calls"] or \
            len(losses) != LAUNCHED_STEPS // 5 or \
            not master.posted("/searcher/completed_operation"):
        fail("the launched trial did not train through its slot's process "
             "group as expected")
    if train is not None:
        diffs = [abs(x - train["losses"][5 * (i + 1)])
                 for i, x in enumerate(losses)]
        say(f"[launch] losses at 5 and 10 against phase 7's: max |diff| "
            f"{max(diffs):.3e} (tolerance 1e-5; bitwise equal: "
            f"{max(diffs) == 0.0})")
        if max(diffs) > 1e-5:
            fail("the launched trial's losses differ from phase 7's")

    params = CheckpointContext(storage, trial_id=LAUNCHED_TRIAL
                               ).restore_params(sid)
    engine, _ = build_replica({
        "serving": {"model_config": {"model_size": "small",
                                     "dtype": "float32"},
                    "max_batch_size": 1, "max_seq_len": 256,
                    "kv_block_size": 16, "seed": SEED,
                    "checkpoint": sid},
        "checkpoint_storage": {"type": "shared_fs", "host_path": storage}})
    prompt = np.random.default_rng(SEED + 25).integers(
        0, 50257, 40).astype(np.int32)
    served = engine.prefill_logits(0, prompt).float()
    cfg = gpt2.Config(dtype=torch.float32)
    with torch.no_grad():
        direct = gpt2.apply(gpt2.map_params(lambda t: t.cuda(), params),
                            torch.from_numpy(prompt[None]).cuda(), cfg)[0, -1]
    worst = float((served.reshape(-1) - direct.float()).abs().max())
    say(f"[launch] [{card}] a serve replica restored {sid} from the "
        f"launched trial's storage: last-position logits against the "
        f"restored params' forward, max |diff| {worst:.3e} (atol 1e-3)")
    if worst > 1e-3:
        fail("the replica's logits differ from the launched trial's params")
    del engine, params
    _free_cuda()
    return {"losses": losses, "wall_s": wall}


# ------------------------------------------------------------------ phase 9


def phase_train_parity():
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.train import optim
    from determined_tpu_torch.train.state import create_train_state
    from determined_tpu_torch.train.step import make_train_step

    cfg = dataclasses.replace(gpt2.Config.small(), n_layer=2,
                              dtype=torch.float32)
    params0 = gpt2.init(torch.Generator(device="cuda").manual_seed(SEED + 5),
                        cfg)
    rng = np.random.default_rng(SEED + 6)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 1025)).astype(np.int32)).cuda()}
        for _ in range(3)]
    runs, grads = {}, {}
    for impl in ("kernel", "reference"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        flat = gpt2._flatten(params0)
        leaves = [t.detach().clone().requires_grad_() for t in flat.values()]
        loss = gpt2.loss_fn(gpt2._unflatten(dict(zip(flat, leaves))),
                            batches[0], c)
        grads[impl] = dict(zip(flat, torch.autograd.grad(loss, leaves)))
        tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(
            optim.warmup_cosine_decay_schedule(0.0, 1e-5, 1, 10000),
            b2=0.95, weight_decay=0.1))
        params = gpt2.map_params(lambda t: t.clone(), params0)
        state = create_train_state(lambda g: params, tx, None)
        step = make_train_step(lambda p, b, r: gpt2.loss_fn(p, b, c), tx)
        losses, norms = [], []
        for batch in batches:
            state, m = step(state, batch, None)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        runs[impl] = (losses, norms, [t.detach() for t in state.leaves()])
    (lk, nk, pk), (lr_, nr, pr) = runs["kernel"], runs["reference"]
    loss_diff = max(abs(a - b) for a, b in zip(lk, lr_))
    norm_rel = max(abs(a - b) / b for a, b in zip(nk, nr))
    param_diff = max(float((a - b).abs().max()) for a, b in zip(pk, pr))
    # Each leaf's gradient, relative to that leaf's largest element.
    grad_name, grad_rel = max(
        ((name, float((g - grads["reference"][name]).abs().max()
                      / grads["reference"][name].abs().max()))
         for name, g in grads["kernel"].items()), key=lambda kv: kv[1])
    say(f"[parity] fp32 GPT-2 small width, 2 layers, B 2, S 1024: step-0 "
        f"gradients, max |diff| / max |grad| of a leaf {grad_rel:.3e} "
        f"({grad_name}; limit 1e-5); 3 steps: losses "
        f"{[round(x, 6) for x in lk]} vs {[round(x, 6) for x in lr_]}, max "
        f"|loss diff| {loss_diff:.3e} (atol 1e-5), grad_norm rel "
        f"{norm_rel:.3e} (1e-4), max |param diff| {param_diff:.3e} (atol "
        "1e-6)")
    if grad_rel > 1e-5 or loss_diff > 1e-5 or norm_rel > 1e-4 or \
            param_diff > 1e-6:
        fail("training through the kernels differs from the plain version")


# ----------------------------------------------------------------- phase 10


# Device cycles of the wait before each timed launch: ~1 ms at the H100's
# clocks, longer than the host takes to reach the launch.
SLEEP_CYCLES = 2_000_000


def time_cold(fn, args, flush, iters=50, hide_host=True,
              sleep_cycles=SLEEP_CYCLES):
    """Median ms of `fn(*args)` over `iters` launches, each timed with its
    own CUDA events after a write that evicts the 50 MB L2. A device-side
    wait sits between the flush and the first event: the host's launch
    work (the wrapper's checks, the ctypes call) then overlaps it, and the
    events bracket the device's work alone, not the device idling until
    the launch arrives. `hide_host=False` leaves the wait out (PR 2's
    method): the time then holds whatever of the host's launch work
    outlasts the flush."""
    import torch

    for _ in range(3):
        fn(*args)
    times = []
    for _ in range(iters):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(sleep_cycles)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def paged_bound(slots, pos, H=12, Dh=64, itemsize=2):
    """(least ms, what bounds it, bytes) of one paged launch with every slot
    at `pos`: q read and out written once, the visible K and V rows read
    once, the table entries and positions read once, at 3.35 TB/s; its
    4 (pos + 1) H Dh flops a slot at the bf16 peak."""
    keys = slots * (pos + 1)
    mb = -(-(pos + 1) // 16)
    nbytes = (2 * slots * H * Dh * itemsize + 2 * keys * H * Dh * itemsize
              + slots * mb * 4 + slots * 4)
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = 4 * keys * H * Dh / PEAK_FLOPS["torch.bfloat16"]
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", nbytes)


def paged_inputs(slots, pos, gen, H=12, Dh=64, bs=16):
    """bf16 kernel inputs with every slot at `pos`, a permuted pool of
    max(64, enough) blocks a slot (64: the serving run's max_seq_len 1024),
    and the same lane gathered for the library call: [slots, H, S, Dh]."""
    import torch

    mb = max(64, -(-(pos + 1) // bs))
    P = slots * mb + 1
    dtype = torch.bfloat16
    q = torch.randn(slots, H, Dh, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(P, bs, H, Dh, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(P, bs, H, Dh, generator=gen, device="cuda").to(dtype)
    tables = torch.randperm(P - 1, generator=gen, device="cuda")
    tables = tables.reshape(slots, mb).to(torch.int32).contiguous()
    pos_t = torch.full((slots,), pos, dtype=torch.int32, device="cuda")
    lanes = [p[tables.long()].reshape(slots, mb * bs, H, Dh).transpose(1, 2)
             .contiguous() for p in (kp, vp)]
    mask = (torch.arange(mb * bs, device="cuda")[None, :]
            <= pos_t[:, None].long())[:, None, None, :]
    return (q, kp, vp, tables, pos_t), (q[:, :, None, :], *lanes, mask)


def phase_paged_times(card):
    import torch
    import torch.nn.functional as F

    from determined_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)

    def sdpa(q4, k4, v4, m4):
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    launches0 = paged_attention_cuda.launches
    rows = {}
    for slots in (8, 1):
        for pos in (1023, 320, 4095):
            args, lib_args = paged_inputs(slots, pos, gen)
            ms = time_cold(paged_attention_cuda, args, flush)
            library_ms = time_cold(sdpa, lib_args, flush)
            bound_ms, bound_by, nbytes = paged_bound(slots, pos)
            rows[slots, pos] = {"ms": ms, "library_ms": library_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by}
            if (slots, pos) == (8, 1023):  # the row of the kernels line
                rows[slots, pos]["plain_ms"] = time_cold(
                    paged_attention_reference, args, flush)
            say(f"[times] [{card}] paged_attention bf16 slots={slots} H=12 "
                f"Dh=64 bs=16 pos={pos}: kernel {ms:.4f} ms, SDPA over the "
                f"gathered lane {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {nbytes / 1e6:.2f} MB at 3.35 TB/s; "
                f"{bound_ms / ms * 100:.1f}% of bound)"
                + (f", plain {rows[slots, pos]['plain_ms']:.4f} ms"
                   if "plain_ms" in rows[slots, pos] else ""))
            del args, lib_args
    # A decode step's 12 launches at pos 320, as serving makes them: one a
    # layer, each over its own layer's pool, timed together after one
    # flush (the 12 pools, 151 MB, do not fit in L2).
    layers = [paged_inputs(8, 320, gen)[0] for _ in range(12)]
    step_ms = time_cold(lambda: [paged_attention_cuda(*a) for a in layers],
                        (), flush, sleep_cycles=4 * SLEEP_CYCLES)
    paged_attention_cuda.launches = launches0  # timing runs do not count
    say(f"[times] [{card}] paged_attention bf16 slots=8 pos=320: 12 "
        f"launches x one launch's time = {12 * rows[8, 320]['ms']:.4f} ms; "
        f"12 launches over 12 layers' pools, timed together = "
        f"{step_ms:.4f} ms a decode step")
    del layers
    head = dict(rows[8, 1023])
    head["times"] = {f"slots{s}_pos{p}": r for (s, p), r in rows.items()}
    head["decode_step_12_launches_ms"] = step_ms
    return head


def flash_bound(b, s, h, d, causal=True, bf16=False):
    """The least time (ms) each flash kernel could take at this shape with
    bf16 inputs, and what bounds it: bytes (each input read once, each
    output written once, at 3.35 TB/s) or operations at the bf16 tensor
    rate. Q.K^T and dO.V^T are one bf16 product each. A product with P or
    dS in it is fp32 on the training path: it counts as three bf16
    products, the exact split, the least exact route on this card (one
    with `bf16`, which rounds P and dS). So the forward does 1 + 3, dQ
    2 + 3 and dK/dV 2 + 3 + 3 products of 2 S^2 D (causal: S(S+1)/2
    pairs) per head."""
    pairs = (s * (s + 1) // 2 if causal else s * s) * b * h
    prod = 2.0 * pairs * d  # FLOPs of one [S, S] x [S, D] product
    split = 1 if bf16 else 3
    tensor = b * s * h * d * 2
    stat = b * h * s * 4
    work = {"fwd": (4 * tensor + stat, 1 + split),
            "dq": (5 * tensor + 2 * stat, 2 + split),
            "dkv": (6 * tensor + 2 * stat, 2 + 2 * split)}
    out = {}
    for name, (nbytes, n_prod) in work.items():
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = n_prod * prod / PEAK_FLOPS["torch.bfloat16"]
        out[name] = (max(bytes_s, ops_s) * 1e3,
                     "bytes" if bytes_s >= ops_s else "operations", nbytes)
    return out


def phase_flash_times(card):
    import torch
    import torch.nn.functional as F

    from determined_tpu_torch.ops import flash_attention as fa

    b, s, h, d = FLASH_CASES[0][:4]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q, k, v, dout = flash_inputs(b, s, h, d, torch.bfloat16, gen)
    counts = [fn.launches for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda,
                                     fa.flash_dkv_cuda)]
    o, lse = fa.flash_fwd_cuda(q, k, v)
    delta = fa.flash_delta(dout, o)
    bwd_args = (q, k, v, dout, lse, delta)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    ms, ms_bf16 = {}, {}
    for out, bf16 in ((ms, False), (ms_bf16, True)):
        out["fwd"] = time_cold(fa.flash_fwd_cuda, (q, k, v, True, bf16),
                               flush)
        out["dq"] = time_cold(fa.flash_dq_cuda, (*bwd_args, True, bf16),
                              flush)
        out["dkv"] = time_cold(fa.flash_dkv_cuda, (*bwd_args, True, bf16),
                               flush)
    with_host = {
        "fwd": time_cold(fa.flash_fwd_cuda, (q, k, v), flush,
                         hide_host=False),
        "dq": time_cold(fa.flash_dq_cuda, bwd_args, flush, hide_host=False),
        "dkv": time_cold(fa.flash_dkv_cuda, bwd_args, flush,
                         hide_host=False)}
    plain = {"fwd": time_cold(fa.flash_fwd_reference, (q, k, v), flush,
                              iters=10),
             "dq": time_cold(fa.flash_dq_reference, bwd_args, flush,
                             iters=10),
             "dkv": time_cold(fa.flash_dkv_reference, bwd_args, flush,
                              iters=10)}
    for fn, n in zip((fa.flash_fwd_cuda, fa.flash_dq_cuda,
                      fa.flash_dkv_cuda), counts):
        fn.launches = n  # timing runs do not count
    # The yardstick: SDPA over [B, H, S, D] copies (the port never calls
    # it). It rounds P and dS to bf16: its like-for-like row is the
    # kernels' `bf16=True` time.
    q4, k4, v4, do4 = (t.transpose(1, 2).contiguous()
                       for t in (q, k, v, dout))
    lib_fwd = time_cold(
        lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c,
                                                        is_causal=True),
        (q4, k4, v4), flush)
    leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib_bwd = time_cold(
        lambda: torch.autograd.grad(out, leaves, do4, retain_graph=True),
        (), flush)
    library = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}
    bounds = flash_bound(b, s, h, d)
    bounds_bf16 = flash_bound(b, s, h, d, bf16=True)
    for name in ("fwd", "dq", "dkv"):
        bound_ms, bound_by, nbytes = bounds[name]
        say(f"[times] [{card}] flash {name} bf16 B{b} S{s} H{h} D{d} causal: "
            f"kernel {ms[name]:.4f} ms, plain {plain[name]:.4f} ms, library "
            f"{library[name]:.4f} ms (SDPA {'forward' if name == 'fwd' else 'autograd backward, dQ+dK+dV'}), "
            f"bound {bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB; "
            f"{bound_ms / ms[name] * 100:.1f}% of bound); with bf16=True "
            f"(P and dS rounded, as SDPA): kernel {ms_bf16[name]:.4f} ms, "
            f"bound {bounds_bf16[name][0]:.4f} ms "
            f"({bounds_bf16[name][0] / ms_bf16[name] * 100:.1f}% of "
            f"bound); timed with the host's launch work (PR 2's method) "
            f"{with_host[name]:.4f} ms")
    return {name: {"ms": ms[name], "plain_ms": plain[name],
                   "library_ms": library[name], "bound_ms": bounds[name][0],
                   "bound_by": bounds[name][1], "bf16_ms": ms_bf16[name],
                   "bf16_bound_ms": bounds_bf16[name][0],
                   "with_host_ms": with_host[name]}
            for name in ("fwd", "dq", "dkv")}


# ------------------------------------------------------------------ main


FLASH_KERNELS = (  # (key, name, TPU kernel it replaces)
    ("fwd", "flash_fwd", "determined_tpu/ops/flash_attention.py:137"),
    ("dq", "flash_dq", "determined_tpu/ops/flash_attention.py:245"),
    ("dkv", "flash_dkv", "determined_tpu/ops/flash_attention.py:293"))


def main() -> int:
    card = phase_device()
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.monotonic()
    phase_build()
    paged_err = phase_kernel_check()
    flash_err = phase_flash_check()
    workdir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    ckpt = write_model(workdir)
    serve = phase_serve(workdir, ckpt, card)
    paged_ref = phase_graph_vs_eager(ckpt, card)
    phase_dense(ckpt, paged_ref, card)
    phase_parity(ckpt)
    hparams = train_hparams(workdir)
    train = phase_train(workdir, hparams)
    phase_restored_replica(train["ckpt_dir"], card)
    managed_launches = phase_managed_trial(workdir, hparams, train, card)
    pairs = phase_prefetch_pairs(workdir, hparams, card)
    multi = phase_multi_step(hparams, card)
    phase_remat_policies(card)
    phase_launched_trial(workdir, hparams, card, train)
    phase_train_parity()
    paged = phase_paged_times(card)
    flash = phase_flash_times(card)
    graph = serve["runs"]["graph"]
    say(f"[times] [{card}] serving: compile() prepared the sampler in "
        f"{serve['compile_stats']['sample_s']} s; the first graph burst "
        f"ran {graph[0]['tokens_per_s']:.1f} tokens/s, the second "
        f"{graph[1]['tokens_per_s']:.1f}: the second "
        f"{graph[1]['tokens_per_s'] / graph[0]['tokens_per_s']:.2f}x the "
        f"first")
    say(f"[times] [{card}] managed trial: flash launches {managed_launches}; "
        f"checkpoint of the train state: synchronous {pairs['sync_ms']:.1f} "
        f"ms, async {pairs['async_ms']:.1f} ms blocking the loop")
    for mode in ("graph", "eager"):
        r = serve["runs"][mode][0]
        say(f"[times] [{card}] serving GPT-2 small bf16, 8 slots, {mode} "
            f"(first {mode} burst): decode step p50 "
            f"{r['decode_step_ms']:.3f} ms over {r['decode_steps']} steps, "
            f"{r['tokens_per_s']:.1f} tokens/s ({r['tokens']} tokens in "
            f"{r['wall_s']:.2f} s), TTFT p50 {r['ttft_p50_ms']:.1f} ms; one "
            f"step at 8 slots, position 320: host p50 "
            f"{serve['steps'][mode]['host_p50_ms']:.3f} ms, device "
            f"{serve['steps'][mode]['device_ms']:.3f} ms")
    say(f"[times] [{card}] training GPT-2 small bf16, B 8, S 1024, through "
        f"Trainer.fit: step {train['step_ms']:.2f} ms (mean over "
        f"{train['steps']} steps after the first report window), "
        f"{train['tokens_per_s']:.0f} tokens/s, MFU "
        f"{train['mfu'] * 100:.2f}% of 989 TFLOP/s, device idle share "
        f"{train['idle_share'] * 100:.1f}%")
    host = {k: " / ".join(f"{x:.2f}" for x in v)
            for k, v in multi["host"].items()}
    say(f"[times] [{card}] GPT-2 small bf16, B 8, S 1024, 4 steps a window "
        f"(8a, in turns): replayed host {host['replay']} ms a step, device "
        f"{multi['device']['replay']:.2f}; eager host {host['eager']} ms a "
        f"step, device {multi['device']['eager']:.2f}; bitwise equal: "
        f"{multi['bitwise']}")
    say(f"[done] all phases passed in {time.monotonic() - t_start:.1f} s")
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "kernel_route": "ffma",
        "source": "determined_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "determined_tpu/ops/paged_attention.py:99",
        "launches": serve["launches"],
        "max_abs_err": paged_err,
        **paged,
    }]
    for key, name, replaces in FLASH_KERNELS:
        kernels.append({
            "name": name,
            "route": "cuda",
            "kernel_route": train["routes"][key],
            "source": "determined_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": train["launches"][key],
            "max_abs_err": flash_err[key],
            **flash[key],
        })
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
