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
  5. serving at full width: GPT-2 small (124M, random weights from a seed)
     saved with `save_params_npz`, served through `build_replica` and
     `ServingServer` in bf16 (8 slots, max_seq_len 1024, KV block 16,
     prefix cache on). Eight concurrent requests share a 256-token prefix
     and carry distinct 32-token suffixes (64 new tokens, temperature 0),
     plus one at temperature 0.8. Every response must be 200 with 64
     tokens, the prefix cache must hit, every decode step must launch the
     paged kernel once per layer, and its plain version must never run.
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
  8. training parity in fp32: the same GPT-2 small-width params (2 layers)
     and batches through the kernels and through the plain attention.
     Every leaf's step-0 gradient must agree to 1e-5 of that leaf's
     largest element. Then 3 optimizer steps (lr 0, then 1e-5): losses
     must agree to 1e-5, grad_norm to 1e-4 of itself and params to 1e-6
     (Adam moves a weight by about lr a step whatever the gradient's
     scale, so the params see a gradient's signs; the gradients and
     grad_norm see its size).
  9. times on the card (CUDA events, L2 flushed before every launch, the
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
     main paths: the decode step, tokens/s and TTFT of serving; the
     training step of `Trainer.fit` as it runs (its `steps_per_second`
     over the report windows after the first), tokens/s, MFU
     (`flops_per_token` against 989 TFLOP/s), and the device's idle share
     of that step from the device time of 3 more steps under
     torch.profiler.

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


def phase_train(workdir):
    import shutil

    import torch

    sys.path.insert(0, os.path.join(ROOT, "examples", "gpt2_cuda"))
    from model_def import GPT2Trial

    from determined_tpu_torch import core
    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    ckpt_dir = os.path.join(workdir, "train_checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    hparams = {"model_size": "small", "seq_len": 1024,
               "global_batch_size": 8, "learning_rate": 3e-4,
               "warmup_steps": 5, "decay_steps": 10000, "remat": True,
               "attention_impl": "auto",
               "tokens_path": write_tokens(workdir, 50257)}
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
            "idle_share": idle, "breakdown": breakdown, "routes": routes}


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


# ------------------------------------------------------------------ phase 8


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


# ------------------------------------------------------------------ phase 9


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
    serve = phase_serve(workdir, ckpt)
    phase_parity(ckpt)
    train = phase_train(workdir)
    phase_train_parity()
    paged = phase_paged_times(card)
    flash = phase_flash_times(card)
    say(f"[times] [{card}] serving GPT-2 small bf16, 8 slots: decode step "
        f"p50 {serve['decode_step_ms']:.3f} ms over {serve['decode_steps']} "
        f"steps, {serve['tokens_per_s']:.1f} tokens/s ({serve['tokens']} "
        f"tokens in {serve['wall_s']:.2f} s), TTFT p50 "
        f"{serve['ttft_p50_ms']:.1f} ms")
    say(f"[times] [{card}] training GPT-2 small bf16, B 8, S 1024, through "
        f"Trainer.fit: step {train['step_ms']:.2f} ms (mean over "
        f"{train['steps']} steps after the first report window), "
        f"{train['tokens_per_s']:.0f} tokens/s, MFU "
        f"{train['mfu'] * 100:.2f}% of 989 TFLOP/s, device idle share "
        f"{train['idle_share'] * 100:.1f}%")
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
