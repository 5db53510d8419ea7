#!/usr/bin/env python3
"""`chip_smoke.py` phase 20 alone: the kernels built, 20a, then 20b.

    python3 tools/chip_phase20.py [--per-case]

Run on a host with four cards (with one, 20b prints that it did not run).
`--per-case` launches a world for each case of 20b, so that a case that
fails does not end the others. `P20_TIMEOUT` (seconds, default 900) is
the limit of each launched world. Prints what the two phases print, and
`[p20] <seconds>` last; a phase that fails prints its traceback and
`[20a] FAILED` or `[20b] FAILED`.
"""
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def main() -> int:
    per_case = "--per-case" in sys.argv
    t0 = time.monotonic()
    card = cs.phase_device()
    import torch

    cs.say(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
           f"{torch.cuda.nccl.version()} python {sys.version.split()[0]}")
    cs.phase_build()
    workdir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    hparams = cs.train_hparams(workdir)
    ok = True
    try:
        cs.phase_capture_collectives(card)
    except BaseException:
        traceback.print_exc()
        cs.say("[20a] FAILED")
        ok = False
    try:
        cs.phase_multi_mesh(workdir, hparams, card, per_case=per_case,
                            timeout=int(os.environ.get("P20_TIMEOUT", "900")))
    except BaseException:
        traceback.print_exc()
        cs.say("[20b] FAILED")
        ok = False
    cs.say(f"[p20] {time.monotonic() - t0:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
