#!/usr/bin/env python3
"""Some of `chip_smoke.py`'s phases alone, each whatever the others do.

    python3 tools/chip_phases.py PHASE [PHASE ...] [--timeout S]

PHASE is one of 7, 11a, 12a, 12d, 16b, 16d, 17b, 18b, 20a, 20b, 21, 22a,
22b, 22c, 23a, 23b (phase 5 first, its greedy request 23b's reference)
and `destroy` (tools/nccl_graph_destroy.py in a subprocess).
The card is checked and the kernels built first (phases 1 and 2); then
each phase in the order given. A phase that fails prints its traceback
and `[PHASE] FAILED`, and the next one runs. 20b and 22b launch a world
for each case (a case that fails does not end the others); `--timeout`
is the limit of each world they launch (default 900 s). Exits 1 when a
phase failed; prints `[phases] <seconds>` last.
"""
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def main() -> int:
    args = sys.argv[1:]
    timeout = 900
    if "--timeout" in args:
        i = args.index("--timeout")
        timeout = int(args[i + 1])
        del args[i:i + 2]
    t0 = time.monotonic()
    card = cs.phase_device()
    import torch

    cs.say(f"torch {torch.__version__} cuda {torch.version.cuda} python "
           f"{sys.version.split()[0]}")
    cs.phase_build()
    workdir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    hparams = cs.train_hparams(workdir)
    phases = {
        "7": lambda: cs.phase_train(workdir, hparams),
        "11a": lambda: cs.phase_moe_train(workdir, hparams, card),
        "12a": lambda: cs.phase_long_context_train(workdir, hparams, card),
        "12d": lambda: cs.phase_split_world(workdir, hparams, card),
        "16b": lambda: cs.phase_pipeline_world(workdir, hparams, card),
        "16d": lambda: cs.phase_moe_split_world(workdir, hparams, card),
        "17b": lambda: cs.phase_elastic_world(workdir, hparams, card),
        "18b": lambda: cs.phase_conv_split_world(workdir, card),
        "20a": lambda: cs.phase_capture_collectives(card),
        "20b": lambda: cs.phase_multi_mesh(workdir, hparams, card,
                                           per_case=True, timeout=timeout),
        "21": lambda: cs.phase_fit_captured(workdir, hparams, card),
        "22a": lambda: cs.phase_eval_captured(workdir, hparams, card),
        "22b": lambda: cs.phase_fit_mesh(workdir, hparams, card,
                                         per_case=True, timeout=timeout),
        "22c": lambda: cs.phase_elastic_world(workdir, hparams, card,
                                              world=2, tag="22c"),
        "23a": lambda: cs.phase_autotune(workdir, hparams, card),
        "23b": lambda: cs.phase_det_cli(workdir, cs.phase_serve(
            workdir, cs.write_model(workdir), card)["greedy"], card),
        "destroy": lambda: subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "nccl_graph_destroy.py")],
            check=True),
    }
    failed = []
    for name in args:
        t1 = time.monotonic()
        try:
            phases[name]()
        except BaseException:
            traceback.print_exc()
            cs.say(f"[{name}] FAILED")
            failed.append(name)
        cs.say(f"[phases] {name} took {time.monotonic() - t1:.1f} s")
    cs.say(f"[phases] failed: {failed}; {time.monotonic() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
