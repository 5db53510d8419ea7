#!/usr/bin/env python3
"""Parent against change on one GPU: serving's decode step and the training
step of `Trainer.fit`, each tree in its own process, in turns (parent,
change, change, parent), so both see the same card and host.

    git archive <parent> | tar -x -C build/ab/parent
    git archive $(git write-tree) | tar -x -C build/ab/change
    python3 tools/chip_ab.py build/ab/parent build/ab/change

Each turn runs the tree's own `chip_smoke.py` phases 1, 2, 5 and 7 (device,
build, HTTP serving, `Trainer.fit`) and prints one JSON line; all four land
in `build/ab/ab.json`.
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
cs.phase_device()
cs.phase_build()
wd = os.path.join(os.getcwd(), "build", "smoke")
os.makedirs(wd, exist_ok=True)
ckpt = cs.write_model(wd)
s = cs.phase_serve(wd, ckpt)
t = cs.phase_train(wd)
print("ABRESULT " + json.dumps({"decode_step_ms": s["decode_step_ms"],
      "tokens_per_s": s["tokens_per_s"], "ttft_p50_ms": s["ttft_p50_ms"],
      "step_ms": t["step_ms"], "busy_ms": t["breakdown"]["busy_ms"],
      "groups": t["breakdown"]["groups"]}))
'''


def main() -> int:
    trees = {"parent": sys.argv[1], "change": sys.argv[2]}
    results = []
    for name in ("parent", "change", "change", "parent"):
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=trees[name],
                             capture_output=True, text=True, timeout=600)
        line = [x for x in out.stdout.splitlines()
                if x.startswith("ABRESULT ")]
        if out.returncode or not line:
            print(out.stdout[-3000:], out.stderr[-3000:])
            print(f"chip_ab: the {name} turn failed", file=sys.stderr)
            return 1
        result = json.loads(line[0][len("ABRESULT "):])
        results.append((name, result))
        print(name, json.dumps(result), flush=True)
    os.makedirs(os.path.join("build", "ab"), exist_ok=True)
    with open(os.path.join("build", "ab", "ab.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
