#!/usr/bin/env python3
"""Where the tier-1 run's wall time goes, from its junit file.

    python tools/test_queue.py JUNIT.xml [--workers 6] [--pole FILE]
                               [--trials 200]

The tier-1 command runs `pytest -n 6 --dist loadfile`: each test file
stays on one worker, pytest-xdist (3.8) queues the files by their number
of tests, largest first (ties in collection order, i.e. by name), and a
worker takes the next file when it has 2 tests or fewer left. The
longest file (`--pole`, by default tests/test_examples_e2e.py) sets the
wall time: it starts when the files queued ahead of it have been handed
out.

Prints the worker time in all and in the port's files (`test_torch_*`),
the files queued ahead of the pole with their tests and seconds, and a
simulation of that schedule from the junit's per-test times: the wall
time and the pole's start, and with `--trials N` the mean and 90th
percentile over N runs with each test's time drawn within +-20 %.
Reads only the junit: no test runs.
"""

from __future__ import annotations

import argparse
import collections
import random
import statistics
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple


def load(path: str) -> Dict[str, List[float]]:
    """{file stem: [seconds of each test, in run order]}."""
    tests: Dict[str, List[float]] = collections.defaultdict(list)
    for case in ET.parse(path).getroot().iter("testcase"):
        stem = case.get("classname", "").split(".")[1]
        tests[stem].append(float(case.get("time") or 0.0))
    return dict(tests)


def queue(tests: Dict[str, List[float]]) -> List[str]:
    """The files in the order the scheduler hands them out."""
    return sorted(sorted(tests), key=lambda f: -len(tests[f]))


def simulate(tests: Dict[str, List[float]], workers: int = 6
             ) -> Tuple[float, Dict[str, float]]:
    """(wall seconds, {file: start second}) of the loadfile schedule."""
    q = collections.deque(queue(tests))
    pending = [collections.deque() for _ in range(workers)]
    clock = [0.0] * workers
    start: Dict[str, float] = {}

    def give(w: int) -> None:
        if q:
            f = q.popleft()
            pending[w].extend((f, t) for t in tests[f])

    for w in range(workers):
        give(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            give(w)
    while any(pending):
        w = min((i for i in range(workers) if pending[i]),
                key=lambda i: clock[i])
        f, t = pending[w].popleft()
        start.setdefault(f, clock[w])
        clock[w] += t
        if len(pending[w]) <= 2:
            give(w)
    return max(clock), start


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("junit")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--pole", default="test_examples_e2e")
    ap.add_argument("--trials", type=int, default=0)
    args = ap.parse_args()
    tests = load(args.junit)
    total = {f: sum(ts) for f, ts in tests.items()}
    port = sum(t for f, t in total.items() if f.startswith("test_torch_"))
    order = queue(tests)
    ahead = order[:order.index(args.pole)]
    print(f"worker time {sum(total.values()):.0f} s, the port's files "
          f"{port:.0f} s, {args.pole} {total[args.pole]:.0f} s "
          f"({len(tests[args.pole])} tests)")
    print(f"{len(ahead)} files ahead of it, "
          f"{sum(total[f] for f in ahead):.0f} s:")
    for f in ahead:
        print(f"  {f:44s} {len(tests[f]):4d} tests {total[f]:8.1f} s")
    wall, start = simulate(tests, args.workers)
    print(f"simulated: wall {wall:.0f} s, {args.pole} starts at "
          f"{start[args.pole]:.0f} s")
    if args.trials:
        rng = random.Random(0)
        walls = sorted(simulate({f: [t * rng.uniform(0.8, 1.2) for t in ts]
                                 for f, ts in tests.items()},
                                args.workers)[0]
                       for _ in range(args.trials))
        print(f"over {args.trials} draws (+-20 % a test): mean "
              f"{statistics.mean(walls):.0f} s, 90th percentile "
              f"{walls[int(0.9 * len(walls))]:.0f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
