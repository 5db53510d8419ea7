"""Metric- and span-name lint (docs/observability.md).

Counterpart of determined_tpu/analysis/metric_lint.py. The emitters it
scans are the port's (serve/http.py, train/trainer.py,
core/_checkpoint.py, serve/tracing.py) beside the same native sources, and
the registry is the port's copy (determined_tpu_torch/common/
metric_names.py). Run by `python -m determined_tpu_torch.analysis`.

`determined_tpu/common/metric_names.py` is the single source of truth for
every exported Prometheus metric name and every lifecycle-span name. This
lint keeps the master (C++), agent (C++), serving replicas and harness
from drifting apart on the same gauge, in BOTH directions:

  - every `det_*` name emitted in the scanned sources must be registered;
  - every registered name must still be emitted somewhere (a stale
    registry row is drift too);
  - the registry itself must satisfy the naming rules (snake_case,
    `_total` counters, unit suffixes on measured quantities).

Emission sites are found syntactically: `det_*` tokens inside string
literals for metrics; `*.span("...")` / `*.emit("...")` / `._span("...")`
(Python) and `make_span(..., "...")` (C++) call sites for spans. Run by
`make lint` via `python -m determined_tpu.analysis` for the JAX package.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Set

from determined_tpu_torch.common import metric_names

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Everything that renders Prometheus exposition text. Registry drift in an
# unlisted new emitter is caught the day its names are added here — adding
# the file to this list is part of adding the endpoint.
METRIC_SOURCES = [
    "native/master/master.cc",
    "native/agent/main.cc",
    "determined_tpu_torch/serve/http.py",
]

# Everything that emits lifecycle or request spans.
SPAN_SOURCES = [
    "native/master/master_experiments.cc",
    "native/master/master_agents.cc",
    "native/master/master_deployments.cc",
    "native/agent/main.cc",
    "determined_tpu_torch/train/trainer.py",
    "determined_tpu_torch/core/_checkpoint.py",
    "determined_tpu_torch/serve/tracing.py",
]

_SELF = "determined_tpu_torch/analysis/metric_lint.py"
_REGISTRY = "determined_tpu_torch/common/metric_names.py"

_STRING_RE = re.compile(r'"((?:[^"\\\n]|\\.)*)"')
# (?<![.\w]) keeps filenames like ".det_status" out of the metric scan.
_METRIC_TOKEN_RE = re.compile(r"(?<![.\w])det(?:_[a-z0-9]+)+\b")
# Histogram series derive these at exposition time; strip before lookup.
_HIST_SUFFIX_RE = re.compile(r"_(bucket|sum|count)$")
_PY_SPAN_RE = re.compile(r'(?:\bspan|\bemit|_span)\(\s*"([a-z0-9_.]+)"')
_CC_SPAN_RE = re.compile(r'make_span\(\s*[^"]*?"([a-z0-9_.]+)"')


def _read(relpath: str, root: str = REPO_ROOT) -> str:
    with open(os.path.join(root, relpath)) as f:
        return f.read()


def _emitted_metrics(text: str) -> Set[str]:
    found: Set[str] = set()
    for m in _STRING_RE.finditer(text):
        for tok in _METRIC_TOKEN_RE.findall(m.group(1)):
            found.add(_HIST_SUFFIX_RE.sub("", tok))
    return found


def _emitted_spans(relpath: str, text: str) -> Set[str]:
    pattern = _CC_SPAN_RE if relpath.endswith(".cc") else _PY_SPAN_RE
    return {name for name in pattern.findall(text) if "." in name}


def lint_registry(root: str = REPO_ROOT) -> List[str]:
    """Returns violation strings (empty = clean). Missing source files are
    violations too — a renamed emitter must update the scan list."""
    problems = list(metric_names.check_registry())

    emitted_metrics: Dict[str, Set[str]] = {}
    for rel in METRIC_SOURCES:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            problems.append(f"{rel}: metric source missing (update "
                            f"{_SELF} METRIC_SOURCES)")
            continue
        emitted_metrics[rel] = _emitted_metrics(_read(rel, root))

    registered = set(metric_names.all_metrics())
    all_emitted: Set[str] = set()
    for rel, names in emitted_metrics.items():
        all_emitted |= names
        for name in sorted(names - registered):
            problems.append(
                f"{rel}: metric {name!r} emitted but not registered in "
                f"{_REGISTRY}")
    for name in sorted(registered - all_emitted):
        problems.append(
            f"{_REGISTRY}: metric {name!r} registered but emitted "
            "nowhere (stale registry row)")

    emitted_spans: Set[str] = set()
    for rel in SPAN_SOURCES:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            problems.append(f"{rel}: span source missing (update "
                            f"{_SELF} SPAN_SOURCES)")
            continue
        names = _emitted_spans(rel, _read(rel, root))
        for name in sorted(names - set(metric_names.SPAN_NAMES)):
            problems.append(
                f"{rel}: span {name!r} emitted but not registered in "
                f"{_REGISTRY} SPAN_NAMES")
        emitted_spans |= names
    for name in sorted(set(metric_names.SPAN_NAMES) - emitted_spans):
        problems.append(
            f"{_REGISTRY}: span {name!r} registered but emitted nowhere "
            "(stale registry row)")
    return problems


def main() -> int:
    problems = lint_registry()
    for p in problems:
        print(f"metric-lint: {p}")
    print(f"metric-lint: {len(problems)} finding(s)")
    return 1 if problems else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
