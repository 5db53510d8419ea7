"""Static trial preflight for the port — memory, sharding and step-capture
diagnostics before any card time is spent.

Counterpart of determined_tpu/analysis/: the same module names, rule
codes, `Report` layout and `hbm` keys, so each module's counterpart is
easy to find and the two packages' reports compare key by key. It runs on
the CPU and on the card host, imports neither JAX nor the JAX package,
never launches a kernel and never allocates device memory:

  - engine 1 (`abstract`): the trial's state and forward loss on the
    `meta` device under the *declared* mesh — the per-device memory
    footprint and the DTL00x rules.
  - engine 2 (`astlint`): an AST walk of trial/model-def source for host
    syncs, Python RNG / wall-clock reads and shape branches inside step
    functions — the DTL1xx rules.
  - config cross-field checks (`config_rules`): the DTL2xx rules, the
    JAX package's copied whole.

Surfaces: `python -m determined_tpu_torch.analysis [paths]` (the lint,
with the metric-name and native lints) and `python -m
determined_tpu_torch.analysis preflight CONFIG [CONTEXT_DIR]` (what the
port's `python -m determined_tpu_torch.cli preflight` runs), and pytest
(tests/test_torch_preflight*.py). Every rule is suppressible via the
config (`preflight: {suppress: [DTLnnn]}`) or a `# det: noqa[DTLnnn]`
comment. docs/preflight-torch.md has the rule table.
"""

from determined_tpu_torch.analysis.diagnostics import (  # noqa: F401
    Diagnostic,
    Report,
    filter_suppressed,
)
from determined_tpu_torch.analysis.rules import RULES, Rule  # noqa: F401
from determined_tpu_torch.analysis.config_rules import check_config  # noqa: F401

# The engines import the models and torch's tracing modes; load them
# lazily (PEP 562) so importing the config rules stays cheap.
_LAZY = {
    "analyze_trial": ("determined_tpu_torch.analysis.abstract",
                      "analyze_trial"),
    "lint_paths": ("determined_tpu_torch.analysis.astlint", "lint_paths"),
    "lint_source": ("determined_tpu_torch.analysis.astlint", "lint_source"),
    "preflight": ("determined_tpu_torch.analysis._preflight", "preflight"),
    "preflight_trial": ("determined_tpu_torch.analysis._preflight",
                        "preflight_trial"),
    "should_fail": ("determined_tpu_torch.analysis._preflight",
                    "should_fail"),
    "gate_mode": ("determined_tpu_torch.analysis._preflight", "gate_mode"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
