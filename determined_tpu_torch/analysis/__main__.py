"""`python -m determined_tpu_torch.analysis` — the port's lint and preflight.

  python -m determined_tpu_torch.analysis [paths...]
      The AST engine (DTL1xx) over source trees (default: the port's
      package and examples/*_cuda), with the metric-name and native
      lints; exits 1 on any unsuppressed finding (the dogfood gate).

  python -m determined_tpu_torch.analysis preflight CONFIG [CONTEXT_DIR]
      The full preflight of an experiment config (JSON, or YAML when
      PyYAML is installed) and its model-def directory, as the port's
      `python -m determined_tpu_torch.cli preflight` runs it (that one
      exits 1 on any error-level finding). Prints the report as text, or
      as JSON with
      --json, and exits 1 when the config's gate says so (`should_fail`:
      `preflight: {gate: error}` and an error-level finding).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from determined_tpu_torch.analysis import astlint

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_paths(root: str = REPO_ROOT) -> list:
    """The port's own sources: the package and its examples."""
    return [os.path.join(root, "determined_tpu_torch"),
            *sorted(glob.glob(os.path.join(root, "examples", "*_cuda")))]


def preflight_main(argv) -> int:
    from determined_tpu_torch.analysis import _preflight

    p = argparse.ArgumentParser(
        prog="python -m determined_tpu_torch.analysis preflight",
        description="preflight an experiment config and its model-def dir")
    p.add_argument("config")
    p.add_argument("context_dir", nargs="?")
    p.add_argument("--json", action="store_true", dest="as_json")
    p.add_argument("--no-trial", action="store_true",
                   help="skip importing the trial (config + AST only)")
    args = p.parse_args(argv)
    config = _preflight.load_config(args.config)
    report = _preflight.preflight(config, context_dir=args.context_dir,
                                  load_trials=not args.no_trial)
    print(report.to_json() if args.as_json else report.to_text())
    return 1 if _preflight.should_fail(config, report) else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["preflight"]:
        return preflight_main(argv[1:])
    p = argparse.ArgumentParser(prog="python -m determined_tpu_torch.analysis",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint (default: "
                        "determined_tpu_torch examples/*_cuda)")
    p.add_argument("--json", action="store_true", dest="as_json")
    p.add_argument("--no-metric-lint", action="store_true",
                   help="skip the metric/span name registry check")
    p.add_argument("--no-native-lint", action="store_true",
                   help="skip the native locking-convention / registry "
                        "check (docs/static-analysis.md)")
    args = p.parse_args(argv)

    diags = astlint.lint_paths(args.paths or default_paths())
    active = [d for d in diags if not d.suppressed]

    metric_problems = []
    if not args.as_json and not args.no_metric_lint:
        from determined_tpu_torch.analysis import metric_lint

        metric_problems = metric_lint.lint_registry()
        for prob in metric_problems:
            print(f"metric-lint: {prob}")

    native_problems = []
    if not args.as_json and not args.no_native_lint:
        from determined_tpu_torch.analysis import native_lint

        native_problems = native_lint.lint_native()
        for prob in native_problems:
            print(f"native-lint: {prob}")
    if args.as_json:
        print(json.dumps([d.to_dict() for d in diags], indent=2))
    else:
        for d in diags:
            tag = f"{d.level} {d.code}"
            if d.suppressed:
                tag += " (suppressed)"
            print(f"{d.location()}: {tag}: {d.message}")
        n_sup = len(diags) - len(active)
        from determined_tpu_torch.analysis import native_lint as _nl

        print(f"lint: {len(active)} finding(s), {n_sup} suppressed; "
              f"metric-lint: {len(metric_problems)} finding(s); "
              f"native-lint: {len(native_problems)} finding(s), "
              f"{_nl.tsa_escape_count()}/{_nl.MAX_TSA_ESCAPES} tsa escapes")
    return 1 if active or metric_problems or native_problems else 0


if __name__ == "__main__":
    sys.exit(main())
