"""Preflight orchestration: config -> Report.

Counterpart of determined_tpu/analysis/_preflight.py, with the port's
trials. Three layers, cheapest first:
  1. config cross-field checks (DTL2xx) — dict only
  2. AST lint over the model-def directory (DTL1xx) — source only
  3. abstract trace of the trial on the meta device (DTL0xx) — requires
     importing the trial class; degrades to a note (never a crash) when
     the trial can't be loaded, so a preflight is useful even on partial
     checkouts.

Trial discovery: every `*.py` in the context dir is scanned (AST, not
imported) for TorchTrial subclasses; matching modules are imported and the
class instantiated with the port's TrialContext built from the config's
hyperparameters, in one process with no process group (its loader yields
the global batch). A trial whose __init__ needs real data should keep it
lazy (build_training_data) — that is already the platform idiom.

Configs are dicts; `load_config` reads JSON, and YAML only when PyYAML
imports (it names the package otherwise), as serve/task.py does.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from determined_tpu_torch.analysis import abstract as abstract_mod
from determined_tpu_torch.analysis import astlint, config_rules
from determined_tpu_torch.analysis.diagnostics import Report, filter_suppressed

# Config block recognised by both this analyzer and the native master:
#   preflight:
#     gate: error | warn | off        (default warn: never hard-fail)
#     suppress: [DTL002, ...]
#     hbm_gb_per_device: 80           (enables DTL004)
GATE_MODES = ("error", "warn", "off")


def load_config(path: str) -> Dict[str, Any]:
    """An experiment config file: JSON, or YAML for a `.yaml`/`.yml` path
    when PyYAML is installed."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError(
                f"{path} is YAML and PyYAML is not installed; install "
                "PyYAML or write the config as JSON") from e
        return yaml.safe_load(text)
    return json.loads(text)


def _preflight_block(config: Dict[str, Any]) -> Dict[str, Any]:
    block = config.get("preflight")
    return block if isinstance(block, dict) else {}


def _hparam_values(hparams: Dict[str, Any]) -> Dict[str, Any]:
    """Collapse hparam specs to representative values for TrialContext.

    Search specs (int/double/log/categorical) take a sample from their
    range — the analyzer needs *a* valid instantiation, not the tuned one;
    shapes and sharding do not depend on where in the range it lands (and
    when they do, e.g. a searched layer width, any sample is as
    representative as any other).
    """
    out: Dict[str, Any] = {}
    for k, v in (hparams or {}).items():
        if isinstance(v, dict) and isinstance(v.get("type"), str):
            t = v["type"]
            if t == "const":
                out[k] = v.get("val")
            elif t in ("int", "double", "log") and "minval" in v:
                out[k] = v["minval"]
            elif t == "categorical" and v.get("vals"):
                out[k] = v["vals"][0]
            else:
                out[k] = v
        elif isinstance(v, dict) and k != "mesh" and v and \
                all(isinstance(sv, dict) for sv in v.values()):
            out[k] = _hparam_values(v)  # nested hparam group
        else:
            out[k] = v
    return out


def find_trial_classes(context_dir: str) -> List[Tuple[str, str]]:
    """[(py_path, class_name)] for TorchTrial subclasses, via AST only."""
    out: List[Tuple[str, str]] = []
    for path in sorted(astlint.iter_py_files([context_dir])):
        try:
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for b in node.bases:
                name = b.attr if isinstance(b, ast.Attribute) else getattr(
                    b, "id", "")
                if name == "TorchTrial":
                    out.append((path, node.name))
    return out


def load_trial(
    path: str, class_name: str, hparams: Dict[str, Any], n_devices: int
) -> Any:
    """Import `path` and instantiate `class_name` with a TrialContext."""
    from determined_tpu_torch.train.trial import TrialContext

    mod_name = f"_det_preflight_{os.path.splitext(os.path.basename(path))[0]}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    assert spec is not None and spec.loader is not None
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.dirname(os.path.abspath(path)))
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.pop(0)
    cls = getattr(module, class_name)
    ctx = TrialContext(hparams=_hparam_values(hparams), n_devices=n_devices)
    return cls(ctx)


def preflight_trial(
    trial: Any,
    n_devices: int,
    batch: Any = None,
    suppress: Optional[List[str]] = None,
    hbm_budget_bytes: Optional[int] = None,
    source_file: Optional[str] = None,
) -> Report:
    """Run both engines over an in-memory trial instance (test entry point)."""
    report = Report()
    ast_diags = []
    if source_file is None:
        mod = sys.modules.get(type(trial).__module__)
        source_file = getattr(mod, "__file__", None)
    if source_file and os.path.exists(source_file):
        with open(source_file, encoding="utf-8") as f:
            ast_diags = astlint.lint_source(f.read(), filename=source_file)
        report.extend(ast_diags)
    excused = any(d.code == "DTL101" and not d.suppressed for d in ast_diags)
    diags, hbm, notes = abstract_mod.analyze_trial(
        trial, n_devices, batch=batch, hbm_budget_bytes=hbm_budget_bytes,
        source_file=source_file, trace_failure_excused=excused)
    report.extend(diags)
    report.hbm = hbm
    report.notes.extend(notes)
    report.diagnostics = filter_suppressed(report.diagnostics, suppress or [])
    return report


def preflight(
    config: Dict[str, Any],
    context_dir: Optional[str] = None,
    load_trials: bool = True,
) -> Report:
    """Full preflight of an experiment config (+ optional model-def dir)."""
    from determined_tpu_torch import expconf

    config = expconf.shim(config)
    block = _preflight_block(config)
    suppress = [str(c) for c in block.get("suppress", []) or []]
    hbm_budget = None
    if block.get("hbm_gb_per_device"):
        hbm_budget = int(float(block["hbm_gb_per_device"]) * 2**30)

    report = Report()
    report.extend(config_rules.check_config(config))

    slots = (config.get("resources") or {}).get("slots_per_trial", 1)
    n_devices = slots if isinstance(slots, int) and slots > 0 else 1

    if context_dir:
        report.extend(astlint.lint_paths([context_dir]))
        if load_trials:
            classes = find_trial_classes(context_dir)
            if not classes:
                report.notes.append(
                    "no TorchTrial subclass found in the context directory; "
                    "abstract (memory/sharding) analysis skipped")
            for path, class_name in classes:
                try:
                    trial = load_trial(
                        path, class_name,
                        config.get("hyperparameters") or {}, n_devices)
                except Exception as e:
                    report.notes.append(
                        f"could not load {class_name} from {path}: "
                        f"{type(e).__name__}: {e}; abstract analysis skipped")
                    continue
                excused = any(
                    d.code == "DTL101" and d.file == path and not d.suppressed
                    for d in report.diagnostics)
                diags, hbm, notes = abstract_mod.analyze_trial(
                    trial, n_devices, hbm_budget_bytes=hbm_budget,
                    source_file=path, trace_failure_excused=excused)
                report.extend(diags)
                report.hbm = hbm
                report.notes.extend(notes)
                report.extend(_elastic_hbm_diags(
                    trial, config, n_devices, hbm_budget, path))

    report.diagnostics = filter_suppressed(report.diagnostics, suppress)
    return report


def _elastic_hbm_diags(trial: Any, config: Dict[str, Any], preferred: int,
                       hbm_budget: Optional[int],
                       source_file: Optional[str]) -> List[Any]:
    """DTL204's memory leg: re-run the abstract engine per candidate mesh
    for every slot count in [min_slots, max_slots] (docs/elasticity.md)
    — a shrink target whose per-device footprint blows the budget would
    run out of memory exactly when the scheduler tries to save the trial
    from a drain. Requires an armed budget (preflight.hbm_gb_per_device),
    like DTL004."""
    from determined_tpu_torch.analysis.rules import RULES
    from determined_tpu_torch.parallel.mesh import MeshConfig

    res = config.get("resources") or {}
    elastic = res.get("elastic") if isinstance(res, dict) else None
    if hbm_budget is None or not isinstance(elastic, dict):
        return []
    mn = elastic.get("min_slots", 1)
    mx = elastic.get("max_slots", preferred)
    if not (isinstance(mn, int) and isinstance(mx, int) and 1 <= mn <= mx):
        return []
    try:
        mesh_cfg = trial.mesh_config()
    except Exception:
        mesh_cfg = MeshConfig()
    out = []
    for k in range(mn, mx + 1):
        if k == preferred:
            continue  # the main analysis already covered the preferred size
        if not mesh_cfg.resolvable(k):
            continue  # the config rule reports unresolvable sizes
        diags, _, _ = abstract_mod.analyze_trial(
            trial, k, hbm_budget_bytes=hbm_budget, source_file=source_file)
        for d in diags:
            if d.code == "DTL004" and not d.suppressed:
                out.append(RULES["DTL204"].diag(
                    f"elastic size {k} (of [{mn}, {mx}]): {d.message}",
                    file=source_file))
    return out


def gate_mode(config: Dict[str, Any]) -> str:
    mode = _preflight_block(config).get("gate", "warn")
    return mode if mode in GATE_MODES else "warn"


def should_fail(config: Dict[str, Any], report: Report) -> bool:
    """The gate contract: hard-fail only on error-level rules, and only
    when the config opted in with `preflight: {gate: error}`."""
    return gate_mode(config) == "error" and bool(report.errors)
