"""Engine 2 — AST lint of trial / model-def source.

Counterpart of determined_tpu/analysis/astlint.py, with the same machinery
(the module index, the same-module call-graph closure, `# det: noqa[...]`,
`iter_py_files`, `lint_paths`) and the port's idea of what runs as a step.
The port's step runs eagerly, where a host read of a device value stalls
the step every call, and `make_multi_step` captures it once as a CUDA
graph and replays it, where Python RNG, the wall clock and shape branches
keep the value they had at capture and each distinct shape costs a capture.

What counts as a step function (the roots):
  - methods named loss / evaluate / init_extra on classes whose bases
    mention TorchTrial (and their same-module subclasses)
  - functions handed to the port's step factories (`make_train_step`,
    `make_multi_step`, `make_eval_step`, train/step.py), including a
    nested def the enclosing factory builds and hands over, and a lambda
  - the body of a `with torch.cuda.graph(...)` block (a capture)
  - module-level functions named loss_fn* / apply* (the model library's
    idiom, as in the JAX package)
plus the same-module call-graph closure of those roots: a helper called
from a step function is linted as one.

JaxTrial subclasses are not step code here, as the JAX lint skips torch
trials: each package lints its own trials. PyTorchTrial's eager methods
are not roots either.

Suppression: a trailing `# det: noqa[DTL101]` (or bare `# det: noqa`)
comment suppresses findings on that line; suppressed findings are still
reported, marked suppressed, so `--json` consumers can audit them.
"""

from __future__ import annotations

import ast
import os
import re
import types
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from determined_tpu_torch.analysis.diagnostics import Diagnostic
from determined_tpu_torch.analysis.rules import RULES

TRACED_METHODS = {"loss", "evaluate", "init_extra"}
# Data-loader roots (DTL105): not step code — linted for the opposite
# hazard, host code that copies to the device itself (paid twice with the
# DevicePrefetcher, which owns that copy).
DATA_LOADER_METHODS = {"build_training_data", "build_validation_data"}
TRACED_BASES = {"TorchTrial"}
TRACED_NAME_PREFIXES = ("loss_fn", "apply")
STEP_FACTORIES = {"make_train_step", "make_multi_step", "make_eval_step"}
GRAPH_CAPTURES = {"torch.cuda.graph", "cuda.graph"}

_NOQA_RE = re.compile(
    r"#\s*det:\s*noqa(?:\[(?P<codes>[A-Z0-9,\s]+)\])?", re.IGNORECASE)

# Host-sync callees (DTL101): tensor methods without arguments.
_HOST_SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
_NP_MODULES = {"np", "numpy", "onp"}
# float()/int()/bool() of a tensor: the argument is a torch call or a
# tensor method that returns a tensor (a reduction or an element).
_SCALAR_CASTS = {"float", "int", "bool"}
_TENSOR_METHODS = {
    "sum", "mean", "max", "min", "amax", "amin", "norm", "any", "all",
    "prod", "std", "var", "argmax", "argmin", "abs", "sqrt", "exp", "log",
    "float", "double", "half", "bfloat16", "to", "detach", "squeeze",
    "reshape", "view", "flatten",
}

# Python RNG callees (DTL102): stdlib `random.` and `np.random.`.
_PY_RNG_FUNCS = {
    "random", "randint", "uniform", "randrange", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "betavariate", "random_sample",
}
_NP_RNG_FUNCS = _PY_RNG_FUNCS | {"randn", "rand", "default_rng", "normal",
                                 "integers", "permutation"}

# Wall-clock callees (DTL103).
_CLOCK_FUNCS = {"time", "perf_counter", "monotonic", "process_time", "clock"}


def parse_noqa(source: str) -> Dict[int, Optional[Set[str]]]:
    """line -> None (suppress all) | set of codes."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _NOQA_RE.search(line)
        if not m:
            continue
        codes = m.group("codes")
        if codes is None:
            out[i] = None
        else:
            out[i] = {c.strip().upper() for c in codes.split(",") if c.strip()}
    return out


def _dotted(node: ast.AST) -> Optional[str]:
    """Attribute/Name chain -> 'a.b.c' (None for anything else)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_step_factory(node: ast.AST) -> bool:
    """True for `make_train_step`, `step.make_multi_step`, and
    `partial(make_eval_step, ...)` expressions: the port's counterparts of
    the JAX lint's `jax.jit` (`_is_jit_expr`)."""
    d = _dotted(node)
    if d is not None and d.split(".")[-1] in STEP_FACTORIES:
        return True
    if isinstance(node, ast.Call):
        f = _dotted(node.func)
        if f is not None and f.split(".")[-1] == "partial" and node.args:
            return _is_step_factory(node.args[0])
    return False


def _handed_fn(call: ast.Call) -> Optional[ast.AST]:
    """The function a step-factory call is handed: its first argument, or
    its `loss_fn` / `eval_fn` keyword."""
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg in ("loss_fn", "eval_fn"):
            return kw.value
    return None


def _is_graph_capture(item: ast.withitem) -> bool:
    expr = item.context_expr
    return isinstance(expr, ast.Call) and _dotted(expr.func) in GRAPH_CAPTURES


class _ModuleIndex(ast.NodeVisitor):
    """Collect functions, methods, step roots and a same-module call graph."""

    def __init__(self):
        self.functions: Dict[str, ast.AST] = {}  # qualname -> FunctionDef
        self.roots: Set[str] = set()
        # Trial-method roots only (TorchTrial loss/evaluate/...): the
        # subset DTL107 scopes to — the platform's own model library
        # (module-level loss_fn*/apply* roots) legitimately implements
        # softmax.
        self.trial_roots: Set[str] = set()
        self.data_roots: Set[str] = set()  # build_*_data methods (DTL105)
        self.calls: Dict[str, Set[str]] = {}  # qualname -> called qualnames
        self._class_stack: List[Tuple[str, bool]] = []  # (name, is_trial)

    # -- classes --------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        is_trial = any(
            (_dotted(b) or "").split(".")[-1] in TRACED_BASES
            for b in node.bases
        )
        # Subclass-of-subclass within the same module counts too.
        if not is_trial:
            for b in node.bases:
                base = (_dotted(b) or "").split(".")[-1]
                if any(c == base and t for c, t in self._class_stack):
                    is_trial = True
        self._class_stack.append((node.name, is_trial))
        self.generic_visit(node)
        self._class_stack.pop()

    # -- functions ------------------------------------------------------
    def _qual(self, name: str) -> str:
        if self._class_stack:
            return f"{self._class_stack[-1][0]}.{name}"
        return name

    def _handle_function(self, node) -> None:
        qual = self._qual(node.name)
        self.functions[qual] = node
        in_trial = bool(self._class_stack) and self._class_stack[-1][1]
        if in_trial and node.name in TRACED_METHODS:
            self.roots.add(qual)
            self.trial_roots.add(qual)
        if in_trial and node.name in DATA_LOADER_METHODS:
            self.data_roots.add(qual)
        if not self._class_stack and node.name.startswith(TRACED_NAME_PREFIXES):
            self.roots.add(qual)
        self.calls[qual] = self._collect_calls(node)
        # Do NOT generic_visit: nested defs belong to this function's body
        # and are linted as part of it — EXCEPT what runs as a step while
        # the enclosing function runs on the host: a nested def (or a
        # lambda) handed to a step factory, and a `torch.cuda.graph`
        # capture block. Register those as their own roots.
        handed: Set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Call) and _is_step_factory(n.func):
                fn = _handed_fn(n)
                d = _dotted(fn) if fn is not None else None
                if d is not None and "." not in d:
                    handed.add(d)
                elif isinstance(fn, ast.Lambda):
                    self._pseudo_root(
                        f"{qual}.<lambda:{fn.lineno}>", [fn.body])
            elif isinstance(n, ast.With) and any(
                    _is_graph_capture(i) for i in n.items):
                self._pseudo_root(f"{qual}.<graph:{n.lineno}>", n.body)
        if handed:
            for n in ast.walk(node):
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and n is not node and n.name in handed:
                    nested_qual = f"{qual}.<locals>.{n.name}"
                    self.functions[nested_qual] = n
                    self.roots.add(nested_qual)
                    self.calls[nested_qual] = self._collect_calls(n)

    visit_FunctionDef = _handle_function
    visit_AsyncFunctionDef = _handle_function

    def _pseudo_root(self, qual: str, body: List[ast.AST]) -> None:
        """A root that is a block of code, not a def: its statements (or
        a lambda's expression) are linted as a step function's body."""
        block = types.SimpleNamespace(body=body)
        self.functions[qual] = block
        self.roots.add(qual)
        calls: Set[str] = set()
        for stmt in body:
            calls |= self._collect_calls(stmt)
        self.calls[qual] = calls

    def _collect_calls(self, node) -> Set[str]:
        cls = self._class_stack[-1][0] if self._class_stack else None
        out: Set[str] = set()
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            d = _dotted(n.func)
            if d is None:
                continue
            if d.startswith("self.") and cls is not None:
                out.add(f"{cls}.{d[5:]}")
            elif "." not in d:
                out.add(d)
        return out

    def _mark_handed(self, node: ast.Call) -> None:
        fn = _handed_fn(node)
        d = _dotted(fn) if fn is not None else None
        if d is None:
            return
        cls = self._class_stack[-1][0] if self._class_stack else None
        if d.startswith("self.") and cls is not None:
            self.roots.add(f"{cls}.{d[5:]}")
        else:
            self.roots.add(d)

    # module- or class-level `step = make_train_step(f, tx)` marks f as a
    # root (calls inside functions are the functions' business, above).
    def visit_Call(self, node: ast.Call) -> None:
        if _is_step_factory(node.func):
            self._mark_handed(node)
        self.generic_visit(node)


def _traced_closure(index: _ModuleIndex,
                    roots: Optional[Set[str]] = None) -> Set[str]:
    seen: Set[str] = set()
    frontier = [r for r in (index.roots if roots is None else roots)
                if r in index.functions]
    while frontier:
        fn = frontier.pop()
        if fn in seen:
            continue
        seen.add(fn)
        for callee in index.calls.get(fn, ()):
            if callee in index.functions and callee not in seen:
                frontier.append(callee)
            # `Class.method` calls recorded as bare names can't collide with
            # module functions here; unknown callees are simply skipped.
    return seen


def _tensor_valued(node: ast.AST) -> bool:
    """A call that returns a tensor, as far as the source says: a `torch.`
    function or a tensor method such as `.sum()`."""
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func)
    if d is not None and d.split(".")[0] in ("torch", "F"):
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _TENSOR_METHODS
            and not (d or "").startswith(("math.", "np.", "numpy.")))


class _RuleWalker(ast.NodeVisitor):
    def __init__(self, filename: str, func_qual: str):
        self.filename = filename
        self.func_qual = func_qual
        self.findings: List[Tuple[str, int, str]] = []  # (code, line, msg)

    def _add(self, code: str, node: ast.AST, msg: str) -> None:
        self.findings.append((code, getattr(node, "lineno", 0), msg))

    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        last = d.split(".")[-1] if d else None

        # DTL101 — host sync.
        if isinstance(node.func, ast.Attribute) and not node.args and \
                not node.keywords and node.func.attr in _HOST_SYNC_METHODS:
            what = "torch.cuda.synchronize()" if d == "torch.cuda.synchronize" \
                else f".{node.func.attr}()"
            self._add("DTL101", node,
                      f"{what} inside step function '{self.func_qual}' "
                      "waits for the device (a stall every eager step, and "
                      "an error in a CUDA graph capture); keep the value on "
                      "the device and read it at report boundaries")
        elif d in _SCALAR_CASTS and len(node.args) == 1 and \
                _tensor_valued(node.args[0]):
            self._add("DTL101", node,
                      f"{d}() of a tensor inside step function "
                      f"'{self.func_qual}' copies it to the host and waits "
                      "for the device; keep it a tensor and read it at "
                      "report boundaries")
        elif d is not None and d.split(".")[0] in _NP_MODULES and \
                last in ("asarray", "array"):
            if node.args and not isinstance(
                    node.args[0], (ast.Constant, ast.List, ast.Tuple)):
                self._add("DTL101", node,
                          f"{d}() on a step value inside '{self.func_qual}' "
                          "pulls it to the host (and fails on a CUDA "
                          "tensor); use torch instead")

        # DTL102 — Python RNG.
        if d is not None and "." in d:
            head, tail = d.split(".", 1)
            if head == "random" and tail in _PY_RNG_FUNCS:
                self._add("DTL102", node,
                          f"random.{tail}() inside step function "
                          f"'{self.func_qual}' is drawn once when "
                          "make_multi_step captures the step; draw with "
                          "torch and the step's generator")
            elif head in _NP_MODULES and tail.startswith("random.") and \
                    tail.split(".")[-1] in _NP_RNG_FUNCS:
                self._add("DTL102", node,
                          f"{d}() inside step function '{self.func_qual}' "
                          "is drawn once when make_multi_step captures the "
                          "step; draw with torch and the step's generator")

        # DTL103 — wall clock.
        if d in {f"time.{f}" for f in _CLOCK_FUNCS} or \
                d in ("datetime.now", "datetime.datetime.now",
                      "datetime.utcnow", "datetime.datetime.utcnow"):
            self._add("DTL103", node,
                      f"{d}() inside step function '{self.func_qual}' is "
                      "read once at make_multi_step's capture, not per step")

        self.generic_visit(node)

    def _shape_dependent(self, test: ast.AST) -> Optional[str]:
        for n in ast.walk(test):
            if isinstance(n, ast.Attribute) and n.attr in ("shape", "ndim"):
                return f".{n.attr}"
            if isinstance(n, ast.Call):
                d = _dotted(n.func)
                if d == "len":
                    return "len()"
                if d is not None and d.split(".")[-1] in ("size", "dim") \
                        and isinstance(n.func, ast.Attribute):
                    return f".{d.split('.')[-1]}()"
                if d == "getattr" and len(n.args) >= 2 and isinstance(
                        n.args[1], ast.Constant) and n.args[1].value in (
                            "shape", "ndim"):
                    return f"getattr(..., '{n.args[1].value}')"
        return None

    def _check_branch(self, node) -> None:
        why = self._shape_dependent(node.test)
        if why is not None:
            kind = "while" if isinstance(node, ast.While) else "if"
            self._add("DTL104", node,
                      f"`{kind}` on {why} inside step function "
                      f"'{self.func_qual}': the branch taken at capture is "
                      "frozen into the CUDA graph and each distinct shape "
                      "costs make_multi_step a capture; keep shapes static "
                      "or select with torch.where")
        self.generic_visit(node)

    visit_If = _check_branch
    visit_While = _check_branch

    def visit_IfExp(self, node: ast.IfExp) -> None:
        why = self._shape_dependent(node.test)
        if why is not None:
            self._add("DTL104", node,
                      f"conditional expression on {why} inside step "
                      f"function '{self.func_qual}' (frozen at capture; a "
                      "capture per distinct shape)")
        self.generic_visit(node)


def _thread_stop_findings(tree: ast.Module) -> List[Tuple[str, int, str]]:
    """DTL106 — `_stop` shadowing on threading.Thread subclasses.

    CPython's Thread keeps a private `_stop()` method that `join()` /
    `_wait_for_tstate_lock()` call when the thread finishes.  A subclass
    that rebinds `_stop` to an Event (the classic pre-3.x stop-flag idiom)
    crashes with `TypeError: 'Event' object is not callable` at thread
    exit; rebinding it to a method silently skips Thread's own state
    bookkeeping.  Same-module subclass-of-subclass counts too.
    """
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    thread_classes: Set[str] = set()
    changed = True
    while changed:  # fixed point over same-module subclassing
        changed = False
        for cls in classes:
            if cls.name in thread_classes:
                continue
            for b in cls.bases:
                base = (_dotted(b) or "").split(".")[-1]
                if base == "Thread" or base in thread_classes:
                    thread_classes.add(cls.name)
                    changed = True
                    break

    findings: List[Tuple[str, int, str]] = []

    def _flag(node: ast.AST, cls: ast.ClassDef, what: str) -> None:
        findings.append((
            "DTL106", getattr(node, "lineno", 0),
            f"Thread subclass '{cls.name}' defines {what} named '_stop', "
            "shadowing threading.Thread._stop() (called by join() on "
            "thread exit); rename it to '_stop_evt'"))

    for cls in classes:
        if cls.name not in thread_classes:
            continue
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if stmt.name == "_stop":
                    _flag(stmt, cls, "a method")
                    continue
                # self._stop = ... inside any method body.
                for n in ast.walk(stmt):
                    targets: List[ast.AST] = []
                    if isinstance(n, ast.Assign):
                        targets = list(n.targets)
                    elif isinstance(n, (ast.AnnAssign, ast.AugAssign)):
                        targets = [n.target]
                    for t in targets:
                        if isinstance(t, ast.Attribute) and \
                                t.attr == "_stop" and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            _flag(n, cls, "an instance attribute")
            elif isinstance(stmt, ast.Assign):
                if any(isinstance(t, ast.Name) and t.id == "_stop"
                       for t in stmt.targets):
                    _flag(stmt, cls, "a class attribute")
            elif isinstance(stmt, ast.AnnAssign):
                if isinstance(stmt.target, ast.Name) and \
                        stmt.target.id == "_stop":
                    _flag(stmt, cls, "a class attribute")
    return findings


# DTL107 — callees that mark attention computed by hand. Scoped to the
# *trial-method* closure only (index.trial_roots): the platform's own
# model library (module-level loss_fn*/apply* roots, ops/flash_attention.py's
# reference path) legitimately implements softmax. log_softmax is NOT
# flagged — it is the cross-entropy idiom, not attention.
_SOFTMAX_HEADS = {"torch", "F", "nn.functional", "torch.nn.functional",
                  "torch.special", "special"}
_SDPA = "scaled_dot_product_attention"


class _AttnWalker(ast.NodeVisitor):
    """DTL107 — attention computed by hand inside trial step code."""

    def __init__(self, func_qual: str):
        self.func_qual = func_qual
        self.findings: List[Tuple[str, int, str]] = []

    def _add(self, node: ast.AST, what: str) -> None:
        self.findings.append((
            "DTL107", getattr(node, "lineno", 0),
            f"{what} inside trial step code '{self.func_qual}' bypasses "
            "`optimizations.attention_impl` and the hand-written flash "
            "kernels, so platform attention A/Bs never reach this trial — "
            "route attention through the model library "
            "(ops/flash_attention.flash_attention) or suppress if this "
            "softmax is not attention"))

    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        last = d.split(".")[-1] if d else (
            node.func.attr if isinstance(node.func, ast.Attribute) else None)
        if last == _SDPA:
            self._add(node, f"{d or _SDPA}()")
        elif last == "softmax":
            head = d.rsplit(".", 1)[0] if d and "." in d else ""
            if d == "softmax" or head in _SOFTMAX_HEADS:
                self._add(node, f"{d}() (a hand-rolled attention softmax)")
            elif isinstance(node.func, ast.Attribute):
                # The tensor method: `(q @ k.T).softmax(-1)`.
                self._add(node, ".softmax() (a hand-rolled attention "
                                "softmax)")
        self.generic_visit(node)


class _DataLoaderWalker(ast.NodeVisitor):
    """DTL105 — a copy to the device inside build_training/validation_data."""

    def __init__(self, func_qual: str):
        self.func_qual = func_qual
        self.findings: List[Tuple[str, int, str]] = []

    def _add(self, node: ast.AST, what: str) -> None:
        self.findings.append((
            "DTL105", getattr(node, "lineno", 0),
            f"{what} inside '{self.func_qual}': the DevicePrefetcher "
            "already copies each host batch to the device — this copy is "
            "paid twice; yield host (numpy or CPU tensor) batches instead"))

    @staticmethod
    def _names_cuda(node: ast.AST) -> bool:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value.startswith("cuda")
        if isinstance(node, ast.Call) and _dotted(node.func) in (
                "torch.device", "device") and node.args:
            return _DataLoaderWalker._names_cuda(node.args[0])
        return False

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "cuda":
            self._add(node, ".cuda()")
        elif isinstance(func, ast.Attribute) and func.attr == "to" and (
                any(self._names_cuda(a) for a in node.args)
                or any(self._names_cuda(k.value) for k in node.keywords)):
            self._add(node, ".to('cuda')")
        elif any(k.arg == "device" and self._names_cuda(k.value)
                 for k in node.keywords):
            self._add(node, f"{_dotted(func) or 'a call'}(device='cuda')")
        self.generic_visit(node)


def lint_source(
    source: str, filename: str = "<string>"
) -> List[Diagnostic]:
    """Lint one module's source; returns diagnostics (suppressed included)."""
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        return [Diagnostic(code="DTL101", level="error", engine="ast",
                           message=f"source does not parse: {e}",
                           file=filename, line=e.lineno or 0)]
    noqa = parse_noqa(source)
    index = _ModuleIndex()
    index.visit(tree)
    traced = _traced_closure(index)

    diags: List[Diagnostic] = []

    def _emit(findings) -> None:
        for code, line, msg in findings:
            rule = RULES[code]
            d = rule.diag(msg, file=filename, line=line)
            codes = noqa.get(line, "absent")
            if codes is None or (codes != "absent" and code in codes):
                d.suppressed = True
                d.suppressed_by = "noqa"
            diags.append(d)

    for qual in sorted(traced):
        walker = _RuleWalker(filename, qual)
        node = index.functions[qual]
        # Visit the body only: decorators/defaults run at def time, on host.
        for stmt in node.body:
            walker.visit(stmt)
        _emit(walker.findings)
    # DTL107 runs over the trial-method closure only (see _SOFTMAX_HEADS).
    for qual in sorted(_traced_closure(index, index.trial_roots)):
        attn_walker = _AttnWalker(qual)
        for stmt in index.functions[qual].body:
            attn_walker.visit(stmt)
        _emit(attn_walker.findings)
    for qual in sorted(index.data_roots):
        dl_walker = _DataLoaderWalker(qual)
        for stmt in index.functions[qual].body:
            dl_walker.visit(stmt)
        _emit(dl_walker.findings)
    # DTL106 applies to every Thread subclass in the module, traced or not.
    _emit(_thread_stop_findings(tree))
    return diags


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if not d.startswith(".") and d != "__pycache__"]
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_paths(paths: Sequence[str]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError):
            continue
        diags.extend(lint_source(source, filename=path))
    return diags
