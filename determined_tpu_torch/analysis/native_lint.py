"""Native locking-convention and registry lint (docs/static-analysis.md).

Counterpart of determined_tpu/analysis/native_lint.py, copied whole: NL001-
NL003 and NL005 read native/ exactly as the JAX package's copy does, and
NL004 reads the port's Python fault points (determined_tpu_torch/common/
faultpoint.py and the port modules that fire them) in place of the JAX
package's. Run by `python -m determined_tpu_torch.analysis`.

The compile-time half of the thread-safety gate is clang's
``-Wthread-safety`` over the annotations in
``native/common/thread_annotations.h`` (``make -C native tsa``). This
module is the other half: the conventions the annotations cannot express,
and the cross-language registries that must not drift — checked with the
same both-directions contract metric_lint applies to metric names.

Rules (the table lives in docs/static-analysis.md):

  NL001  every ``*_locked`` function declares ``REQUIRES(...)``
  NL002  every field of a Mutex-bearing class in the annotated headers is
         ``GUARDED_BY``, an atomic/const/lock type, or carries an explicit
         ``not-guarded:`` justification
  NL003  ``NO_THREAD_SAFETY_ANALYSIS`` escapes: at most 3 across native/,
         each with an inline ``// tsa:`` justification
  NL004  fault points: C++ ``FAULT_POINT`` sites == the kKnown catalogue,
         and (C++ ∪ Python) emitted points == the rows in docs/chaos.md
  NL005  REST route roots dispatched by the master == the path roots in
         the served OpenAPI document

Run for the JAX package by ``make lint`` via
``python -m determined_tpu.analysis``.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import List, Set, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Headers whose Mutex-bearing classes are held to the NL002 field
# discipline. native/common/mutex.h is excluded by construction — it IS
# the capability wrapper.
ANNOTATED_HEADERS = [
    "native/master/master.h",
    "native/master/rm.h",
]

# File-scope globals in these sources follow the same discipline (the
# agent has no header; its shared state is file-scope ``g_*``).
GLOBAL_SOURCES = [
    "native/agent/main.cc",
    "native/common/http.cc",
    "native/common/faultpoint.cc",
]

# Python subsystems that emit fault points, as ``fire("...")`` literals or
# module-level ``FAULT_* = "..."`` constants.
PY_FAULT_SOURCES = [
    "determined_tpu_torch/common/faultpoint.py",
    "determined_tpu_torch/common/trace.py",
    "determined_tpu_torch/core/_integrity.py",
    "determined_tpu_torch/data/prefetch.py",
    "determined_tpu_torch/serve/scheduler.py",
    "determined_tpu_torch/serve/tracing.py",
    "determined_tpu_torch/train/trainer.py",
]

MAX_TSA_ESCAPES = 3

_LOCKED_DECL_RE = re.compile(r"\b(\w+_locked)\s*\(")
_FAULT_SITE_RE = re.compile(r'FAULT_POINT\("([a-z0-9_.]+)"\)')
_KKNOWN_RE = re.compile(r'^\s*\{"([a-z0-9_.]+)",\s*"(?:master|agent)"',
                        re.MULTILINE)
_PY_FIRE_RE = re.compile(r'\bfire\("([a-z0-9_.]+)"\)')
_PY_CONST_RE = re.compile(r'^FAULT\w*\s*=\s*"([a-z0-9_.]+)"', re.MULTILINE)
_CHAOS_ROW_RE = re.compile(r"^\| `([a-z0-9_.]+)`", re.MULTILINE)
_ROUTE_ROOT_RE = re.compile(r'root == "([\w-]+)"')


def _read(relpath: str, root: str = REPO_ROOT) -> str:
    with open(os.path.join(root, relpath)) as f:
        return f.read()


def _strip_comments(text: str) -> str:
    """// and /* */ comments → spaces (offsets preserved line-wise)."""
    text = re.sub(r"/\*.*?\*/", lambda m: re.sub(r"[^\n]", " ", m.group(0)),
                  text, flags=re.DOTALL)
    return re.sub(r"//[^\n]*", "", text)


def _native_files(root: str) -> List[str]:
    out = []
    for pat in ("native/**/*.h", "native/**/*.cc"):
        for path in sorted(glob.glob(os.path.join(root, pat),
                                     recursive=True)):
            out.append(os.path.relpath(path, root))
    return out


# -- NL001 -----------------------------------------------------------------

def _check_locked_requires(root: str) -> List[str]:
    problems = []
    for rel in _native_files(root):
        if rel.endswith("thread_annotations.h"):
            continue
        raw = _read(rel, root)
        text = _strip_comments(raw)
        for m in _LOCKED_DECL_RE.finditer(text):
            name = m.group(1)
            # Only declarations/definitions, not call sites. Headers hold
            # declarations; in .cc files a definition starts at column 0
            # (possibly Master::-qualified — those carry REQUIRES on the
            # header declaration and are skipped here).
            line_start = text.rfind("\n", 0, m.start()) + 1
            prefix = text[line_start:m.start()]
            if rel.endswith(".cc"):
                if not prefix or prefix[0].isspace():
                    continue  # indented = call site / member expression
                if "::" in prefix:
                    continue  # method definition; header declares REQUIRES
            else:
                # In a header a call would be inside an inline body —
                # require the match to be a declaration: previous
                # non-space char ends a type or access specifier.
                prev = text[:m.start()].rstrip()[-1:]
                if prev and prev not in "&*>;{}:\n" and not (
                        prev.isalnum() or prev == "_"):
                    continue
            stop_semi = text.find(";", m.end())
            stop_brace = text.find("{", m.end())
            stops = [s for s in (stop_semi, stop_brace) if s != -1]
            decl = text[m.start():min(stops)] if stops else text[m.start():]
            if "REQUIRES" not in decl:
                line = text.count("\n", 0, m.start()) + 1
                problems.append(
                    f"{rel}:{line}: NL001 {name} does not declare "
                    "REQUIRES(<mutex>) — the _locked suffix is a checked "
                    "contract, not a naming habit")
    return problems


# -- NL002 -----------------------------------------------------------------

_MEMBER_SKIP_RE = re.compile(
    r"^\s*(friend|using|typedef|static|enum|struct|class|public|private|"
    r"protected|explicit|virtual|template|return|if|for|while|switch|#)\b")
_LOCK_FREE_TYPES = ("std::atomic", "Mutex", "std::condition_variable",
                    "const ")


def _class_scopes(text: str) -> List[Tuple[str, int, int, int]]:
    """(name, body_start, body_end, depth) for each class/struct body."""
    scopes = []
    stack = []  # (name_or_None, open_idx)
    pending = None
    i = 0
    header_re = re.compile(r"\b(?:class|struct)\s+(?:CAPABILITY\([^)]*\)\s*|"
                           r"SCOPED_CAPABILITY\s*)?(\w+)[^;{(]*$")
    while i < len(text):
        c = text[i]
        if c == "{":
            line_start = text.rfind("\n", 0, i) + 1
            head = text[line_start:i].strip()
            m = header_re.search(head)
            stack.append((m.group(1) if m else None, i))
        elif c == "}":
            if stack:
                name, start = stack.pop()
                if name:
                    scopes.append((name, start + 1, i, len(stack)))
        i += 1
        pending = pending  # keep lints quiet
    return scopes


def _check_guarded_fields(root: str) -> List[str]:
    problems = []
    for rel in ANNOTATED_HEADERS:
        if not os.path.exists(os.path.join(root, rel)):
            problems.append(f"{rel}: NL002 annotated header missing (update "
                            "determined_tpu_torch/analysis/native_lint.py "
                            "ANNOTATED_HEADERS)")
            continue
        raw = _read(rel, root)
        text = _strip_comments(raw)
        for name, start, end, _depth in _class_scopes(text):
            if name in ("Mutex", "MutexLock"):
                continue
            stmts = _depth0_statements(text, start, end)
            # Mutex-bearing = declares a det::Mutex member at its own
            # depth (directly or via a pointer) — those classes owe an
            # account of every field. Nested classes are their own scopes.
            if not any(re.search(r"\bMutex\b(?!Lock)", s) for _pos, s
                       in stmts):
                continue
            problems += _check_scope_fields(rel, raw, text, name, stmts)
    return problems


def _depth0_statements(text: str, start: int,
                       end: int) -> List[Tuple[int, str]]:
    """(start_offset, text) of each ';'-terminated statement at the
    scope's own brace depth (nested bodies collapse into their
    statement)."""
    stmts = []
    depth = 0
    stmt_start = start
    for i in range(start, end):
        c = text[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                stmt_start = i + 1
        elif c == ";" and depth == 0:
            seg = text[stmt_start:i]
            lead = len(seg) - len(seg.lstrip())
            stmts.append((stmt_start + lead, seg.strip()))
            stmt_start = i + 1
    return stmts


def _check_scope_fields(rel: str, raw: str, text: str, cls: str,
                        stmts: List[Tuple[int, str]]) -> List[str]:
    problems = []
    raw_lines = raw.splitlines()
    for pos, stmt in stmts:
        if not stmt or _MEMBER_SKIP_RE.match(stmt):
            continue
        # A '(' outside GUARDED_BY/PT_GUARDED_BY = function declaration.
        probe = re.sub(r"(?:PT_)?GUARDED_BY\([^)]*\)", "", stmt)
        probe = re.sub(r"\{[^}]*\}", "", probe)
        if "(" in probe:
            continue
        if "GUARDED_BY" in stmt:
            continue
        if any(t in stmt for t in _LOCK_FREE_TYPES):
            continue
        # Justified? ('not-guarded:' in the member's own comment or the
        # comment block right above it — comments live in `raw`.)
        line = text.count("\n", 0, pos) + 1
        end_line = line + stmt.count("\n") + 1
        ctx = "\n".join(raw_lines[max(0, line - 5):end_line])
        if "not-guarded:" in ctx:
            continue
        member = re.sub(r"=.*", "", stmt).strip().split()[-1]
        problems.append(
            f"{rel}:{line}: NL002 {cls}::{member} is neither GUARDED_BY, "
            "an atomic/const/lock type, nor justified with a "
            "'not-guarded:' comment")
    return problems


def _check_globals(root: str) -> List[str]:
    problems = []
    decl_re = re.compile(r"^[A-Za-z_][\w:<>,&* ]*?\b(g_\w+)\s*(GUARDED_BY"
                         r"\([^)]*\))?\s*(?:\{[^}]*\}|=[^;]*)?;",
                         re.MULTILINE)
    for rel in GLOBAL_SOURCES:
        if not os.path.exists(os.path.join(root, rel)):
            problems.append(f"{rel}: NL002 global source missing (update "
                            "determined_tpu_torch/analysis/native_lint.py "
                            "GLOBAL_SOURCES)")
            continue
        raw = _read(rel, root)
        text = _strip_comments(raw)
        raw_lines = raw.splitlines()
        for m in decl_re.finditer(text):
            stmt = m.group(0)
            if m.group(2) or any(t in stmt for t in _LOCK_FREE_TYPES):
                continue
            line = text.count("\n", 0, m.start()) + 1
            ctx = "\n".join(raw_lines[max(0, line - 4):line + 1])
            if "not-guarded:" in ctx:
                continue
            problems.append(
                f"{rel}:{line}: NL002 global {m.group(1)} is neither "
                "GUARDED_BY, an atomic/const/lock type, nor justified "
                "with a 'not-guarded:' comment")
    return problems


# -- NL003 -----------------------------------------------------------------

def _check_tsa_escapes(root: str) -> Tuple[List[str], int]:
    problems = []
    count = 0
    for rel in _native_files(root):
        if rel.endswith("thread_annotations.h"):
            continue
        raw = _read(rel, root)
        text = _strip_comments(raw)
        raw_lines = raw.splitlines()
        for m in re.finditer(r"\bNO_THREAD_SAFETY_ANALYSIS\b", text):
            count += 1
            line = text.count("\n", 0, m.start()) + 1
            ctx = "\n".join(raw_lines[max(0, line - 3):line + 1])
            if "tsa:" not in ctx:
                problems.append(
                    f"{rel}:{line}: NL003 NO_THREAD_SAFETY_ANALYSIS "
                    "without an inline '// tsa:' justification")
    if count > MAX_TSA_ESCAPES:
        problems.append(
            f"native/: NL003 {count} NO_THREAD_SAFETY_ANALYSIS escapes "
            f"(budget is {MAX_TSA_ESCAPES}) — annotate properly instead")
    return problems, count


# -- NL004 -----------------------------------------------------------------

def _check_fault_registry(root: str) -> List[str]:
    problems = []
    cpp_sites: Set[str] = set()
    for rel in _native_files(root):
        if rel.endswith(".cc"):
            cpp_sites |= set(_FAULT_SITE_RE.findall(_read(rel, root)))
    catalogue_rel = "native/common/faultpoint.cc"
    if not os.path.exists(os.path.join(root, catalogue_rel)):
        return problems + [f"{catalogue_rel}: NL004 fault-point catalogue "
                           "missing"]
    kknown = set(_KKNOWN_RE.findall(_read(catalogue_rel, root)))
    for p in sorted(cpp_sites - kknown):
        problems.append(
            f"native/: NL004 fault point {p!r} fired but missing from the "
            "kKnown catalogue in common/faultpoint.cc")
    for p in sorted(kknown - cpp_sites):
        problems.append(
            f"native/common/faultpoint.cc: NL004 catalogue entry {p!r} has "
            "no FAULT_POINT call site (stale row)")

    py_points: Set[str] = set()
    for rel in PY_FAULT_SOURCES:
        if not os.path.exists(os.path.join(root, rel)):
            problems.append(f"{rel}: NL004 fault source missing (update "
                            "determined_tpu_torch/analysis/native_lint.py "
                            "PY_FAULT_SOURCES)")
            continue
        text = _read(rel, root)
        py_points |= set(_PY_FIRE_RE.findall(text))
        py_points |= set(_PY_CONST_RE.findall(text))

    if not os.path.exists(os.path.join(root, "docs/chaos.md")):
        return problems + ["docs/chaos.md: NL004 fault-point doc missing"]
    documented = set(_CHAOS_ROW_RE.findall(_read("docs/chaos.md", root)))
    emitted = cpp_sites | kknown | py_points
    for p in sorted(emitted - documented):
        problems.append(
            f"docs/chaos.md: NL004 fault point {p!r} emitted but not "
            "documented (add a row to the fault-point table)")
    for p in sorted(documented - emitted):
        problems.append(
            f"docs/chaos.md: NL004 fault point {p!r} documented but "
            "emitted nowhere (stale row)")
    return problems


# -- NL005 -----------------------------------------------------------------

def _check_routes(root: str) -> List[str]:
    problems = []
    for rel in ("native/master/master.cc", "proto/openapi.json"):
        if not os.path.exists(os.path.join(root, rel)):
            return [f"{rel}: NL005 route source missing"]
    dispatched = set(_ROUTE_ROOT_RE.findall(
        _read("native/master/master.cc", root)))
    with open(os.path.join(root, "proto/openapi.json")) as f:
        spec = json.load(f)
    served: Set[str] = set()
    for path in spec.get("paths", {}):
        parts = path.split("/")
        if len(parts) > 3 and parts[1] == "api" and parts[2] == "v1":
            served.add(parts[3])
    for r in sorted(dispatched - served):
        problems.append(
            f"proto/openapi.json: NL005 route root {r!r} dispatched by the "
            "master but absent from the OpenAPI document (add it to "
            "proto/gen_openapi.py ROUTES and regenerate)")
    for r in sorted(served - dispatched):
        problems.append(
            f"native/master/master.cc: NL005 OpenAPI path root {r!r} is "
            "not dispatched by Master::route (stale spec row)")
    return problems


# -- entry -----------------------------------------------------------------

def lint_native(root: str = REPO_ROOT) -> List[str]:
    """Returns violation strings (empty = clean)."""
    problems: List[str] = []
    problems += _check_locked_requires(root)
    problems += _check_guarded_fields(root)
    problems += _check_globals(root)
    escape_problems, _count = _check_tsa_escapes(root)
    problems += escape_problems
    problems += _check_fault_registry(root)
    problems += _check_routes(root)
    return problems


def tsa_escape_count(root: str = REPO_ROOT) -> int:
    return _check_tsa_escapes(root)[1]


def main() -> int:
    problems = lint_native()
    for p in problems:
        print(f"native-lint: {p}")
    print(f"native-lint: {len(problems)} finding(s), "
          f"{tsa_escape_count()}/{MAX_TSA_ESCAPES} "
          "NO_THREAD_SAFETY_ANALYSIS escapes")
    return 1 if problems else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
