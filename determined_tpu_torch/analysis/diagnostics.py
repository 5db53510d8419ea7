"""Diagnostic records and report formatting shared by both engines.

Counterpart of determined_tpu/analysis/diagnostics.py, copied whole: the
same `Diagnostic`, `Report` (and its `hbm` keys) and JSON form, so that the
two packages' reports compare key by key.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence

_CODE_RE = re.compile(r"^DTL\d{3}$")


@dataclasses.dataclass
class Diagnostic:
    """One finding. `level` is the rule's level unless overridden."""

    code: str
    message: str
    level: str = "warning"  # "error" | "warning"
    file: Optional[str] = None
    line: Optional[int] = None
    engine: str = ""  # "abstract" | "ast" | "config"
    suppressed: bool = False
    suppressed_by: Optional[str] = None  # "noqa" | "config"

    def to_dict(self) -> Dict[str, Any]:
        d = {"code": self.code, "level": self.level, "message": self.message,
             "engine": self.engine}
        if self.file is not None:
            d["file"] = self.file
        if self.line is not None:
            d["line"] = self.line
        if self.suppressed:
            d["suppressed"] = True
            d["suppressed_by"] = self.suppressed_by
        return d

    def location(self) -> str:
        if self.file is None:
            return ""
        return f"{self.file}:{self.line}" if self.line else self.file


def filter_suppressed(
    diagnostics: Iterable[Diagnostic], suppress: Sequence[str] = ()
) -> List[Diagnostic]:
    """Mark config-suppressed codes; returns the full (annotated) list."""
    out = []
    codes = {c for c in suppress if _CODE_RE.match(str(c))}
    for d in diagnostics:
        if not d.suppressed and d.code in codes:
            d = dataclasses.replace(d, suppressed=True, suppressed_by="config")
        out.append(d)
    return out


@dataclasses.dataclass
class Report:
    """A full preflight run: diagnostics + the HBM footprint breakdown."""

    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    hbm: Dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def active(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if not d.suppressed]

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.active if d.level == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.active if d.level == "warning"]

    def codes(self) -> List[str]:
        return sorted({d.code for d in self.active})

    def extend(self, diagnostics: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diagnostics)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "summary": {
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "suppressed": sum(1 for d in self.diagnostics if d.suppressed),
                "codes": self.codes(),
            },
            "hbm": self.hbm,
            "notes": self.notes,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def to_text(self) -> str:
        lines: List[str] = []
        for d in sorted(self.diagnostics,
                        key=lambda d: (d.file or "", d.line or 0, d.code)):
            loc = d.location()
            prefix = f"{loc}: " if loc else ""
            tag = f"{d.level} {d.code}"
            if d.suppressed:
                tag += f" (suppressed: {d.suppressed_by})"
            lines.append(f"{prefix}{tag}: {d.message}")
        if self.hbm:
            lines.append("")
            lines.append("per-device HBM footprint (estimated lower bound):")
            for key in ("params_bytes", "opt_state_bytes", "grads_bytes",
                        "donation_extra_bytes", "batch_bytes",
                        "activations_upper_bound_bytes", "total_bytes"):
                if key in self.hbm:
                    lines.append(f"  {key:30s} {_human(self.hbm[key])}")
            if "budget_bytes" in self.hbm:
                lines.append(f"  {'budget_bytes':30s} {_human(self.hbm['budget_bytes'])}")
        for n in self.notes:
            lines.append(f"note: {n}")
        ne, nw = len(self.errors), len(self.warnings)
        lines.append("")
        if ne or nw:
            lines.append(f"preflight: {ne} error(s), {nw} warning(s)")
        else:
            lines.append("preflight: clean")
        return "\n".join(lines)


def _human(n: Any) -> str:
    try:
        n = float(n)
    except (TypeError, ValueError):
        return str(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:,.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return str(n)
