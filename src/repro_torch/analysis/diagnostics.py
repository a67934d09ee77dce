"""Structured diagnostics for the static plan verifier (port of the
reference package's ``analysis/diagnostics.py``; the code set, titles and
severities are the reference's).

Every finding the verifier makes is a :class:`Diagnostic` with a stable
code (``CF101``-style, greppable and testable), a severity, the op/edge
it anchors to, and a fix hint — the shape PRETZEL argues white-box
pipeline analysis should surface *before* traffic, not as a runtime
stack trace.  A :class:`Report` aggregates them per analyzed plan and
renders the CLI's diagnostic table; :class:`VerificationError` is what
``compile_flow(verify="error")`` raises, carrying the report so callers
(and tests) can inspect exactly what fired.

Code ranges:

* ``CF1xx`` — abstract interpretation (shapes/dtypes/traceability,
  kernel launch rules)
* ``CF2xx`` — IR invariants (donation, residency, wait-any, buckets,
  executor classes)
* ``CF3xx`` — resource bounds (device-memory footprint)
* ``CF4xx`` — observability lints (metric key registry)
* ``CF5xx`` — pipeline self-verification (differential pass checking)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

#: code -> (title, default severity).  The registry is the single source
#: of truth: a Diagnostic with an unknown code is a programming error.
CODES: Dict[str, Tuple[str, str]] = {
    "CF101": ("edge shape/dtype mismatch", "error"),
    "CF102": ("step not traceable for jit lowering", "error"),
    "CF103": ("kernel tile params incompatible with operand shapes",
              "error"),
    "CF104": ("filter return type cannot lower to a mask", "warning"),
    "CF201": ("buffer donation on a shared/fan-out edge", "error"),
    "CF202": ("device-resident edge crosses executor classes", "error"),
    "CF203": ("wait-any arity vs competitive replica count", "error"),
    "CF204": ("batch buckets do not cover max_batch", "warning"),
    "CF205": ("placement names a class with zero executors", "error"),
    "CF206": ("all executors of a class are reserved", "error"),
    "CF301": ("static device-memory footprint exceeds budget", "error"),
    "CF401": ("recorded metric key not in the obs key registry",
              "warning"),
    "CF501": ("pass introduced new error diagnostics", "error"),
    "CF502": ("pass changed inferred edge types", "error"),
}

_SEV_ORDER = {"error": 0, "warning": 1, "info": 2}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: where, what, how bad, and how to fix it."""
    code: str
    message: str
    severity: str = ""            # defaults from CODES when empty
    op_id: Optional[int] = None
    edge: Optional[Tuple[int, int]] = None    # (producer, consumer)
    hint: str = ""

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if not self.severity:
            object.__setattr__(self, "severity", CODES[self.code][1])
        if self.severity not in _SEV_ORDER:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def title(self) -> str:
        return CODES[self.code][0]

    def where(self) -> str:
        if self.edge is not None:
            return f"edge {self.edge[0]}->{self.edge[1]}"
        if self.op_id is not None:
            return f"op {self.op_id}"
        return "plan"

    def __str__(self) -> str:
        s = f"{self.code} {self.severity} [{self.where()}]: {self.message}"
        if self.hint:
            s += f" (hint: {self.hint})"
        return s


class Report:
    """All diagnostics from one verification run."""

    def __init__(self, plan_name: str = "plan"):
        self.plan_name = plan_name
        self.diagnostics: List[Diagnostic] = []
        #: set by ``analyze``: the kernel calls CF103 checked, as (op id,
        #: kernel, operand shapes), and each batch-lowered chain's static
        #: footprint, op id -> (peak bytes, bytes per row, bucket)
        self.kernel_checks: List[Tuple[int, str, Tuple]] = []
        self.footprint: Dict[int, Tuple[int, int, int]] = {}

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags) -> None:
        self.diagnostics.extend(diags)

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def sorted(self) -> List[Diagnostic]:
        return sorted(self.diagnostics,
                      key=lambda d: (_SEV_ORDER[d.severity], d.code,
                                     d.op_id if d.op_id is not None else -1))

    def table(self) -> str:
        """The CLI's diagnostic table: one row per finding, worst first."""
        if not self.diagnostics:
            return f"{self.plan_name}: clean (no diagnostics)"
        rows = [("CODE", "SEV", "WHERE", "MESSAGE")]
        for d in self.sorted():
            rows.append((d.code, d.severity, d.where(),
                         d.message + (f"  [hint: {d.hint}]" if d.hint
                                      else "")))
        widths = [max(len(r[i]) for r in rows) for i in range(3)]
        lines = [f"-- {self.plan_name}: {len(self.errors())} error(s), "
                 f"{len(self.warnings())} warning(s) --"]
        for r in rows:
            lines.append(f"{r[0]:<{widths[0]}}  {r[1]:<{widths[1]}}  "
                         f"{r[2]:<{widths[2]}}  {r[3]}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"Report({self.plan_name!r}, errors={len(self.errors())}, "
                f"warnings={len(self.warnings())})")


class VerificationError(RuntimeError):
    """Raised when verification finds severity=error diagnostics and the
    caller asked for errors to be fatal (``compile_flow(verify=...)``,
    ``PassPipeline(verify=True)``)."""

    def __init__(self, report: Report, context: str = ""):
        self.report = report
        head = f"plan verification failed ({context})" if context \
            else "plan verification failed"
        msgs = "\n".join(str(d) for d in report.errors())
        super().__init__(f"{head}:\n{msgs}")
