"""Static plan verification (port of the reference package's
``analysis/``): abstract interpretation + invariant checking + resource
linting over the ``PhysicalPlan`` IR, before any kernel launch, any
device allocation and any traffic.

Entry points:

* :func:`analyze` — run shape/dtype/placement inference and every
  registered :class:`~repro_torch.analysis.checks.Check` over one plan,
  returning a :class:`~repro_torch.analysis.diagnostics.Report`.
* ``compile_flow(verify=...)`` — the compiler wiring (see
  ``repro_torch.core.compiler``): ``verify=True``/``"error"`` raises
  :class:`~repro_torch.analysis.diagnostics.VerificationError` on any
  severity=error diagnostic, ``"warn"`` only attaches the report.
* ``PassPipeline(verify=True)`` — differential pass checking: every
  pass must preserve inferred edge types (CF502) and introduce no new
  error diagnostics (CF501).
* ``python -m repro_torch.check`` — the CLI linter over flows that
  declare a ``check_flows()`` hook (see ``repro_torch.analysis.cli``).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.analysis.checks import (AnalysisContext, Check,
                                         default_checks, device_edge_info)
from repro_torch.analysis.diagnostics import (CODES, Diagnostic, Report,
                                              VerificationError)
from repro_torch.analysis.infer import (EdgeType, edge_signature, infer,
                                        specs_from_table)
from repro_torch.analysis.memory import (footprint_bytes,
                                        footprint_diagnostics)

__all__ = [
    "AnalysisContext", "CODES", "Check", "Diagnostic", "EdgeType",
    "Report", "VerificationError", "analyze", "default_checks",
    "device_edge_info", "edge_signature", "footprint_bytes", "infer",
    "pass_snapshot", "specs_from_table", "verify_pass_step",
]


def analyze(plan, *, runtime=None, plan_config=None,
            input_specs: Optional[Dict[str, object]] = None,
            sample=None, max_batch: Optional[int] = None,
            budget_bytes: Optional[int] = None,
            checks=None, name: str = "plan",
            check_buckets: bool = True, device=None) -> Report:
    """Verify one plan: infer per-edge types/shapes, then run every
    invariant check.  ``sample`` (a request Table) is a convenience
    source for ``input_specs``; ``budget_bytes`` defaults to the
    runtime's per-executor cache budget when a runtime is given.
    Abstract inputs are made on ``device``: the runtime's when a
    runtime is given, else the CPU.  The report's ``kernel_checks``
    lists the kernel calls the launch-rule check (CF103) checked, and
    ``footprint`` the static footprint of each batch-lowered chain
    (op id -> (peak bytes, bytes per row, bucket))."""
    report = Report(plan_name=name)
    if input_specs is None and sample is not None:
        input_specs = specs_from_table(sample)
    if device is None and runtime is not None:
        device = getattr(runtime, "device", None)
    types, report = infer(plan, input_specs, report,
                          check_buckets=check_buckets, device=device)
    ctx = AnalysisContext(plan=plan, types=types, runtime=runtime,
                          plan_config=plan_config, max_batch=max_batch,
                          budget_bytes=budget_bytes)
    if budget_bytes is None and runtime is not None:
        budget_bytes = getattr(getattr(runtime, "pool", None),
                               "cache_bytes", None)
    for check in (checks if checks is not None else default_checks()):
        try:
            report.extend(check.run(ctx))
        except Exception as e:          # a broken check must not mask
            raise RuntimeError(         # real diagnostics silently
                f"static check {check.name!r} crashed: {e}") from e

    def max_batch_of(op_id):
        return ctx.node_max_batch(op_id) if plan.op(op_id).batching else 1

    report.extend(footprint_diagnostics(
        plan, types, budget_bytes=budget_bytes, max_batch_of=max_batch_of))
    report.kernel_checks = ctx.kernel_checks
    report.footprint = footprint_bytes(plan, types, max_batch_of)
    return report


# -- differential pass checking (PassPipeline(verify=True)) ----------------

def pass_snapshot(plan):
    """Structural snapshot of one plan for differential pass checking:
    (error-code counts, per-edge type signature).  Runs the structural
    checks with no runtime/specs — cheap, and identical context before
    and after each pass so only the pass's own effect shows up."""
    import collections

    report = Report(plan_name="pipeline")
    types, report = infer(plan, None, report, check_buckets=False)
    ctx = AnalysisContext(plan=plan, types=types)
    for check in default_checks():
        report.extend(check.run(ctx))
    codes = collections.Counter(d.code for d in report.errors())
    return codes, edge_signature(types), report


def verify_pass_step(pass_name: str, plan, baseline):
    """Compare a plan against the pre-pass snapshot; raise
    :class:`VerificationError` if the pass introduced new error
    diagnostics (CF501) or changed the inferred type of an edge that
    survived the pass (CF502).  Returns the new snapshot to feed the
    next pass."""
    base_codes, base_sig, _ = baseline
    codes, sig, rep = pass_snapshot(plan)
    vr = Report(plan_name=f"after pass {pass_name}")
    for code, n in sorted(codes.items()):
        extra = n - base_codes.get(code, 0)
        if extra > 0:
            first = next(d for d in rep.errors() if d.code == code)
            vr.add(Diagnostic(
                "CF501",
                f"pass {pass_name!r} introduced {extra} new {code} "
                f"error(s); first: {first.message}",
                hint="the pass produced a plan the structural checks "
                     "reject — fix the pass, not the plan"))
    for op_id, s in sorted(base_sig.items()):
        if op_id in sig and sig[op_id] != s:
            vr.add(Diagnostic(
                "CF502",
                f"pass {pass_name!r} changed the inferred edge type of "
                f"op {op_id}: {s} -> {sig[op_id]}",
                op_id=op_id,
                hint="passes must preserve per-edge schemas/groupings "
                     "for ops they keep"))
    if not vr.ok:
        raise VerificationError(
            vr, context=f"pipeline self-verification after {pass_name!r}")
    return codes, sig, rep
