"""``python -m repro_torch.check`` — lint flows statically (port of the
reference package's ``analysis/cli.py``).

Any module (example, benchmark, user script) opts in by exposing

    def check_flows():
        return [{"name": "quickstart",
                 "flow": build_flow(),
                 "compile": {"fusion": True, "jit_fusion": True},
                 "sample": sample_table(),        # optional
                 "max_batch": 10,                 # optional
                 "budget_bytes": 2 << 30},        # optional
                ...]

The CLI imports each module by file path, compiles every declared flow
through the real pass pipeline (no runtime, no traffic, no kernel
launch), runs the full verifier, and prints one diagnostic table per
flow.  Abstract inputs are made on the CPU, so a hook builds its models
there (verification runs nothing, so it needs no card).  Exit status 1
iff any severity=error diagnostic fired or a module crashed.  With no
paths it lints the port's own examples.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
import traceback
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

from repro_torch.analysis import Report, analyze
from repro_torch.analysis.diagnostics import CODES
from repro_torch.core.ir import PhysicalPlan
from repro_torch.core.passes import PassContext, build_pipeline

#: build_pipeline kwargs a check entry's "compile" dict may set
_COMPILE_KEYS = ("fusion", "competitive_exec", "locality", "jit_fusion",
                 "batched_lowering", "default_replicas", "plan_config",
                 "place_kernels")


def load_module(path: Path):
    """Import a script by file path under a synthetic module name (a
    linted module need not sit in a package)."""
    name = f"repro_torch_check_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def check_entry(entry: dict) -> Report:
    """Compile one declared flow through the pass pipeline and verify
    the resulting plan."""
    name = entry.get("name", "flow")
    flow = entry["flow"]
    compile_kwargs = {k: v for k, v in
                      dict(entry.get("compile") or {}).items()
                      if k in _COMPILE_KEYS}
    flow.typecheck()
    plan = PhysicalPlan.from_dataflow(flow)
    pipeline = build_pipeline(**compile_kwargs)
    plan = pipeline.run(plan, PassContext())
    return analyze(plan, name=name,
                   plan_config=compile_kwargs.get("plan_config"),
                   sample=entry.get("sample"),
                   input_specs=entry.get("input_specs"),
                   max_batch=entry.get("max_batch"),
                   budget_bytes=entry.get("budget_bytes"))


def check_module(path: Path) -> Optional[List[Tuple[str, Report]]]:
    """All reports for one module, or None when it declares no flows."""
    mod = load_module(path)
    hook = getattr(mod, "check_flows", None)
    if hook is None:
        return None
    return [(e.get("name", f"{path.stem}#{i}"), check_entry(e))
            for i, e in enumerate(hook())]


def discover(paths: Iterable[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.glob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    return [p for p in out if not p.name.startswith("_")]


#: what ``python -m repro_torch.check`` lints when given no paths
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="Statically verify serving dataflow plans.")
    ap.add_argument("paths", nargs="*", default=[str(EXAMPLES)],
                    help="modules or directories to lint "
                         "(default: the port's examples)")
    ap.add_argument("--errors-only", action="store_true",
                    help="print only flows with error diagnostics")
    ap.add_argument("--list-codes", action="store_true",
                    help="print the diagnostic code registry and exit")
    args = ap.parse_args(argv)
    if args.list_codes:
        for code, (title, sev) in sorted(CODES.items()):
            print(f"{code}  {sev:<8}{title}")
        return 0

    n_flows = n_errors = n_warnings = 0
    failed_imports: List[str] = []
    for path in discover(args.paths):
        try:
            reports = check_module(path)
        except Exception:
            failed_imports.append(str(path))
            print(f"!! {path}: crashed while checking", file=sys.stderr)
            traceback.print_exc()
            continue
        if reports is None:
            continue
        for _name, report in reports:
            n_flows += 1
            n_errors += len(report.errors())
            n_warnings += len(report.warnings())
            if args.errors_only and report.ok:
                continue
            print(report.table())
            print()
    print(f"checked {n_flows} flow(s): {n_errors} error(s), "
          f"{n_warnings} warning(s)"
          + (f", {len(failed_imports)} module(s) crashed"
             if failed_imports else ""))
    return 1 if n_errors or failed_imports else 0
