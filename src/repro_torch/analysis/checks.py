"""Composable IR invariant checkers (port of the reference package's
``analysis/checks.py``).

Each :class:`Check` inspects one invariant of a ``PhysicalPlan`` (plus
optional runtime/plan-config context) and emits structured
:class:`~repro_torch.analysis.diagnostics.Diagnostic`s.  The residency checks
mirror ``RuntimeDag.from_plan``'s device-edge analysis statically, so
what the verifier calls a device edge is exactly what the runtime will
treat as one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.infer import EdgeType, _chain_of
from repro_torch.core import operators as ops
from repro_torch.core.ir import PhysicalPlan
from repro_torch.core.lowering import BatchedJittedFuse, bucket_rows

#: the runtime's default merge cap (Runtime(max_batch=10)) — what bucket
#: coverage is judged against when no explicit cap is configured
DEFAULT_MAX_BATCH = 10


@dataclasses.dataclass
class AnalysisContext:
    """Everything a check may consult.  ``runtime`` and ``plan_config``
    are optional — checks that need them skip when absent."""
    plan: PhysicalPlan
    types: Dict[int, EdgeType] = dataclasses.field(default_factory=dict)
    runtime: object = None
    plan_config: object = None
    max_batch: Optional[int] = None
    budget_bytes: Optional[int] = None
    #: what the launch-rule check (CF103) checked: (op id, kernel,
    #: operand shapes), one per distinct call
    kernel_checks: List[Tuple[int, str, Tuple]] = \
        dataclasses.field(default_factory=list)

    def consumers(self) -> Dict[int, List]:
        out: Dict[int, List] = {}
        for o in self.plan.ops:
            for i in o.inputs:
                out.setdefault(i, []).append(o)
        return out

    def node_max_batch(self, op_id: int) -> int:
        if self.plan_config is not None:
            try:
                mb = int(self.plan_config.node(op_id).max_batch)
                if mb > 1:
                    return mb
            except Exception:
                pass
        if self.max_batch is not None:
            return int(self.max_batch)
        if self.runtime is not None:
            return int(getattr(self.runtime, "max_batch",
                               DEFAULT_MAX_BATCH))
        return DEFAULT_MAX_BATCH


def device_edge_info(plan: PhysicalPlan) -> Dict[int, Tuple[bool, bool]]:
    """Static mirror of ``RuntimeDag.from_plan``'s residency analysis:
    per op id, (emits_device, donates).  An explicit ``op.donate=True``
    annotation forces the donation intent (that is what CF201 audits);
    ``donate=None`` derives the runtime's safe default."""
    consumers: Dict[int, List] = {}
    for o in plan.ops:
        for i in o.inputs:
            consumers.setdefault(i, []).append(o)
    info: Dict[int, Tuple[bool, bool]] = {}
    for o in plan.ops:
        dev = isinstance(o.op, BatchedJittedFuse) and o.device_resident
        cons = consumers.get(o.op_id, [])
        emits = (dev and bool(cons) and o.op_id != plan.output_id
                 and all(c.device_resident and not c.wait_any
                         and not c.batching and len(c.inputs) == 1
                         for c in cons))
        explicit = getattr(o, "donate", None)
        donate = bool(explicit) if explicit is not None \
            else (emits and len(cons) == 1)
        info[o.op_id] = (emits, donate)
    return info


class Check:
    """Base: subclasses set ``name`` and implement ``run(ctx)``."""
    name = "check"

    def run(self, ctx: AnalysisContext) -> List[Diagnostic]:
        raise NotImplementedError


class DonatedFanOutCheck(Check):
    """CF201: a buffer donated on a shared edge is deleted out from
    under every consumer but the one that received it."""
    name = "donated-fan-out"

    def run(self, ctx):
        out = []
        consumers = ctx.consumers()
        for o in ctx.plan.ops:
            if getattr(o, "donate", None) is not True:
                continue
            cons = consumers.get(o.op_id, [])
            if len(cons) > 1:
                out.append(Diagnostic(
                    "CF201",
                    f"op {o.op_id} ({o.op.name}) donates its output "
                    f"buffers but the edge fans out to "
                    f"{len(cons)} consumers "
                    f"({', '.join(str(c.op_id) for c in cons)})",
                    op_id=o.op_id,
                    edge=(o.op_id, cons[1].op_id),
                    hint="drop donate=True (the runtime derives safe "
                         "donation) or restructure so the edge has one "
                         "consumer"))
                continue
            bad = [c for c in cons
                   if c.wait_any or c.batching or len(c.inputs) > 1]
            for c in bad:
                out.append(Diagnostic(
                    "CF201",
                    f"op {o.op_id} ({o.op.name}) donates into consumer "
                    f"{c.op_id} ({c.op.name}), which "
                    + ("waits on any input" if c.wait_any else
                       "re-batches requests" if c.batching else
                       "joins multiple inputs")
                    + " — the donated buffer outlives the dispatch",
                    op_id=o.op_id, edge=(o.op_id, c.op_id),
                    hint="drop donate=True on this edge"))
        return out


class DeviceCrossClassCheck(Check):
    """CF202: a device-resident edge whose consumer is placed on a
    different executor class — the runtime will pin the consumer to the
    producer's device, silently overriding the declared placement."""
    name = "device-cross-class"

    def run(self, ctx):
        out = []
        info = device_edge_info(ctx.plan)
        consumers = ctx.consumers()
        for o in ctx.plan.ops:
            emits, _ = info[o.op_id]
            if not emits:
                continue
            for c in consumers.get(o.op_id, []):
                if c.placement != o.placement:
                    out.append(Diagnostic(
                        "CF202",
                        f"device-resident edge {o.op_id}->{c.op_id}: "
                        f"producer {o.op.name!r} emits on "
                        f"{o.placement!r} but consumer {c.op.name!r} is "
                        f"placed on {c.placement!r}; the runtime will "
                        f"pin the consumer to the producer's device",
                        op_id=c.op_id, edge=(o.op_id, c.op_id),
                        hint=f"place op {c.op_id} on {o.placement!r} or "
                             f"mark it device_resident=False to force a "
                             f"host round-trip"))
        return out


class WaitAnyArityCheck(Check):
    """CF203: wait-any consumers need >=2 upstreams to race; and a
    competitive-replica annotation that no pass materialized races
    nothing at all."""
    name = "wait-any-arity"

    def run(self, ctx):
        out = []
        consumers = ctx.consumers()
        for o in ctx.plan.ops:
            if o.wait_any and len(o.inputs) < 2:
                out.append(Diagnostic(
                    "CF203",
                    f"op {o.op_id} ({o.op.name}) has wait-any semantics "
                    f"but only {len(o.inputs)} upstream — nothing to "
                    f"race, first-completion degenerates to "
                    f"wait-for-all",
                    op_id=o.op_id,
                    hint="give the anyof >=2 upstream branches or run "
                         "the competitive pass to replicate its input"))
            if not o.wait_any and o.replicas >= 2:
                raced = any(c.wait_any for c in consumers.get(o.op_id, []))
                if not raced:
                    out.append(Diagnostic(
                        "CF203",
                        f"op {o.op_id} ({o.op.name}) is annotated with "
                        f"{o.replicas} competitive replicas but no pass "
                        f"materialized the race (no wait-any consumer)",
                        severity="warning", op_id=o.op_id,
                        hint="compile with competitive_exec=True (or a "
                             "plan-config replica override) to "
                             "materialize the replicas"))
        return out


class BucketCoverageCheck(Check):
    """CF204: the PR-5 covering-bucket rule — a full batcher merge pads
    to ``bucket_rows(max_batch)``; if that exceeds the configured bucket
    table, the first full batch builds a fresh executable in serving."""
    name = "bucket-coverage"

    def run(self, ctx):
        out = []
        for o in ctx.plan.ops:
            op = o.op
            if not isinstance(op, BatchedJittedFuse) or not op.bucket_sizes:
                continue
            if not o.batching:
                continue        # unbatched nodes serve one request a time
            mb = ctx.node_max_batch(o.op_id)
            cover = bucket_rows(mb, op.bucket_sizes)
            top = max(op.bucket_sizes)
            if cover > top:
                out.append(Diagnostic(
                    "CF204",
                    f"op {o.op_id} ({op.name}) batches up to {mb} rows "
                    f"but its bucket table tops out at {top}; a full "
                    f"merge pads to {cover} and builds a fresh "
                    f"executable on the serving path",
                    op_id=o.op_id,
                    hint=f"add bucket {cover} to the node's "
                         f"batch_buckets or cap max_batch at {top}"))
        return out


class PlacementClassCheck(Check):
    """CF205/CF206: placements must name executor classes that can
    actually serve.  Needs a runtime (skipped without one)."""
    name = "placement-class"

    def run(self, ctx):
        if ctx.runtime is None:
            return []
        pool = getattr(ctx.runtime, "pool", None)
        if pool is None:
            return []
        out = []
        seen = set()
        for o in ctx.plan.ops:
            cls = o.placement
            if cls in seen:
                continue
            seen.add(cls)
            serving = pool.by_class(cls)
            if serving:
                continue
            reserved = pool.by_class(cls, reserved=True)
            ops_on = [p.op_id for p in ctx.plan.ops if p.placement == cls]
            if reserved:
                out.append(Diagnostic(
                    "CF206",
                    f"every {cls!r} executor is reserved for "
                    f"warm-up/canary traffic; ops {ops_on} have no "
                    f"serving worker and every dispatch will fail",
                    op_id=ops_on[0],
                    hint=f"provision at least one unreserved {cls!r} "
                         f"executor (e.g. Runtime(n_{cls}=1))"))
            else:
                out.append(Diagnostic(
                    "CF205",
                    f"ops {ops_on} are placed on class {cls!r} but the "
                    f"pool has zero {cls!r} executors; dispatch will "
                    f"raise at the first request",
                    op_id=ops_on[0],
                    hint=f"provision {cls!r} executors or override the "
                         f"placement in the plan config"))
        return out


class KernelTileCheck(Check):
    """CF103: a kernel's operand shapes must pass its CUDA launch rules
    (``KernelSpec.check_tiles``: what the wrapper checks before it
    launches, the rules the kernel raises ``KernelError`` on), so a plan
    the card would refuse fails the compile instead of the first
    dispatch.  Two kinds of call are checked: a kernel step of the chain
    (oracle or placed twin), with the inferred specs of its operands, and
    a kernel wrapper called inside a step (a model stage's attention),
    with the shapes the abstract walk recorded.  Steps without inferred
    specs are skipped."""
    name = "kernel-tiles"

    def run(self, ctx):
        from repro_torch.kernels.ops import KERNEL_REGISTRY, kernel_call_of
        out = []
        for o in ctx.plan.ops:
            steps = _chain_of(o.op)
            if steps is None or len(o.inputs) != 1:
                continue
            et = ctx.types.get(o.op_id)
            walked = et.steps if et is not None and et.steps else None
            calls = []
            for i, step in enumerate(steps):
                fn = getattr(step, "fn", None)
                kc = kernel_call_of(fn) if fn is not None else None
                if kc is not None and walked is not None:
                    calls.append((kc.kernel, tuple(
                        tuple(s.shape) for s in walked[i])))
            calls.extend(et.kernels if et is not None else ())
            problems = []
            for kernel, shapes in dict.fromkeys(calls):
                spec = KERNEL_REGISTRY.get(kernel)
                if spec is None:
                    continue
                ctx.kernel_checks.append((o.op_id, kernel, shapes))
                for problem in spec.check_tiles(dict(zip(spec.args,
                                                         shapes))):
                    if problem not in problems:
                        problems.append(problem)
            for problem in problems:
                out.append(Diagnostic(
                    "CF103", f"op {o.op_id} kernel {problem}",
                    op_id=o.op_id,
                    hint="the CUDA kernel refuses these operands at launch "
                         "(KernelError); change the operand shapes (head "
                         "dims, heads per kv head) or keep the step off "
                         "the kernel"))
        return out


class FilterMaskCheck(Check):
    """CF104: a gpu-placed chain with a filter whose return annotation
    is missing cannot lower the filter to a mask — the chain silently
    stays eager."""
    name = "filter-mask"

    def run(self, ctx):
        out = []
        for o in ctx.plan.ops:
            if o.placement != "gpu":
                continue
            steps = _chain_of(o.op)
            if steps is None:
                continue
            for step in steps:
                if isinstance(step, ops.Filter) and step._ret is not bool:
                    out.append(Diagnostic(
                        "CF104",
                        f"op {o.op_id}: filter {step.name!r} is placed "
                        f"on gpu but its return type is not annotated "
                        f"bool; it cannot lower to a mask, so the chain "
                        f"will not jit-fuse",
                        op_id=o.op_id,
                        hint="annotate the predicate's return type as "
                             "bool"))
        return out


class KeyRegistryCheck(Check):
    """CF401: every metric series the runtime recorded must match the
    ``obs.keys`` registry — a typo'd key otherwise just creates an
    empty, never-read series."""
    name = "metric-key-registry"

    def run(self, ctx):
        if ctx.runtime is None:
            return []
        from repro_torch.obs import keys as K
        out = []
        snapshot = getattr(ctx.runtime, "metrics_snapshot", None)
        if snapshot is None:
            return []
        for key in sorted(snapshot()):
            if not K.known_key(key):
                out.append(Diagnostic(
                    "CF401",
                    f"recorded metric key {key!r} matches no pattern in "
                    f"repro_torch.obs.keys",
                    hint="use the obs.keys constants/formatters instead "
                         "of inline f-strings, or register the new "
                         "series pattern"))
        return out


def default_checks() -> List[Check]:
    return [DonatedFanOutCheck(), DeviceCrossClassCheck(),
            WaitAnyArityCheck(), BucketCoverageCheck(),
            PlacementClassCheck(), KernelTileCheck(), FilterMaskCheck(),
            KeyRegistryCheck()]
