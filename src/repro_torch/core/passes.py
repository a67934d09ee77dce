"""Pass manager over the physical-plan IR (port of the reference
package's ``core/passes.py``; paper §4 rewrites, re-expressed).

Each optimization is a ``Pass``: a pure ``PhysicalPlan -> PhysicalPlan``
transform.  ``PassPipeline`` runs a configured sequence, re-validating and
re-typechecking the plan after every pass (so a broken transform fails at
compile time, not in an executor thread) and recording a per-pass trace
(op counts, wall time, notes).

Passes:

* ``FuseChainsPass``       — operator fusion: collapse single-consumer
  linear chains into one ``Fuse`` op, keeping the constituents' hints
  (``high_variance``, ``replicas``), so fusion composes with competitive
  execution instead of silently disabling it.
* ``CompetitivePass``      — replicate high-variance ops k times, consume
  with a wait-for-any op.
* ``FuseLookupsPass``      — locality: fuse lookups into their consumer
  and annotate the result for resolved-ref dynamic dispatch.
* ``ApplyPlanConfigPass``  — stamp an SLO optimizer plan config's
  per-node placement and replication choices onto the IR.
* ``PlaceKernelsPass``     — kernel placement: swap map steps tagged (or
  pattern-matched) as registered attention computations for their CUDA
  kernel twins, so lowered chains launch the kernels natively.
* ``LowerTorchChainsPass`` — lower eligible fused tensor chains into one
  composed callable (``JittedFuse``/``BatchedJittedFuse``).

``build_pipeline`` maps optimization flags onto a pass configuration —
the plan *is* the pass configuration.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict, List, Optional, Protocol, Tuple, \
    runtime_checkable

from repro_torch.core import operators as ops
from repro_torch.core.ir import SOURCE_ID, PhysicalOp, PhysicalPlan
from repro_torch.core.lowering import (DEFAULT_BUCKETS,
                                       fuse_is_torch_lowerable, lower_fuse,
                                       op_is_torch_lowerable)


@dataclasses.dataclass
class PassTrace:
    name: str
    ops_before: int
    ops_after: int
    duration_s: float
    notes: List[str] = dataclasses.field(default_factory=list)

    def __repr__(self):
        extra = f" ({'; '.join(self.notes)})" if self.notes else ""
        return (f"{self.name}: {self.ops_before} -> {self.ops_after} ops "
                f"in {self.duration_s * 1e3:.2f}ms{extra}")


class PassContext:
    """Mutable per-compilation state shared by the passes in a pipeline."""

    def __init__(self):
        self.trace: List[PassTrace] = []
        self.notes: List[str] = []

    def note(self, msg: str):
        self.notes.append(msg)


@runtime_checkable
class Pass(Protocol):
    """A plan transform.  Implementations must be pure w.r.t. the input
    plan (``PhysicalPlan`` is immutable; build a new one via ``with_ops``)."""
    name: str

    def run(self, plan: PhysicalPlan, ctx: PassContext) -> PhysicalPlan:
        ...


class PassPipeline:
    """Runs passes in order with post-pass validation + typechecking.

    ``verify=True`` turns the pass suite into a differentially checked
    compiler: the static verifier's structural checks run between every
    pass, and a pass that introduces new error diagnostics (CF501) or
    changes the inferred per-edge types of surviving ops (CF502) fails
    the compile with a :class:`repro_torch.analysis.VerificationError` naming
    the offending pass — instead of shipping a silently miscompiled plan
    to the runtime."""

    def __init__(self, passes: List[Pass], *, validate: bool = True,
                 verify: bool = False):
        self.passes = list(passes)
        self.validate = validate
        self.verify = verify

    def run(self, plan: PhysicalPlan,
            ctx: Optional[PassContext] = None) -> PhysicalPlan:
        ctx = ctx or PassContext()
        if self.validate:
            plan.validate()
            plan.typecheck()
        snapshot = None
        if self.verify:
            from repro_torch.analysis import pass_snapshot
            snapshot = pass_snapshot(plan)
        for p in self.passes:
            before = len(plan.ops)
            notes_start = len(ctx.notes)
            t0 = time.perf_counter()
            plan = p.run(plan, ctx)
            dt = time.perf_counter() - t0
            if self.validate:
                plan.validate()
                plan.typecheck()   # every pass must preserve well-typedness
            if snapshot is not None:
                from repro_torch.analysis import verify_pass_step
                snapshot = verify_pass_step(p.name, plan, snapshot)
            ctx.trace.append(PassTrace(p.name, before, len(plan.ops), dt,
                                       list(ctx.notes[notes_start:])))
        return plan

    def __repr__(self):
        return "PassPipeline[" + " -> ".join(p.name for p in self.passes) + "]"


# ---------------------------------------------------------------------------
# helpers shared by the fusion-shaped passes
# ---------------------------------------------------------------------------

def _sub_ops(op: ops.Operator) -> List[ops.Operator]:
    return list(op.ops) if isinstance(op, ops.Fuse) else [op]


def _starts_with_lookup(op: ops.Operator) -> bool:
    subs = _sub_ops(op)
    return bool(subs) and isinstance(subs[0], ops.Lookup)


def _ends_with_lookup(op: ops.Operator) -> bool:
    subs = _sub_ops(op)
    return bool(subs) and isinstance(subs[-1], ops.Lookup)


def _merge(plan: PhysicalPlan, up: PhysicalOp, down: PhysicalOp) -> PhysicalPlan:
    """Replace ``up -> down`` with one fused op in ``down``'s slot.  Hints
    from BOTH constituents survive (fusion must not disable competitive
    replication downstream)."""
    fused = ops.Fuse(_sub_ops(up.op) + _sub_ops(down.op))
    fused.resource_class = down.placement
    fused.batching = down.batching
    fused.high_variance = up.high_variance or down.high_variance
    fused.competitive_replicas = max(up.replicas, down.replicas)
    merged = down.replace(
        op=fused, inputs=up.inputs,
        placement=down.placement, batching=down.batching,
        high_variance=fused.high_variance,
        replicas=fused.competitive_replicas,
        locality_ref_column=down.locality_ref_column or up.locality_ref_column,
        locality_const=down.locality_const or up.locality_const)
    new_ops = [merged if o.op_id == down.op_id else o
               for o in plan.ops if o.op_id != up.op_id]
    return plan.with_ops(new_ops)


def _fusible_edge(plan: PhysicalPlan, down: PhysicalOp,
                  counts: Dict[int, int]) -> Optional[PhysicalOp]:
    """The structural preconditions shared by fusion and lookup-fusion:
    ``down`` has one input, which is a non-source op with exactly one
    consumer, itself single-input, not the output, not wait-any."""
    if len(down.inputs) != 1 or down.inputs[0] == SOURCE_ID:
        return None
    up = plan.op(down.inputs[0])
    if counts.get(up.op_id, 0) != 1 or up.op_id == plan.output_id:
        return None
    if len(up.inputs) != 1 or up.wait_any:
        return None
    return up


@dataclasses.dataclass
class FuseChainsPass:
    """Operator fusion (paper §4): greedily collapse linear chains."""
    across_resource_classes: bool = False
    preserve_lookup_boundaries: bool = False
    name: str = dataclasses.field(default="fuse-chains", init=False)

    def run(self, plan: PhysicalPlan, ctx: PassContext) -> PhysicalPlan:
        fused_edges = 0
        changed = True
        while changed:
            changed = False
            counts = plan.consumer_counts()
            for down in plan.ops:
                up = _fusible_edge(plan, down, counts)
                if up is None:
                    continue
                if self.preserve_lookup_boundaries and \
                        _starts_with_lookup(down.op):
                    # keep the upstream un-fused so dynamic dispatch sees
                    # the resolved ref (the paper's to-be-continued split)
                    continue
                if not self.across_resource_classes and \
                        up.placement != down.placement:
                    continue
                if up.batching != down.batching:
                    continue
                plan = _merge(plan, up, down)
                fused_edges += 1
                changed = True
                break
        if fused_edges:
            ctx.note(f"fused {fused_edges} edges")
        return plan


@dataclasses.dataclass
class CompetitivePass:
    """Competitive execution (paper §4): replicate high-variance ops and
    consume the replicas with wait-for-any."""
    default_replicas: int = 3
    name: str = dataclasses.field(default="competitive", init=False)

    def run(self, plan: PhysicalPlan, ctx: PassContext) -> PhysicalPlan:
        next_id = plan.next_id()
        new_ops: List[PhysicalOp] = []
        expanded = 0
        for o in plan.ops:
            k = o.replicas or (self.default_replicas if o.high_variance
                               else 0)
            if k <= 1 or o.wait_any:
                new_ops.append(o)
                continue
            replica_ids = []
            for _ in range(k):
                rep_op = copy.copy(o.op)
                rep_op.competitive_replicas = 0
                rep_op.high_variance = False
                new_ops.append(PhysicalOp(
                    op_id=next_id, op=rep_op, inputs=o.inputs,
                    placement=o.placement, batching=o.batching,
                    locality_ref_column=o.locality_ref_column,
                    locality_const=o.locality_const))
                replica_ids.append(next_id)
                next_id += 1
            # the original slot becomes the wait-for-any consumer, so every
            # downstream reference to o.op_id keeps working; the anyof is a
            # trivial pass-through — always place it on cpu, never on the
            # scarce accelerator pool
            new_ops.append(PhysicalOp(
                op_id=o.op_id, op=ops.AnyOf(), inputs=tuple(replica_ids),
                placement="cpu", wait_any=True))
            expanded += 1
            ctx.note(f"%{o.op_id} ({o.op.name}) x{k}")
        if expanded:
            ctx.note(f"replicated {expanded} ops")
        return plan.with_ops(new_ops)


@dataclasses.dataclass
class FuseLookupsPass:
    """Data locality (paper §4): fuse each lookup into its single consumer
    so compute is colocated with the cached data, then annotate every op
    containing a lookup for resolved-ref dynamic dispatch."""
    name: str = dataclasses.field(default="fuse-lookups", init=False)

    def run(self, plan: PhysicalPlan, ctx: PassContext) -> PhysicalPlan:
        changed = True
        while changed:
            changed = False
            counts = plan.consumer_counts()
            for down in plan.ops:
                up = _fusible_edge(plan, down, counts)
                if up is None or not _ends_with_lookup(up.op):
                    continue
                plan = _merge(plan, up, down)
                changed = True
                break
        # annotate for dynamic dispatch: the scheduler defers placement
        # until the ref is resolved, then prefers an executor caching it
        new_ops = []
        annotated = 0
        for o in plan.ops:
            lk = next((s for s in _sub_ops(o.op)
                       if isinstance(s, ops.Lookup)), None)
            if lk is not None and o.locality_key is None:
                o = o.replace(
                    locality_ref_column=lk.key if lk.is_column else None,
                    locality_const=None if lk.is_column else lk.key)
                annotated += 1
            new_ops.append(o)
        if annotated:
            ctx.note(f"annotated {annotated} lookup ops for locality")
        return plan.with_ops(new_ops)


@dataclasses.dataclass
class LowerTorchChainsPass:
    """Lower fused GPU-placed tensor map/filter chains to one composed
    callable on ``device`` (the counterpart of the reference's
    ``LowerJaxChainsPass``).  ``Filter`` members lower as boolean masking
    inside the chain, so filter-containing chains fuse instead of
    breaking the chain.

    With ``batched=True`` (default) the chain is lowered to a
    ``BatchedJittedFuse``: whole row batches execute as ONE batched
    dispatch, with row counts padded to ``bucket_sizes``.  The op is
    annotated ``batchable`` + ``device_resident`` with the chosen buckets,
    so the runtime feeds merged request tables straight into the batched
    callable and keeps batches device-resident across adjacent lowered
    nodes.

    With ``min_ops <= 1`` bare (un-fused) GPU maps/filters lower too —
    that is what turns a multi-node accelerator chain the fusion pass left
    split into a device-resident pipeline."""
    min_ops: int = 2
    batched: bool = True
    bucket_sizes: tuple = DEFAULT_BUCKETS
    device: Any = None
    # per-op overrides (SLO optimizer's PlanConfig): op_id -> padding
    # buckets / batched-vs-per-row decision, so bucket sizes and lowering
    # mode stop being global constants
    bucket_overrides: Dict[int, Tuple[int, ...]] = \
        dataclasses.field(default_factory=dict)
    batched_overrides: Dict[int, bool] = \
        dataclasses.field(default_factory=dict)
    name: str = dataclasses.field(default="lower-torch-chains", init=False)

    def run(self, plan: PhysicalPlan, ctx: PassContext) -> PhysicalPlan:
        new_ops = []
        lowered = 0
        for o in plan.ops:
            target = None
            if fuse_is_torch_lowerable(o.op, o.placement, self.min_ops):
                target = o.op
            elif (self.min_ops <= 1 and o.placement == "gpu"
                    and not isinstance(o.op, ops.Fuse)
                    and op_is_torch_lowerable(o.op)):
                target = ops.Fuse([o.op])
                target.resource_class = o.placement
                target.batching = o.batching
                target.high_variance = o.high_variance
                target.competitive_replicas = o.replicas
            if target is not None:
                batched = self.batched_overrides.get(o.op_id, self.batched)
                buckets = tuple(self.bucket_overrides.get(
                    o.op_id, self.bucket_sizes))
                lo = lower_fuse(target, batched=batched,
                                bucket_sizes=buckets, device=self.device)
                o = o.replace(op=lo, batchable=batched,
                              batch_buckets=buckets if batched else (),
                              device_resident=batched)
                lowered += 1
                kind = "batched" if batched else "per-row"
                ctx.note(f"%{o.op_id}: {len(o.op.ops)} ops -> 1 composed "
                         f"fn ({kind})")
            new_ops.append(o)
        if lowered:
            ctx.note(f"lowered {lowered} chains")
        return plan.with_ops(new_ops)


@dataclasses.dataclass
class PlaceKernelsPass:
    """Kernel placement (PRETZEL-style white-box step): swap map steps that
    compute a registered attention kernel (tagged by
    ``kernels.ops.kernel_step`` or pattern-matched via
    ``kernels.ops.register_pattern``) for their CUDA kernel twins.

    The twin has the same ``torch.Tensor`` signature as the reference
    step, so the rewritten map stays lowerable and slots into the
    ``compose_steps`` body of ``JittedFuse``/``BatchedJittedFuse`` like any
    other step; a batched chain calls the twin's ``__batched__`` once on
    the stacked rows: ONE kernel launch per batch.

    Twins are memoized per ``(kernel, params)``, so ``chain_signature`` —
    and with it the ``ExecutableCache`` key and per-chain routing state —
    keys on kernel identity: recompiles of the same flow share
    executables and profiles.

    Runs BEFORE fusion/lowering so the placed steps flow through them the
    normal way.  Only ``gpu``-placed ops are rewritten."""
    name: str = dataclasses.field(default="place-kernels", init=False)

    def run(self, plan: PhysicalPlan, ctx: PassContext) -> PhysicalPlan:
        from repro_torch.kernels import ops as kops

        new_ops, placed_total = [], 0
        for o in plan.ops:
            if o.placement != "gpu":
                new_ops.append(o)
                continue
            subs = _sub_ops(o.op)
            placed_here: List[str] = []
            new_subs = []
            for s in subs:
                twin = None
                if isinstance(s, ops.Map) and not isinstance(s, ops.Filter):
                    twin = kops.placed_twin(s.fn)
                if twin is None:
                    new_subs.append(s)
                    continue
                rep = copy.copy(s)
                rep.fn = twin
                rep.__post_init__()     # re-derive _arg_types/_schema
                new_subs.append(rep)
                placed_here.append(repr(kops.match_kernel(s.fn)))
            if not placed_here:
                new_ops.append(o)
                continue
            if isinstance(o.op, ops.Fuse):
                new_op = ops.Fuse(new_subs)
                new_op.resource_class = o.op.resource_class
                new_op.batching = o.op.batching
                new_op.high_variance = o.op.high_variance
                new_op.competitive_replicas = o.op.competitive_replicas
            else:
                new_op = new_subs[0]
            new_ops.append(o.replace(op=new_op,
                                     kernels=tuple(placed_here)))
            placed_total += len(placed_here)
            ctx.note(f"%{o.op_id}: placed {', '.join(placed_here)}")
        if placed_total:
            ctx.note(f"placed {placed_total} CUDA kernels")
        return plan.with_ops(new_ops)


@dataclasses.dataclass
class ApplyPlanConfigPass:
    """Stamp an SLO optimizer ``PlanConfig``'s compile-time per-node
    choices onto the IR: placement overrides and competitive replication
    factors.  Runs early (before competitive/fusion), so the stamped
    annotations flow through the later passes the normal way; config keys
    are compiled-plan op ids, which are stable across recompiles of the
    same flow because fusion keeps the downstream op's id."""
    config: Any            # duck-typed: placement_overrides(), replica_overrides()
    name: str = dataclasses.field(default="apply-config", init=False)

    def run(self, plan: PhysicalPlan, ctx: PassContext) -> PhysicalPlan:
        placements = self.config.placement_overrides()
        replicas = self.config.replica_overrides()
        new_ops, stamped = [], 0
        for o in plan.ops:
            kw = {}
            pl = placements.get(o.op_id)
            if pl is not None and pl != o.placement:
                kw["placement"] = pl
            k = replicas.get(o.op_id)
            if k is not None and k != o.replicas:
                kw["replicas"] = k
                kw["high_variance"] = True
            if kw:
                o = o.replace(**kw)
                stamped += 1
            new_ops.append(o)
        if stamped:
            ctx.note(f"stamped config onto {stamped} ops")
        return plan.with_ops(new_ops)


def build_pipeline(*, fusion: bool = False, competitive_exec: bool = False,
                   locality: bool = False, jit_fusion: bool = True,
                   batched_lowering: bool = True,
                   default_replicas: int = 3,
                   plan_config=None,
                   place_kernels: bool = True,
                   validate: bool = True,
                   verify: bool = False,
                   device=None) -> PassPipeline:
    """Map optimization flags (a planner ``Plan`` or user choices) onto a
    pass configuration.  Order mirrors the paper's rewrite order: locality
    first (lookup fusion feeds dispatch), then replication, then fusion
    (boundary-aware when locality is on), then lowering of whatever
    fusion produced onto ``device`` (the CUDA device unless named; it is
    resolved when a chain first runs), batched unless
    ``batched_lowering=False``.

    ``plan_config`` (duck-typed on the SLO optimizer's ``PlanConfig``:
    ``placement_overrides()``, ``replica_overrides()``,
    ``bucket_overrides()``, ``batched_overrides()``) threads per-node
    choices in: compile-time stamps via ``ApplyPlanConfigPass`` and
    per-op bucket/lowering overrides on ``LowerTorchChainsPass``."""
    passes: List[Pass] = []
    if locality:
        passes.append(FuseLookupsPass())
    if plan_config is not None:
        passes.append(ApplyPlanConfigPass(plan_config))
    if place_kernels:
        # before replication/fusion: the placed (kernel-twin) steps flow
        # through those passes — and into the lowered chain bodies — the
        # normal way; after apply-config so placement overrides are seen
        passes.append(PlaceKernelsPass())
    if competitive_exec:
        passes.append(CompetitivePass(default_replicas=default_replicas))
    elif plan_config is not None and plan_config.replica_overrides():
        # the config names specific ops to replicate: default_replicas=0
        # keeps high_variance-hinted ops the optimizer did NOT propose
        # from being silently expanded too
        passes.append(CompetitivePass(default_replicas=0))
    if fusion:
        passes.append(FuseChainsPass(preserve_lookup_boundaries=locality))
    if jit_fusion and (fusion or plan_config is not None):
        # a config-driven compile must not silently drop the config's
        # lowering/bucket overrides just because fusion is off: without
        # fusion there are no Fuse nodes, so lower bare gpu maps too
        # (min_ops=1)
        lower = LowerTorchChainsPass(batched=batched_lowering,
                                     min_ops=2 if fusion else 1,
                                     device=device)
        if plan_config is not None:
            lower.bucket_overrides = plan_config.bucket_overrides()
            lower.batched_overrides = plan_config.batched_overrides()
        passes.append(lower)
    return PassPipeline(passes, validate=validate, verify=verify)
