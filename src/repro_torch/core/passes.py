"""Pass manager over the physical-plan IR (port of the reference
package's ``core/passes.py``).

Each optimization is a ``Pass``: a pure ``PhysicalPlan -> PhysicalPlan``
transform.  ``PassPipeline`` runs a configured sequence, re-validating and
re-typechecking the plan after every pass (so a broken transform fails at
compile time, not in an executor thread) and recording a per-pass trace
(op counts, wall time, notes).

Passes:

* ``FuseChainsPass``       — operator fusion: collapse single-consumer
  linear chains into one ``Fuse`` op, keeping the constituents' hints.
* ``PlaceKernelsPass``     — kernel placement: swap map steps tagged (or
  pattern-matched) as registered attention computations for their CUDA
  kernel twins, so lowered chains launch the kernels natively.
* ``LowerTorchChainsPass`` — lower eligible fused tensor chains into one
  composed callable (``JittedFuse``/``BatchedJittedFuse``).

``build_pipeline`` maps optimization flags onto a pass configuration.
Competitive replication, lookup fusion, SLO plan configs and the static
verifier (``verify=``) are not ported yet.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict, List, Optional, Protocol, runtime_checkable

from repro_torch.core import operators as ops
from repro_torch.core.ir import SOURCE_ID, PhysicalOp, PhysicalPlan
from repro_torch.core.lowering import (DEFAULT_BUCKETS,
                                       fuse_is_torch_lowerable, lower_fuse)


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
    """Runs passes in order with post-pass validation + typechecking."""

    def __init__(self, passes: List[Pass], *, validate: bool = True):
        self.passes = list(passes)
        self.validate = validate

    def run(self, plan: PhysicalPlan,
            ctx: Optional[PassContext] = None) -> PhysicalPlan:
        ctx = ctx or PassContext()
        if self.validate:
            plan.validate()
            plan.typecheck()
        for p in self.passes:
            before = len(plan.ops)
            notes_start = len(ctx.notes)
            t0 = time.perf_counter()
            plan = p.run(plan, ctx)
            dt = time.perf_counter() - t0
            if self.validate:
                plan.validate()
                plan.typecheck()   # every pass must preserve well-typedness
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
    """The structural preconditions of fusion: ``down`` has one input, which is a non-source op with exactly one
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
    nodes."""
    min_ops: int = 2
    batched: bool = True
    bucket_sizes: tuple = DEFAULT_BUCKETS
    device: Any = None
    name: str = dataclasses.field(default="lower-torch-chains", init=False)

    def run(self, plan: PhysicalPlan, ctx: PassContext) -> PhysicalPlan:
        new_ops = []
        lowered = 0
        for o in plan.ops:
            if fuse_is_torch_lowerable(o.op, o.placement, self.min_ops):
                buckets = tuple(self.bucket_sizes)
                lo = lower_fuse(o.op, batched=self.batched,
                                bucket_sizes=buckets, device=self.device)
                o = o.replace(op=lo, batchable=self.batched,
                              batch_buckets=buckets if self.batched else (),
                              device_resident=self.batched)
                lowered += 1
                kind = "batched" if self.batched else "per-row"
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


def build_pipeline(*, fusion: bool = False, jit_fusion: bool = True,
                   batched_lowering: bool = True,
                   place_kernels: bool = True,
                   validate: bool = True,
                   device=None) -> PassPipeline:
    """Map optimization flags onto a pass configuration: kernel placement
    first (the placed twins flow through fusion and into the lowered
    chain bodies the normal way), then fusion, then lowering of whatever
    fusion produced onto ``device`` (the CUDA device unless named; it is
    resolved when a chain first runs)."""
    passes: List[Pass] = []
    if place_kernels:
        passes.append(PlaceKernelsPass())
    if fusion:
        passes.append(FuseChainsPass())
    if jit_fusion and fusion:
        passes.append(LowerTorchChainsPass(batched=batched_lowering,
                                           device=device))
    return PassPipeline(passes, validate=validate)
