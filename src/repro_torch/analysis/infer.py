"""Abstract interpretation over the ``PhysicalPlan`` IR (port of the
reference package's ``analysis/infer.py``).

Propagates per-edge specs through the topo-sorted plan, running
annotated map/filter/kernel/ModelOp steps abstractly, so shape/dtype
mismatches (CF101) and steps that cannot run on the lowered batched path
(CF102) surface before the first call.  A spec is a meta tensor: shape
and dtype, no storage.  Fused chains are walked step by step (the live
router would too), and batch-lowered chains are walked again at every
padding bucket in their batched form, the shapes the serving path runs.

Where the reference traces a step with ``jax.eval_shape`` and
``jax.vmap``, the port runs it under ``FakeTensorMode(allow_non_fake_
inputs=True)`` on fake inputs made on the device the step's data lies on
(``device=``, the runtime's).  The tensors a step closes over (model
weights, on the card at full width) enter the mode as fake tensors on
their own device, so nothing is allocated on the card and nothing is
launched.  Meta inputs would not do: a meta tensor times a CUDA weight is
a device mismatch.  Two kinds of kernel call meet this walk:

* a placed kernel step (its ``__kernel_placed__`` twin) would reach a
  CUDA launch, so it is evaluated through :func:`~repro_torch.kernels.ops.
  kernel_call_of`: the registry spec's plain version with the call's
  params, for shapes only;
* a kernel wrapper called inside a step (a model stage's attention) sees
  fake operands, runs its plain version for shapes only, and the call is
  recorded (``kernels.build.abstract_calls``) for the launch-rule check
  (CF103).

Shape inference needs concrete input shapes: pass ``input_specs`` (a
``{column: tensor}`` dict of meta or other tensors, or derive one from a
sample request with :func:`specs_from_table`).  Without specs the
shape-dependent diagnostics skip; schema/placement/residency inference
still runs off the IR's type annotations alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException,
                                           FakeTensorMode,
                                           UnsupportedOperatorException)

from repro_torch.analysis.diagnostics import Diagnostic, Report
from repro_torch.core import operators as ops
from repro_torch.core.ir import SOURCE_ID, PhysicalPlan
from repro_torch.core.lowering import (BatchedJittedFuse, JittedFuse,
                                       _batched_step, _is_kernel_twin,
                                       array_annotation, untraceable)
from repro_torch.kernels import build as kbuild

#: kernel calls recorded during one step: (kernel name, operand shapes)
KernelCalls = Tuple[Tuple[str, Tuple[Tuple[int, ...], ...]], ...]


def _untraceable(err: BaseException) -> bool:
    """The torch counterparts of JAX's concretization errors: a value read
    back from a tensor (``.item()``, ``.tolist()``, a branch on a tensor),
    a data-dependent shape, or a refusal of ``torch.func.vmap`` — plus
    whatever :func:`~repro_torch.core.lowering.untraceable` says makes the
    lowered path fall back.  A KernelError is never one."""
    if isinstance(err, (DataDependentOutputException,
                        DynamicOutputShapeException)):
        return True
    return untraceable(err)


@dataclasses.dataclass
class EdgeType:
    """What the verifier knows about one plan edge (an op's output), plus
    what the walk of the op saw on the way."""
    schema: Tuple[Tuple[str, type], ...]
    grouping: Optional[str] = None
    #: per-column specs (meta tensors) at ROW level (no batch dim); None
    #: entries are columns whose shape is unknown (non-tensor types,
    #: un-analyzable producers)
    specs: Optional[Tuple[object, ...]] = None
    placement: str = "cpu"
    device_resident: bool = False
    #: the row-level specs before the op's first step and after each
    #: step (None when the op was not walked)
    steps: Optional[Tuple[Tuple[object, ...], ...]] = None
    #: kernel wrapper calls the row-level walk of the op made
    kernels: KernelCalls = ()


def spec(shape, dtype) -> torch.Tensor:
    """A spec: a meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _as_spec(v) -> Optional[torch.Tensor]:
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return spec(v.shape, v.dtype)
    a = np.asarray(v)
    if a.dtype.kind in "OUS":           # strings/objects: no shape
        return None
    return spec(a.shape, torch.from_numpy(np.zeros((), a.dtype)).dtype)


def specs_from_table(table) -> Optional[Dict[str, object]]:
    """Derive row-level input specs from a sample request table (row 0's
    values).  Non-numeric columns map to None (shape unknown)."""
    if not getattr(table, "rows", None):
        return None
    out: Dict[str, object] = {}
    row = table.rows[0]
    for (name, _t), v in zip(table.schema, row.values):
        try:
            out[name] = _as_spec(v)
        except (TypeError, ValueError):
            out[name] = None
    return out


def _chain_of(op) -> Optional[List[object]]:
    """The map/filter step list of a fusable op (Fuse and its lowered
    subclasses), a single-element list for a bare Map/Filter, or None
    for ops abstract interpretation cannot step through."""
    if isinstance(op, ops.Fuse):
        return list(op.ops)
    if isinstance(op, (ops.Map, ops.Filter)):
        return [op]
    return None


def _jit_destined(phys_op) -> bool:
    """Will this op's steps run on the lowered path?  Already-lowered
    chains do; gpu-placed fusable chains will when lowering is on."""
    if isinstance(phys_op.op, JittedFuse):
        return True
    return phys_op.placement == "gpu" and _chain_of(phys_op.op) is not None


class Abstract:
    """The state of one abstract interpretation: the fake-tensor mode (it
    memoizes the fakes of captured weights across steps), the device
    fake inputs are made on, and the results of the steps run so far.
    A step's output specs depend only on its function and its input
    specs, so a cascade that repeats one decode step at every position
    runs it once per input shape, not once per position."""

    def __init__(self, device=None):
        self.device = torch.device(device if device is not None else "cpu")
        self.mode = FakeTensorMode(allow_non_fake_inputs=True)
        self._memo: Dict[Tuple, Tuple[List[torch.Tensor], KernelCalls]] = {}

    def step_fn(self, fn, *, batched: bool):
        """The callable to run abstractly for a step function: a placed
        kernel twin goes through its registry spec's plain version (its
        kernel cannot take fake tensors); any other step runs as is, or
        in its batch form (``__batched__``, else ``torch.func.vmap``)."""
        if _is_kernel_twin(fn):
            from repro_torch.kernels.ops import (KERNEL_REGISTRY,
                                                 kernel_call_of)
            kc = kernel_call_of(fn)
            ref = KERNEL_REGISTRY[kc.kernel].ref
            bound = getattr(fn, "__kernel_bound__", ())
            kw = kc.kwargs()

            def batched_ref(*cols):
                return ref(*cols, *bound, **kw)
            if batched:
                return batched_ref
            return lambda *cols: batched_ref(*[c[None] for c in cols])[0]
        return _batched_step(fn) if batched else fn

    def eval_step(self, step, in_specs, *, batched: bool = False):
        """Run one map/filter step abstractly on positional column specs;
        returns (output spec list, kernel calls made).  Filters pass their
        input through.  ``batched`` means the specs already carry a
        leading batch dim and the step runs in its batch form.  Errors
        propagate (and are not memoized)."""
        key = (step.fn, isinstance(step, ops.Filter), batched,
               tuple((tuple(s.shape), s.dtype) for s in in_specs))
        hit = self._memo.get(key)
        if hit is None:
            hit = self._memo[key] = self._run(step, in_specs, batched)
        return list(hit[0]), hit[1]

    def _run(self, step, in_specs, batched):
        fn = self.step_fn(step.fn, batched=batched)
        with _quiet(), self.mode, kbuild.abstract_calls() as calls:
            args = [torch.empty(tuple(s.shape), dtype=s.dtype,
                                device=self.device) for s in in_specs]
            with torch.no_grad():
                out = fn(*args)
            if isinstance(step, ops.Filter):
                outs = list(in_specs)
            else:
                outs = [_meta(o) for o in
                        (out if isinstance(out, (tuple, list)) else [out])]
        return outs, tuple(calls)


def _meta(v) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return spec(t.shape, t.dtype)


@contextlib.contextmanager
def _quiet():
    """The fake-tensor module logs every failed shape rule at ERROR
    before raising it; a rejected step is a diagnostic here, not a log."""
    log = logging.getLogger("torch._subclasses.fake_tensor")
    old = log.level
    log.setLevel(logging.CRITICAL)
    try:
        yield
    finally:
        log.setLevel(old)


def _steps_analyzable(steps, in_specs) -> bool:
    """All step annotations are tensors and every input column has a
    known spec — the precondition for abstract interpretation."""
    if in_specs is None or any(s is None for s in in_specs):
        return False
    for s in steps:
        # a fused chain can carry non-Map/Filter sub-ops (e.g. a Lookup
        # merged in by the locality pass) — those have no annotations and
        # no pure step function, so the chain is not abstractly steppable
        arg_types = getattr(s, "_arg_types", None)
        if arg_types is None:
            return False
        if any(not array_annotation(t) for t in arg_types):
            return False
        if isinstance(s, ops.Map) and \
                any(not array_annotation(t) for _n, t in s._schema):
            return False
    return True


def _walk_chain(ab: Abstract, phys_op, steps, in_specs, report: Report,
                *, bucket: int = 0):
    """Step through a (possibly fused) chain abstractly, emitting
    CF101/CF102 on failure.  Returns (the row-level specs before the
    first step and after each, the kernel calls made), or None."""
    destined = _jit_destined(phys_op)
    cur = list(in_specs)
    if bucket:      # the padded dispatch shape: batch dim added ONCE
        cur = [spec((bucket,) + tuple(s.shape), s.dtype) for s in cur]
    seen = [tuple(in_specs)]
    calls: List = []
    for step in steps:
        at = f" at bucket {bucket}" if bucket else ""
        try:
            cur, made = ab.eval_step(step, cur, batched=bool(bucket))
        except UnsupportedOperatorException:
            return None     # no shape rule for an op: shapes unknown
        except Exception as e:
            if _untraceable(e):
                if destined:
                    report.add(Diagnostic(
                        "CF102", f"step {step.name!r} is not traceable for "
                        f"the lowered batched path{at}: {_first_line(e)}",
                        op_id=phys_op.op_id,
                        hint="remove data-dependent python control flow "
                             "(.item(), .tolist(), branches on tensors) or "
                             "drop the torch.Tensor annotations so the "
                             "step stays eager"))
                return None
            report.add(Diagnostic(
                "CF101", f"step {step.name!r} rejects the inferred input "
                f"shapes{at} "
                f"({', '.join(_fmt_spec(s) for s in cur)}): "
                f"{_first_line(e)}",
                op_id=phys_op.op_id,
                hint="fix the producing op's output shape or this step's "
                     "expected operand shapes"))
            return None
        calls.extend(made)
        row = [spec(tuple(s.shape[1:]), s.dtype) for s in cur] if bucket \
            else cur
        seen.append(tuple(row))
    return tuple(seen), tuple(calls)


def _fmt_spec(s) -> str:
    return f"{str(s.dtype).replace('torch.', '')}{list(s.shape)}"


def _first_line(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"


def infer(plan: PhysicalPlan,
          input_specs: Optional[Dict[str, object]] = None,
          report: Optional[Report] = None,
          *, check_buckets: bool = True, device=None
          ) -> Tuple[Dict[int, EdgeType], Report]:
    """Propagate schemas + shape specs through the plan, with fake inputs
    on ``device`` (the CPU unless named).  Returns the per-op-id edge
    types and the report the walk appended to."""
    report = report if report is not None else Report()
    types: Dict[int, EdgeType] = {}

    # schemas/groupings come from the IR typechecker; a failure there IS
    # the shape/dtype-mismatch diagnostic, at schema granularity
    try:
        schemas = plan.typecheck()
    except Exception as e:
        report.add(Diagnostic(
            "CF101", f"plan typecheck failed: {_first_line(e)}",
            hint="fix the op annotations so consecutive schemas agree"))
        return types, report

    src_specs = None
    if input_specs is not None:
        src_specs = tuple(_as_spec(input_specs.get(name))
                          for name, _t in plan.input_schema)
    types[SOURCE_ID] = EdgeType(schema=tuple(plan.input_schema),
                                specs=src_specs)
    ab = Abstract(device) if src_specs is not None else None

    for o in plan.ops:
        schema, grouping = schemas[o.op_id]
        et = EdgeType(schema=tuple(schema), grouping=grouping,
                      placement=o.placement,
                      device_resident=o.device_resident)
        ins = [types.get(i) for i in o.inputs]
        steps = _chain_of(o.op)
        if steps is not None and len(ins) == 1 and ins[0] is not None:
            in_specs = ins[0].specs
            if _steps_analyzable(steps, in_specs):
                walked = _walk_chain(ab, o, steps, list(in_specs), report)
                if walked is not None and \
                        isinstance(o.op, BatchedJittedFuse) and check_buckets:
                    for b in o.op.bucket_sizes:
                        if _walk_chain(ab, o, steps, list(in_specs), report,
                                       bucket=b) is None:
                            break       # one bucket failure explains all
                if walked is not None:
                    et.steps, et.kernels = walked
                    if len(walked[0][-1]) == len(schema):
                        et.specs = walked[0][-1]
        elif isinstance(o.op, (ops.AnyOf, ops.Union)) and ins and \
                all(i is not None and i.specs is not None for i in ins):
            # pass-through ops: every input must agree; AnyOf/Union
            # schemas were already checked compatible by the typechecker
            first = ins[0].specs
            if all(_specs_eq(i.specs, first) for i in ins):
                et.specs = first
        types[o.op_id] = et
    return types, report


def _specs_eq(a, b) -> bool:
    if a is None or b is None or len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x is None or y is None:
            if x is not y:
                return False
            continue
        if tuple(x.shape) != tuple(y.shape) or x.dtype != y.dtype:
            return False
    return True


def edge_signature(types: Dict[int, EdgeType]) -> Dict[int, Tuple]:
    """A comparable per-op-id summary of inferred edge types — what the
    differential pass verifier (CF502) asserts every pass preserves."""
    out: Dict[int, Tuple] = {}
    for op_id, et in types.items():
        cols = tuple((name, getattr(t, "__name__", str(t)))
                     for name, t in et.schema)
        out[op_id] = (cols, et.grouping)
    return out
