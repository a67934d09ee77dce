"""Physical-plan IR: the layer between logical ``Dataflow`` graphs and the
runtime (PRETZEL-style white-box plan compilation).

A ``PhysicalPlan`` is an immutable, topologically ordered sequence of
``PhysicalOp`` records.  Each record carries a logical operator payload plus
the *scheduling annotations* the paper's optimizations (§4) need — placement
(resource class), batching, wait-for-any, competitive-replication, and
locality (resolved-ref dynamic dispatch).  Optimizations are expressed as
passes over this IR (``repro_torch.core.passes``); the runtime lowering
(``RuntimeDag.from_plan``) consumes the annotated plan verbatim.

Conventions:

* op ids are positive ints; ``SOURCE_ID`` (0) denotes the plan input and has
  no ``PhysicalOp`` record;
* ``plan.ops`` is topologically sorted — every op's inputs appear earlier
  (or are the source);
* passes never mutate: they build a new ``PhysicalPlan`` via ``with_ops``,
  which re-validates the invariants above.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import operators as ops
from repro_torch.core.table import Schema, Table

SOURCE_ID = 0


class PlanError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class PhysicalOp:
    """One physical operator: logical payload + scheduling annotations."""
    op_id: int
    op: ops.Operator
    inputs: Tuple[int, ...]
    # -- scheduling annotations (paper §4) ---------------------------------
    placement: str = "cpu"              # executor resource class
    batching: bool = False
    wait_any: bool = False              # wait-for-any (anyof) semantics
    high_variance: bool = False
    replicas: int = 0                   # competitive replication factor
    # locality / dynamic dispatch: resolved-ref column or constant key
    locality_ref_column: Optional[str] = None
    locality_const: Optional[str] = None
    # batched execution (set by LowerTorchChainsPass): the op executes
    # whole row batches in one batched dispatch, padded to these row-count
    # buckets (the runtime feeds merged request tables straight in)
    batchable: bool = False
    batch_buckets: Tuple[int, ...] = ()
    # device residency (set by LowerTorchChainsPass): the op can consume and
    # produce device-resident columnar batches (DeviceTable) — the runtime
    # lowering wires adjacent device-resident ops so batches skip the host
    # round-trip between them
    device_resident: bool = False
    # CUDA kernels placed into this op's map steps (set by
    # PlaceKernelsPass): repr strings of the KernelCalls, for explain
    # output and tests — the executable identity lives in the step fns
    kernels: Tuple[str, ...] = ()
    # buffer-donation intent for this op's device-resident output edge:
    # None derives the runtime's safe default (donate only single-
    # consumer device edges); True forces donation (donating a fan-out
    # edge would hand a sibling consumer's buffers away); False forbids
    # it.  In this port donation only marks ownership: no step reuses a
    # donated buffer in place yet
    donate: Optional[bool] = None

    def replace(self, **kw) -> "PhysicalOp":
        return dataclasses.replace(self, **kw)

    @property
    def locality_key(self) -> Optional[str]:
        return self.locality_ref_column or self.locality_const

    def __repr__(self):
        flags = []
        if self.placement != "cpu":
            flags.append(self.placement)
        if self.batching:
            flags.append("batch")
        if self.batchable:
            flags.append("vmap")
        if self.device_resident:
            flags.append("dev")
        if self.kernels:
            names = ",".join(k.split("(")[0] for k in self.kernels)
            flags.append(f"kernels:{names}")
        if self.donate is not None:
            flags.append("donate" if self.donate else "nodonate")
        if self.wait_any:
            flags.append("any")
        if self.replicas:
            flags.append(f"x{self.replicas}")
        if self.locality_key:
            flags.append(f"near:{self.locality_key}")
        tag = f" [{','.join(flags)}]" if flags else ""
        return (f"%{self.op_id} = {self.op.name}"
                f"({', '.join(f'%{i}' for i in self.inputs)}){tag}")


def annotations_from_op(op: ops.Operator) -> Dict[str, Any]:
    """Lift a logical operator's hint fields into IR annotations."""
    return dict(placement=op.resource_class, batching=op.batching,
                wait_any=isinstance(op, ops.AnyOf),
                high_variance=op.high_variance,
                replicas=op.competitive_replicas)


@dataclasses.dataclass(frozen=True)
class PhysicalPlan:
    """Immutable physical plan: topo-sorted ops + the output op id."""
    input_schema: Tuple[Tuple[str, type], ...]
    ops: Tuple[PhysicalOp, ...]
    output_id: int

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_dataflow(flow) -> "PhysicalPlan":
        """Lower a logical ``Dataflow`` into the physical IR.  Annotations
        are seeded from the operators' optimization hints."""
        mapping: Dict[int, int] = {}
        records: List[PhysicalOp] = []
        next_id = SOURCE_ID + 1
        for n in flow.sorted_nodes():
            if n.op is None:
                mapping[n.id] = SOURCE_ID
                continue
            inputs = tuple(mapping[u.id] for u in n.upstreams)
            records.append(PhysicalOp(op_id=next_id, op=n.op, inputs=inputs,
                                      **annotations_from_op(n.op)))
            mapping[n.id] = next_id
            next_id += 1
        if flow.output is None or flow.output.id not in mapping:
            raise PlanError("flow has no output")
        out = mapping[flow.output.id]
        if out == SOURCE_ID:
            raise PlanError("plan output cannot be the source")
        schema = tuple((n, t) for n, t in flow.input_schema)
        plan = PhysicalPlan(schema, tuple(records), out)
        plan.validate()
        return plan

    def with_ops(self, new_ops: List[PhysicalOp],
                 output_id: Optional[int] = None) -> "PhysicalPlan":
        plan = PhysicalPlan(self.input_schema, tuple(new_ops),
                            self.output_id if output_id is None else output_id)
        plan.validate()
        return plan

    def __post_init__(self):
        object.__setattr__(self, "_by_id", {o.op_id: o for o in self.ops})

    # -- accessors ----------------------------------------------------------
    def op(self, op_id: int) -> PhysicalOp:
        try:
            return self._by_id[op_id]
        except KeyError:
            raise PlanError(f"no op %{op_id} in plan") from None

    @property
    def output(self) -> PhysicalOp:
        return self.op(self.output_id)

    def consumer_counts(self) -> Dict[int, int]:
        counts: Dict[int, int] = {}
        for o in self.ops:
            for i in o.inputs:
                counts[i] = counts.get(i, 0) + 1
        return counts

    def next_id(self) -> int:
        return max((o.op_id for o in self.ops), default=SOURCE_ID) + 1

    # -- invariants ---------------------------------------------------------
    def validate(self):
        seen = {SOURCE_ID}
        for o in self.ops:
            if o.op_id in seen:
                raise PlanError(f"duplicate op id %{o.op_id}")
            if o.op is None:
                raise PlanError(f"%{o.op_id} has no operator payload")
            for i in o.inputs:
                if i not in seen:
                    raise PlanError(
                        f"%{o.op_id} consumes %{i} which is not defined "
                        "earlier (plan must be topologically sorted)")
            seen.add(o.op_id)
        if self.output_id not in seen or self.output_id == SOURCE_ID:
            raise PlanError(f"output %{self.output_id} not in plan")

    def typecheck(self) -> Dict[int, Tuple[Schema, Optional[str]]]:
        """Propagate (schema, grouping) through the plan; raises on
        mismatch.  The IR analogue of ``Dataflow.typecheck``."""
        info: Dict[int, Tuple[Schema, Optional[str]]] = {
            SOURCE_ID: (list(self.input_schema), None)}
        for o in self.ops:
            schemas = [info[i][0] for i in o.inputs]
            groupings = [info[i][1] for i in o.inputs]
            info[o.op_id] = (o.op.typecheck(schemas),
                             o.op.out_grouping(groupings))
        return info

    # -- reference semantics ------------------------------------------------
    def execute_local(self, table: Table, ctx=None) -> Table:
        """Single-process interpreter over the plan (oracle for pass
        equivalence tests)."""
        results: Dict[int, Table] = {SOURCE_ID: table}
        for o in self.ops:
            ins = [results[i] for i in o.inputs]
            results[o.op_id] = o.op.apply(ins, ctx)
        return results[self.output_id]

    # -- logical round-trip (compatibility shim support) ---------------------
    def to_dataflow(self):
        """Reconstruct a logical ``Dataflow`` carrying this plan's operators
        and annotations (used by the ``apply_rewrites`` compatibility shim).
        Operator hint fields are re-synced from the IR annotations."""
        import copy

        from repro_torch.core.dataflow import Dataflow, Node

        flow = Dataflow(list(self.input_schema))
        nodes: Dict[int, Node] = {SOURCE_ID: flow.source}
        for o in self.ops:
            op = copy.copy(o.op)
            op.resource_class = o.placement
            op.batching = o.batching
            op.high_variance = o.high_variance
            op.competitive_replicas = o.replicas
            nodes[o.op_id] = Node(flow, op, [nodes[i] for i in o.inputs])
        flow.output = nodes[self.output_id]
        return flow

    def __repr__(self):
        lines = [f"plan(input={list(self.input_schema)})"]
        lines += [f"  {o!r}" for o in self.ops]
        lines.append(f"  return %{self.output_id}")
        return "\n".join(lines)
