"""Runtime DAG: what the compilation pipeline emits (Cloudburst-DAG
analogue).  Port of the reference package's ``runtime/dag.py``.

Each node is a named function over Tables with scheduling annotations:
``resource_class`` (cpu/gpu executor pools), ``batching`` (batch-aware fn),
``wait_any`` (wait-for-any semantics for anyof), ``jitted`` (the node's fn
is a single composed callable), the device-residency flags, and the
locality refs — the *to-be-continued* annotation for dynamic dispatch: the
node's result carries a resolved KVS ref and the scheduler places the
continuation DAG on a machine likely caching that ref (paper §4).

``RuntimeDag.from_plan`` is the lowering from the physical-plan IR: one
``RuntimeNode`` per ``PhysicalOp``, annotations copied verbatim — plus the
device-edge analysis: a device-resident op whose consumers are ALL
device-resident (single-input, not wait-any, not request-batching) *emits*
a ``DeviceTable`` instead of gathering back to the host, so a chain of
adjacent accelerator nodes pays one host->device stack at entry and one
gather at the demux boundary.  When such an op has exactly one consumer its
output buffers are marked donatable (exclusively owned by the consumer).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.table import Table


@dataclasses.dataclass
class RuntimeNode:
    name: str
    fn: Callable[[List[Table], Any], Table]     # (tables, ctx) -> Table
    deps: List[str]
    resource_class: str = "cpu"
    batching: bool = False
    wait_any: bool = False
    jitted: bool = False
    # batched execution: (merged_table_list, ctx) -> Table, ONE batched
    # dispatch per batch (set when the op lowered to a BatchedJittedFuse)
    batched_fn: Optional[Callable[[List[Table], Any], Table]] = None
    batch_buckets: tuple = ()
    # device residency: the op consumes/produces DeviceTables; emits_device
    # means its output actually stays on the device (every consumer is a
    # device-resident op), skipping the host gather at this edge
    device_resident: bool = False
    emits_device: bool = False
    # dynamic dispatch: column holding the resolved KVS ref (or a constant)
    locality_ref_column: Optional[str] = None
    locality_const: Optional[str] = None
    plan_op_id: Optional[int] = None            # provenance into the IR
    # competitive replication: nodes feeding the same wait-any consumer
    # share a group id — under degraded serving only ONE member of each
    # group is dispatched (no tail-suppression racing for best-effort
    # traffic during overload)
    competitive_group: Optional[str] = None


@dataclasses.dataclass
class RuntimeDag:
    name: str
    nodes: Dict[str, RuntimeNode]
    output: str
    #: deployment generation, assigned by ``Runtime.prepare_dag``: two
    #: generations of the same logical DAG (blue/green replanning) must
    #: never share mutable runtime state — batchers capture node closures,
    #: so a generation owns its batchers exclusively.  0 = unregistered.
    generation: int = 0

    @classmethod
    def from_plan(cls, plan, dag_name: str, *,
                  device_resident: bool = True) -> "RuntimeDag":
        """Lower a ``repro_torch.core.ir.PhysicalPlan`` to a runtime DAG.
        ``device_resident=False`` disables the device-edge analysis (every
        node gathers back to the host — the pre-device-pipeline behavior,
        kept for benchmarking the difference)."""
        from repro_torch.core.lowering import BatchedJittedFuse, JittedFuse

        consumers: Dict[int, List] = {}
        for o in plan.ops:
            for i in o.inputs:
                consumers.setdefault(i, []).append(o)

        def wrap(op):
            def fn(tables, ctx):
                return op.apply(tables, ctx)
            return fn

        def wrap_device(op, emits, donate):
            def fn(tables, ctx):
                return op.apply_batched(tables, ctx, emit_device=emits,
                                        donate_out=donate)
            return fn

        nodes: Dict[str, RuntimeNode] = {}
        names: Dict[int, str] = {}
        out_name = None
        for o in plan.ops:
            nm = f"{dag_name}/{o.op_id}:{o.op.name}"[:120]
            names[o.op_id] = nm
            batched = isinstance(o.op, BatchedJittedFuse)
            dev = batched and bool(getattr(o, "device_resident", False))
            cons = consumers.get(o.op_id, [])
            # emit a DeviceTable only when every consumer can take it
            # straight off the device: a device-resident single-input op
            # that neither races (wait-any) nor merges requests on the
            # host (batching); the plan output always gathers
            emits = (device_resident and dev and bool(cons)
                     and o.op_id != plan.output_id
                     and all(getattr(c, "device_resident", False)
                             and not c.wait_any and not c.batching
                             and len(c.inputs) == 1 for c in cons))
            # sole consumer -> nobody else holds the buffers: donatable.
            # An explicit IR annotation overrides the derived default
            # (donate=False pins buffers; donate=True forces donation,
            # which is wrong on a fan-out edge).  Donation is only
            # meaningful on an emitting device edge either way.
            explicit = getattr(o, "donate", None)
            donate = (emits and bool(explicit)) if explicit is not None \
                else (emits and len(cons) == 1)
            fn = wrap_device(o.op, emits, donate) if batched else wrap(o.op)
            nodes[nm] = RuntimeNode(
                name=nm, fn=fn,
                deps=[names[i] for i in o.inputs if i in names],
                resource_class=o.placement,
                batching=o.batching,
                wait_any=o.wait_any,
                jitted=isinstance(o.op, JittedFuse),
                batched_fn=fn if batched else None,
                batch_buckets=tuple(o.batch_buckets),
                device_resident=dev,
                emits_device=emits,
                locality_ref_column=o.locality_ref_column,
                locality_const=o.locality_const,
                plan_op_id=o.op_id,
            )
            out_name = nm
        # annotate competitive groups: the inputs of a wait-any consumer
        # with >=2 deps are racing replicas of the same computation
        for nm, node in nodes.items():
            if node.wait_any and len(node.deps) >= 2:
                for d in node.deps:
                    nodes[d].competitive_group = nm
        dag = cls(dag_name, nodes, names.get(plan.output_id, out_name))
        dag.validate()
        return dag

    def topo(self) -> List[RuntimeNode]:
        order, seen = [], set()

        def visit(n: str):
            if n in seen:
                return
            seen.add(n)
            for d in self.nodes[n].deps:
                visit(d)
            order.append(self.nodes[n])

        visit(self.output)
        return order

    def validate(self):
        for n in self.nodes.values():
            for d in n.deps:
                if d not in self.nodes:
                    raise ValueError(f"{n.name} depends on unknown {d}")
        self.topo()
