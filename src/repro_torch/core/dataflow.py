"""Lazy Dataflow DAG builder (paper §3.1, Fig 2).

    flow = Dataflow([("url", str)])
    img = flow.map(preproc)
    p1, p2 = img.map(model_a), img.map(model_b)
    flow.output = p1.union(p2).groupby("label").agg("max", "conf")
    flow.deploy(runtime)          # compiles + registers with the runtime
    fut = flow.execute(table)     # returns a future
    result = fut.result()
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import operators as ops
from repro_torch.core.table import Table, Schema

_node_ids = itertools.count()


class Node:
    def __init__(self, flow: "Dataflow", op: Optional[ops.Operator],
                 upstreams: List["Node"]):
        self.flow = flow
        self.op = op
        self.upstreams = upstreams
        self.id = next(_node_ids)
        flow._nodes.append(self)

    # -- fluent operator API -------------------------------------------------
    def _hints(self, op: ops.Operator, *, gpu=False, batching=False,
               high_variance=False, competitive_replicas=0):
        op.resource_class = "gpu" if gpu else "cpu"
        op.batching = batching
        op.high_variance = high_variance
        op.competitive_replicas = competitive_replicas
        return op

    def map(self, fn: Callable, names: Optional[Sequence[str]] = None,
            **hints) -> "Node":
        return Node(self.flow, self._hints(ops.Map(fn, names), **hints),
                    [self])

    def filter(self, fn: Callable, **hints) -> "Node":
        return Node(self.flow, self._hints(ops.Filter(fn), **hints), [self])

    def apply_op(self, op: ops.Operator, **hints) -> "Node":
        """Attach a prebuilt single-input operator (e.g. a ``ModelOp`` from
        ``repro_torch.models.registry.model_stage_op``) as the next node."""
        return Node(self.flow, self._hints(op, **hints), [self])

    def groupby(self, column: str) -> "Node":
        return Node(self.flow, ops.GroupBy(column), [self])

    def agg(self, agg_fn: str, column: str) -> "Node":
        return Node(self.flow, ops.Agg(agg_fn, column), [self])

    def lookup(self, key: str, *, column: bool = False,
               out_name: str = "lookup") -> "Node":
        return Node(self.flow, ops.Lookup(key, is_column=column,
                                          out_name=out_name), [self])

    def join(self, other: "Node", key: Optional[str] = None,
             how: str = "inner") -> "Node":
        return Node(self.flow, ops.Join(key, how), [self, other])

    def union(self, *others: "Node") -> "Node":
        return Node(self.flow, ops.Union(), [self, *others])

    def anyof(self, *others: "Node") -> "Node":
        return Node(self.flow, ops.AnyOf(), [self, *others])

    def __repr__(self):
        return f"Node#{self.id}({self.op.name if self.op else 'input'})"


class Dataflow:
    def __init__(self, input_schema: Schema):
        self.input_schema = [(str(n), t) for n, t in input_schema]
        self._nodes: List[Node] = []
        self.source = Node(self, None, [])
        self._output: Optional[Node] = None
        self._deployed = None

    # -- sugar: source-level ops ----------------------------------------------
    def map(self, fn, names=None, **hints):
        return self.source.map(fn, names, **hints)

    def filter(self, fn, **hints):
        return self.source.filter(fn, **hints)

    def lookup(self, key, **kw):
        return self.source.lookup(key, **kw)

    def apply_op(self, op, **hints):
        return self.source.apply_op(op, **hints)

    @property
    def output(self) -> Optional[Node]:
        return self._output

    @output.setter
    def output(self, node: Node):
        if node.flow is not self:
            raise ValueError("output must derive from this Dataflow")
        self._output = node

    # -- composition (paper §3.3) ----------------------------------------------
    def extend(self, other: "Dataflow") -> "Dataflow":
        """Append ``other``'s DAG after this flow's output."""
        if self._output is None or other._output is None:
            raise ValueError("both flows need outputs to extend")
        combined = Dataflow(self.input_schema)
        mapping: Dict[int, Node] = {self.source.id: combined.source}

        def clone(node: Node, flow_src: Dataflow) -> Node:
            if node.id in mapping:
                return mapping[node.id]
            ups = [clone(u, flow_src) for u in node.upstreams]
            nn = Node(combined, node.op, ups)
            mapping[node.id] = nn
            return nn

        tail = clone(self._output, self)
        mapping[other.source.id] = tail
        combined._output = clone(other._output, other)
        return combined

    # -- typechecking -----------------------------------------------------------
    def sorted_nodes(self) -> List[Node]:
        if self._output is None:
            raise ValueError("flow has no output assigned")
        seen: Dict[int, Node] = {}
        order: List[Node] = []

        def visit(n: Node):
            if n.id in seen:
                return
            seen[n.id] = n
            for u in n.upstreams:
                visit(u)
            order.append(n)

        visit(self._output)
        return order

    def typecheck(self) -> Dict[int, Tuple[Schema, Optional[str]]]:
        """Propagate (schema, grouping) through the DAG; raises on mismatch."""
        info: Dict[int, Tuple[Schema, Optional[str]]] = {}
        for n in self.sorted_nodes():
            if n.op is None:
                info[n.id] = (self.input_schema, None)
            else:
                schemas = [info[u.id][0] for u in n.upstreams]
                groupings = [info[u.id][1] for u in n.upstreams]
                info[n.id] = (n.op.typecheck(schemas),
                              n.op.out_grouping(groupings))
        return info

    # -- local interpreter (tests / reference semantics) -------------------------
    def execute_local(self, table: Table, ctx=None) -> Table:
        self.typecheck()
        results: Dict[int, Table] = {}
        for n in self.sorted_nodes():
            if n.op is None:
                results[n.id] = table
            else:
                ins = [results[u.id] for u in n.upstreams]
                results[n.id] = n.op.apply(ins, ctx)
        return results[self._output.id]

    # -- runtime deployment -------------------------------------------------------
    def deploy(self, runtime, **opt_flags):
        from repro_torch.core.compiler import compile_flow
        self._deployed = compile_flow(self, runtime, **opt_flags)
        return self._deployed

    def execute(self, table: Table):
        if self._deployed is None:
            raise RuntimeError("deploy() the flow first")
        return self._deployed.execute(table)
