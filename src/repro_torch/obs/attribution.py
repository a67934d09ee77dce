"""SLO-miss attribution: fold kept traces into a per-node breakdown.
Port of the reference package's ``obs/attribution.py``.

A kept trace says where one request's time went; attribution sums that
over many traces into "node X spends its time in component Y", where the
components are:

* ``admission`` — time in the admission decision (request-level; shown
  under the pseudo-node ``(request)``),
* ``queue`` — batcher window wait plus executor queue wait,
* ``service`` — actual user-function execution,
* ``transfer`` — demux/host-copy work splitting batched results,
* ``retry`` — overhead on attempts disturbed by retries/requeues
  (re-execution and backoff gaps),
* ``hedge`` — overhead attributable to hedged duplicates.

``Attribution.dominant()`` names the (node, component) pair that ate the
most time across SLO-missed traces — the controller surfaces it in its
tick detail and ``DeployedFlow.explain()`` prints the table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.trace import Trace

REQUEST_NODE = "(request)"
COMPONENTS = ("admission", "queue", "service", "transfer", "retry", "hedge")


@dataclasses.dataclass
class NodeBreakdown:
    """Seconds spent per component at one node, summed over traces."""
    node: str
    admission_s: float = 0.0
    queue_s: float = 0.0
    service_s: float = 0.0
    transfer_s: float = 0.0
    retry_s: float = 0.0
    hedge_s: float = 0.0
    n_spans: int = 0

    @property
    def total_s(self) -> float:
        return (self.admission_s + self.queue_s + self.service_s
                + self.transfer_s + self.retry_s + self.hedge_s)

    def component(self, name: str) -> float:
        return getattr(self, f"{name}_s")

    def add(self, component: str, seconds: float) -> None:
        setattr(self, f"{component}_s",
                getattr(self, f"{component}_s") + max(0.0, seconds))
        self.n_spans += 1

    def to_dict(self) -> Dict[str, float]:
        return {"node": self.node, "n_spans": self.n_spans,
                "total_s": self.total_s,
                **{f"{c}_s": getattr(self, f"{c}_s") for c in COMPONENTS}}


@dataclasses.dataclass
class Attribution:
    """Per-node component breakdown over a set of traces."""
    nodes: Dict[str, NodeBreakdown]
    n_traces: int
    n_miss: int
    n_shed: int
    n_error: int

    def dominant(self) -> Optional[Tuple[str, str, float]]:
        """(node, component, seconds) with the largest total; None when
        nothing was attributed."""
        best: Optional[Tuple[str, str, float]] = None
        for nb in self.nodes.values():
            for c in COMPONENTS:
                v = nb.component(c)
                if v > 0 and (best is None or v > best[2]):
                    best = (nb.node, c, v)
        return best

    def to_dict(self) -> Dict[str, object]:
        dom = self.dominant()
        return {
            "n_traces": self.n_traces, "n_miss": self.n_miss,
            "n_shed": self.n_shed, "n_error": self.n_error,
            "dominant": ({"node": dom[0], "component": dom[1],
                          "seconds": dom[2]} if dom else None),
            "nodes": {k: v.to_dict() for k, v in sorted(self.nodes.items())},
        }

    def table(self) -> str:
        """Fixed-width text table for ``DeployedFlow.explain()``."""
        lines = [f"{'node':<18} " + " ".join(f"{c:>10}" for c in COMPONENTS)
                 + f" {'total':>10}"]
        order = sorted(self.nodes.values(), key=lambda nb: -nb.total_s)
        for nb in order:
            cells = " ".join(f"{nb.component(c) * 1e3:>8.2f}ms"
                             for c in COMPONENTS)
            lines.append(f"{nb.node:<18} {cells} {nb.total_s * 1e3:>8.2f}ms")
        dom = self.dominant()
        if dom:
            lines.append(f"dominant contributor: {dom[1]}@{dom[0]} "
                         f"({dom[2] * 1e3:.2f}ms across {self.n_traces} "
                         f"traces, {self.n_miss} SLO misses)")
        return "\n".join(lines)


def _fold(trace: Trace, nodes: Dict[str, NodeBreakdown]) -> None:
    def nb(node: str) -> NodeBreakdown:
        b = nodes.get(node)
        if b is None:
            b = nodes[node] = NodeBreakdown(node)
        return b

    # which nodes saw retry/requeue vs hedge events on this trace —
    # classifies the unexplained gap inside that node's exec span
    retry_nodes = set()
    hedge_nodes = set()
    for s in trace.spans:
        if s.kind in ("retry", "requeue"):
            retry_nodes.add(s.node or REQUEST_NODE)
        elif s.kind == "hedge_launch":
            hedge_nodes.add(s.node or REQUEST_NODE)

    for s in trace.spans:
        node = s.node or REQUEST_NODE
        kind = s.kind
        if kind == "admission":
            nb(REQUEST_NODE).add("admission", s.duration_s)
        elif kind == "queue":
            nb(node).add("queue", s.duration_s)
        elif kind == "exec":
            qs = float(s.attrs.get("queue_s", 0.0) or 0.0)
            es = s.attrs.get("exec_s")
            es = float(es) if es is not None else s.duration_s
            b = nb(node)
            b.add("queue", qs)
            b.add("service", es)
            # gap not explained by queueing or execution: backoff delays,
            # lost first attempts, hedge duplicates
            gap = s.duration_s - qs - es
            if gap > 1e-9:
                if node in retry_nodes:
                    b.add("retry", gap)
                elif node in hedge_nodes:
                    b.add("hedge", gap)
                else:
                    b.add("queue", gap)
        elif kind == "demux":
            nb(node).add("transfer", s.duration_s)


def attribute(traces: Iterable[Trace],
              slo_only: bool = False) -> Attribution:
    """Fold traces (optionally only SLO-missed ones) into an
    :class:`Attribution`.  Shed traces always count toward admission —
    they never reached a node."""
    nodes: Dict[str, NodeBreakdown] = {}
    n = miss = shed = err = 0
    for t in traces:
        interesting = t.slo_miss or t.shed or t.error is not None
        if slo_only and not interesting:
            continue
        n += 1
        miss += 1 if t.slo_miss else 0
        shed += 1 if t.shed else 0
        err += 1 if t.error is not None else 0
        _fold(t, nodes)
    return Attribution(nodes=nodes, n_traces=n, n_miss=miss,
                       n_shed=shed, n_error=err)
