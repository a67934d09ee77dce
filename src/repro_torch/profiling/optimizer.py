"""SLO-aware configuration search: the *plan* step of the
measure -> model -> plan -> replan loop (port of the reference package's
``profiling/optimizer.py``).

``propose(plan, slo_p99, arrival_rate)`` searches per-node configuration
space — batch size / padding buckets, batcher window, batched-vs-per-row
lowering, service replicas (M/M/c ``c``), competitive replication — by
querying the :class:`~repro_torch.profiling.estimator.LatencyEstimator`, and
returns a :class:`PlanConfig`:

* per node, the (mode, batch) pair minimizing that node's modeled
  per-request p99 at the measured arrival rate (infeasible points — queue
  utilization >= 1 — are pruned, which is what forces batching on when a
  single replica can't keep up per-row);
* then a greedy InferLine-style replica ascent: while the end-to-end p99
  misses the SLO, add one replica to the critical-path node with the best
  marginal p99 reduction (re-picking its best batch at the new c);
* finally competitive replication for tail-dominated (high-CV) critical
  nodes if the SLO is still missed.

The result is consumed in three places: ``build_pipeline``/``compile_flow``
(per-op bucket/lowering/placement overrides on the pass pipeline),
``PlanConfig.apply_runtime`` (per-node batcher window + max-batch on a
*live* deployment — no re-registration), and ``Autoscaler.set_target``
(per-function replica targets).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.ir import PhysicalPlan
from repro_torch.profiling.estimator import (LatencyEstimate,
                                             LatencyEstimator, Workload)
from repro_torch.profiling.profiler import FlowProfile, profile_plan

#: candidate batch sizes when a curve has no measured buckets
_FALLBACK_BATCHES: Tuple[int, ...] = (1, 2, 4, 8, 16)


@dataclasses.dataclass
class NodeConfig:
    """One op's knobs.  ``max_batch``/``batch_wait_ms`` drive the runtime
    batcher; ``batch_buckets`` the lowering's padding; ``batched_lowering``
    picks batched vs per-row execution; ``target_replicas`` is the M/M/c
    service parallelism (autoscaler target); ``competitive_replicas`` the
    wait-any tail-suppression factor; ``placement`` overrides the executor
    resource class."""
    max_batch: int = 1
    batch_buckets: Tuple[int, ...] = ()
    batch_wait_ms: float = 0.0
    batched_lowering: bool = True
    target_replicas: int = 1
    competitive_replicas: int = 0
    placement: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["batch_buckets"] = list(self.batch_buckets)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NodeConfig":
        kw = dict(d)
        kw["batch_buckets"] = tuple(kw.get("batch_buckets") or ())
        return cls(**kw)


_DEFAULT_NODE = NodeConfig()


@dataclasses.dataclass
class PlanConfig:
    """A complete per-node configuration for one plan, keyed by plan op id
    (stable across recompiles of the same flow with the same flag set)."""
    nodes: Dict[int, NodeConfig] = dataclasses.field(default_factory=dict)
    slo_p99_s: Optional[float] = None
    arrival_rate: Optional[float] = None
    predicted: Optional[LatencyEstimate] = None
    notes: List[str] = dataclasses.field(default_factory=list)

    def node(self, op_id: int) -> NodeConfig:
        return self.nodes.get(op_id, _DEFAULT_NODE)

    # -- pass-pipeline consumption ------------------------------------------
    def bucket_overrides(self) -> Dict[int, Tuple[int, ...]]:
        return {i: c.batch_buckets for i, c in self.nodes.items()
                if c.batch_buckets}

    def batched_overrides(self) -> Dict[int, bool]:
        return {i: c.batched_lowering for i, c in self.nodes.items()}

    def placement_overrides(self) -> Dict[int, str]:
        return {i: c.placement for i, c in self.nodes.items()
                if c.placement}

    def replica_overrides(self) -> Dict[int, int]:
        return {i: c.competitive_replicas for i, c in self.nodes.items()
                if c.competitive_replicas >= 2}

    # -- runtime consumption -------------------------------------------------
    def apply_runtime(self, runtime, dag, autoscaler=None) -> List[str]:
        """Hot-apply the runtime-safe knobs to a LIVE deployment: per-node
        batcher max-batch/window, lowered-op padding buckets, and (when an
        autoscaler is wired) per-function replica targets.  No
        re-registration, no executable re-trace — pure control plane.
        Returns human-readable notes of what changed."""
        applied: List[str] = []
        by_op_id = {n.plan_op_id: n for n in dag.nodes.values()}
        for op_id, cfg in self.nodes.items():
            node = by_op_id.get(op_id)
            if node is None:
                continue
            if node.batching:
                changed = runtime.configure_batching(
                    dag.name, node.name, max_batch=cfg.max_batch,
                    batch_wait_ms=cfg.batch_wait_ms)
                if changed:
                    applied.append(
                        f"{node.name}: batcher max_batch={cfg.max_batch} "
                        f"window={cfg.batch_wait_ms:.2f}ms")
            if cfg.batch_buckets and node.batch_buckets and \
                    tuple(cfg.batch_buckets) != tuple(node.batch_buckets):
                runtime.set_node_buckets(dag.name, node.name,
                                         cfg.batch_buckets)
                applied.append(
                    f"{node.name}: buckets={list(cfg.batch_buckets)}")
            if autoscaler is not None and \
                    node.name in getattr(autoscaler, "functions", {}):
                autoscaler.set_target(node.name, cfg.target_replicas)
                applied.append(
                    f"{node.name}: replica target={cfg.target_replicas}")
        return applied

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"slo_p99_s": self.slo_p99_s,
                "arrival_rate": self.arrival_rate,
                "notes": list(self.notes),
                "predicted": (self.predicted.summary()
                              if self.predicted else None),
                "nodes": {str(i): c.to_dict()
                          for i, c in sorted(self.nodes.items())}}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PlanConfig":
        return cls(slo_p99_s=d.get("slo_p99_s"),
                   arrival_rate=d.get("arrival_rate"),
                   notes=list(d.get("notes") or []),
                   nodes={int(i): NodeConfig.from_dict(c)
                          for i, c in (d.get("nodes") or {}).items()})

    def differs_runtime(self, other: "PlanConfig") -> bool:
        """Do the runtime-safe knobs differ (batcher/buckets/targets)?"""
        keys = set(self.nodes) | set(other.nodes)
        for k in keys:
            a, b = self.node(k), other.node(k)
            if (a.max_batch, a.batch_wait_ms, a.batch_buckets,
                    a.target_replicas) != \
                    (b.max_batch, b.batch_wait_ms, b.batch_buckets,
                     b.target_replicas):
                return True
        return False

    def needs_recompile(self, other: "PlanConfig") -> bool:
        """Do the compile-time knobs differ (lowering mode, placement,
        competitive replication)?  Those can't be hot-applied."""
        keys = set(self.nodes) | set(other.nodes)
        for k in keys:
            a, b = self.node(k), other.node(k)
            if (a.batched_lowering, a.placement, a.competitive_replicas) != \
                    (b.batched_lowering, b.placement, b.competitive_replicas):
                return True
        return False


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _candidate_batches(curve) -> Tuple[int, ...]:
    if curve is not None and curve.buckets:
        return tuple(sorted(curve.buckets))
    return _FALLBACK_BATCHES


def _window_for(b: int, lam: float, max_window_ms: float) -> float:
    """Batcher window that can actually accumulate b requests at rate lam,
    capped so a rate mis-estimate can't park requests forever."""
    if b <= 1:
        return 0.0
    return min(max_window_ms, 1e3 * (b - 1) / max(lam, 1e-9))


def _best_node_cfg(est: LatencyEstimator, op, wl: Workload, c: int,
                   max_window_ms: float, allow_batching: bool) \
        -> Tuple[NodeConfig, float]:
    """The (mode, batch) pair minimizing this node's modeled per-request
    p99 at ``c`` replicas.  Returns (config, node_p99)."""
    curve = est.profile.curve(op.op_id)
    lam = wl.arrival_rate
    best: Optional[Tuple[float, NodeConfig]] = None
    # per-row mode (batch of 1, no window)
    cands: List[NodeConfig] = [NodeConfig(
        max_batch=1, batch_buckets=(1,), batch_wait_ms=0.0,
        batched_lowering=False, target_replicas=c)]
    if allow_batching:
        for b in _candidate_batches(curve):
            cands.append(NodeConfig(
                max_batch=b,
                batch_buckets=tuple(x for x in _FALLBACK_BATCHES + (32, 64)
                                    if x <= b) or (b,),
                batch_wait_ms=_window_for(b, lam, max_window_ms),
                batched_lowering=b > 1 or curve is None
                or curve.per_row_s is None,
                target_replicas=c))
    for cfg in cands:
        ne = est.node_estimate(op.op_id, cfg, wl, curve=curve)
        # saturated points carry a finite utilization-ordered penalty, so
        # when nothing is feasible at this c the highest-throughput shape
        # (largest effective batch) still wins — the ascent fixes c next
        score = ne.p99_s
        if best is None or score < best[0]:
            best = (score, cfg)
    assert best is not None
    return best[1], best[0]


def propose(plan: PhysicalPlan, slo_p99: float, arrival_rate: float, *,
            profile: Optional[FlowProfile] = None, sample=None,
            net=None, kvs=None, request_rows: int = 1,
            max_replicas: int = 8, max_window_ms: float = 10.0,
            cv_competitive: float = 0.5,
            profile_runs: int = 2) -> PlanConfig:
    """SLO-aware configuration search (see module docstring).  ``profile``
    is an offline/refreshed :class:`FlowProfile`; when omitted, ``sample``
    is profiled on the spot.  ``slo_p99`` in seconds."""
    if profile is None:
        if sample is None:
            raise ValueError("propose() needs a FlowProfile or a sample "
                             "table to profile")
        profile = profile_plan(plan, sample, runs=profile_runs, kvs=kvs)
    est = LatencyEstimator(profile, net=net)
    wl = Workload(arrival_rate=arrival_rate, request_rows=request_rows)
    cfg = PlanConfig(nodes={}, slo_p99_s=slo_p99, arrival_rate=arrival_rate)

    # 1) per-node best (mode, batch) at one replica
    for o in plan.ops:
        if o.wait_any:
            cfg.nodes[o.op_id] = NodeConfig(target_replicas=1)
            continue
        allow_batching = bool(o.batching or o.batchable)
        node_cfg, _ = _best_node_cfg(est, o, wl, 1, max_window_ms,
                                     allow_batching)
        node_cfg.placement = o.placement
        cfg.nodes[o.op_id] = node_cfg
    pred = est.estimate(plan, cfg, wl)

    # 2) greedy replica ascent along the critical path
    total_added = 0
    budget = max_replicas * max(1, len(plan.ops))
    while not pred.meets(slo_p99) and total_added < budget:
        best_gain, best_choice = 0.0, None
        path = pred.critical_path or [o.op_id for o in plan.ops]
        for op_id in path:
            o = plan.op(op_id)
            if o.wait_any:
                continue
            cur = cfg.nodes.get(op_id)
            if cur is None or cur.target_replicas >= max_replicas:
                continue
            c = cur.target_replicas + 1
            trial_cfg, _ = _best_node_cfg(
                est, o, wl, c, max_window_ms,
                bool(o.batching or o.batchable))
            trial_cfg.placement = cur.placement
            trial = PlanConfig(nodes=dict(cfg.nodes))
            trial.nodes[op_id] = trial_cfg
            t_pred = est.estimate(plan, trial, wl)
            gain = pred.p99_s - t_pred.p99_s
            if gain > best_gain:
                best_gain, best_choice = gain, (op_id, trial_cfg, t_pred)
        if best_choice is None:
            break
        op_id, trial_cfg, pred = best_choice
        cfg.nodes[op_id] = trial_cfg
        total_added += 1
        cfg.notes.append(f"%{op_id}: +replica -> "
                         f"{trial_cfg.target_replicas} "
                         f"(p99 {pred.p99_s*1e3:.2f}ms)")

    # 3) competitive replication for tail-dominated critical nodes
    if not pred.meets(slo_p99):
        for op_id in (pred.critical_path or []):
            curve = profile.curve(op_id)
            o = plan.op(op_id)
            if o.wait_any or curve is None:
                continue
            cur = cfg.nodes[op_id]
            if curve.cv() > cv_competitive and \
                    cur.competitive_replicas < 2:
                cur.competitive_replicas = 3
                cfg.notes.append(f"%{op_id}: competitive x3 "
                                 f"(cv={curve.cv():.2f})")
        pred = est.estimate(plan, cfg, wl)

    cfg.predicted = pred
    cfg.notes.append(
        f"predicted p99 {pred.p99_s*1e3:.2f}ms vs SLO {slo_p99*1e3:.2f}ms"
        f" at {arrival_rate:.0f} req/s"
        + ("" if pred.meets(slo_p99) else " (NOT met"
           + ("" if pred.feasible else ", saturated") + ")"))
    return cfg
