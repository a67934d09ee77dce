"""Automated optimization selection (the paper's §7 "Future Work: Automated
Optimization Selection", implemented as a simple cost-based planner; port
of the reference package's ``core/planner.py``).

The paper requires the user to pick which optimizations to enable.  This
planner instead *profiles* the flow on a sample input (per-operator latency
mean/CV and output payload size) and decides:

* **fusion** — fuse a chain edge when the modeled inter-function cost
  (invocation overhead + payload transfer) is a significant fraction of the
  downstream operator's own compute time; keep slow, compute-heavy
  operators separate so the autoscaler retains per-operator granularity
  (the paper's stated fusion<->autoscaling tradeoff, §4).
* **competitive execution** — replicate operators whose latency
  coefficient-of-variation exceeds a threshold (tail-dominated stages).
* **locality / dynamic dispatch** — enabled whenever the flow contains
  ``lookup`` operators with non-trivial payloads.

``auto_deploy`` annotates the flow and deploys with the chosen flags.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.core import operators as ops
from repro_torch.core.dataflow import Dataflow, Node
from repro_torch.core.table import Table
from repro_torch.runtime.netmodel import NetModel


@dataclasses.dataclass
class OpProfile:
    mean_s: float
    cv: float
    out_bytes: int
    runs: int


@dataclasses.dataclass
class Plan:
    fusion: bool
    competitive_exec: bool
    locality: bool
    replicas: Dict[int, int]            # node id -> competitive replicas
    profiles: Dict[int, OpProfile]
    notes: List[str]
    jit_fusion: bool = True             # lower fused tensor chains
    batched_lowering: bool = True       # whole row batches per dispatch
    default_replicas: int = 3

    @property
    def flags(self) -> Dict[str, Any]:
        return {"fusion": self.fusion,
                "competitive_exec": self.competitive_exec,
                "locality": self.locality,
                "jit_fusion": self.jit_fusion,
                "batched_lowering": self.batched_lowering,
                "default_replicas": self.default_replicas}

    def build_pipeline(self, config=None, device=None):
        """The plan IS a pass configuration: materialize it as the
        ``PassPipeline`` the compiler will run over the physical-plan IR.
        ``config`` (a ``repro_torch.profiling.optimizer.PlanConfig``) adds
        the SLO optimizer's per-node overrides — padding buckets, batched
        vs per-row lowering, placement — so bucket sizes stop being global
        constants.  ``device`` is where lowered chains run (the CUDA
        device unless named), as in ``passes.build_pipeline``."""
        from repro_torch.core.passes import build_pipeline
        return build_pipeline(plan_config=config, device=device,
                              **self.flags)


def profile_flow(flow: Dataflow, sample: Table, *, runs: int = 3,
                 kvs=None) -> Dict[int, OpProfile]:
    """Profile the flow at the sample's batch size, one ``OpProfile`` per
    node.  The measurement loop lives in ``repro_torch.profiling.profiler``
    (the batch-sweep profiler) — this is the planner-facing view of a
    single-size sweep."""
    from repro_torch.profiling.profiler import profile_flow_curves
    fp = profile_flow_curves(flow, sample, runs=runs, kvs=kvs)
    profiles: Dict[int, OpProfile] = {}
    for nid, curve in fp.curves.items():
        if not curve.buckets:
            continue
        b = max(curve.buckets)
        st = curve.buckets[b]
        profiles[nid] = OpProfile(mean_s=st.mean_s, cv=st.cv,
                                  out_bytes=st.out_bytes, runs=st.runs)
    return profiles


def make_plan(flow: Dataflow, sample: Table, *, net: Optional[NetModel] = None,
              runs: int = 3, kvs=None,
              fuse_ratio: float = 0.25,       # hop cost / compute threshold
              cv_threshold: float = 0.5,
              replicas: int = 3) -> Plan:
    net = net or NetModel()
    profiles = profile_flow(flow, sample, runs=runs, kvs=kvs)
    notes: List[str] = []

    # -- fusion: is the average chain edge dominated by hop costs? ----------
    edge_votes, edge_total = 0, 0
    for n in flow.sorted_nodes():
        if n.op is None or len(n.upstreams) != 1:
            continue
        up = n.upstreams[0]
        if up.op is None:
            continue
        hop = net.invoke_overhead_s + net.transfer_time(
            profiles[up.id].out_bytes)
        compute = profiles[n.id].mean_s
        edge_total += 1
        if hop > fuse_ratio * max(compute, 1e-9):
            edge_votes += 1
    fusion = edge_total > 0 and edge_votes >= max(1, edge_total // 2)
    notes.append(f"fusion: {edge_votes}/{edge_total} edges hop-dominated")

    # -- competitive: flag tail-dominated operators --------------------------
    rep: Dict[int, int] = {}
    for n in flow.sorted_nodes():
        if n.op is None:
            continue
        p = profiles[n.id]
        if p.cv > cv_threshold and p.mean_s > 1e-3:
            rep[n.id] = replicas
            n.op.high_variance = True
            n.op.competitive_replicas = replicas
            notes.append(f"competitive x{replicas}: node {n.id} "
                         f"({n.op.name}, cv={p.cv:.2f})")
    competitive_exec = bool(rep)

    # -- locality: lookups with real payloads --------------------------------
    locality = False
    for n in flow.sorted_nodes():
        if n.op is None:
            continue
        is_lookup = isinstance(n.op, ops.Lookup)
        if is_lookup and profiles[n.id].out_bytes > 64 * 1024:
            locality = True
            notes.append(f"locality: lookup node {n.id} moves "
                         f"{profiles[n.id].out_bytes/1e6:.2f} MB")

    # -- lowering: fused GPU tensor chains compose into one callable -------
    # count *fusable adjacent* lowerable-map edges (same structural
    # conditions fusion uses), so the note only fires when
    # LowerTorchChains will actually get a >=2-op chain to lower
    from repro_torch.core.lowering import map_is_torch_lowerable
    counts: Dict[int, int] = {}
    for n in flow.sorted_nodes():
        for u in n.upstreams:
            counts[u.id] = counts.get(u.id, 0) + 1

    def _lowerable_gpu(n) -> bool:
        return (n.op is not None and n.op.resource_class == "gpu"
                and map_is_torch_lowerable(n.op))

    jit_edges = sum(
        1 for n in flow.sorted_nodes()
        if _lowerable_gpu(n) and len(n.upstreams) == 1
        and _lowerable_gpu(n.upstreams[0])
        and counts.get(n.upstreams[0].id, 0) == 1)
    jit_fusion = bool(fusion and jit_edges >= 1)
    if jit_fusion:
        notes.append(f"jit: {jit_edges} fusable gpu tensor map edges are "
                     "lowerable after fusion")

    # -- batched lowering: batch-hinted ops or multi-row requests benefit
    # from ONE batched dispatch per batch; per-row lowering is kept for
    # strictly single-row pipelines (no stacking overhead to pay)
    has_batch_hint = any(n.op is not None and n.op.batching
                         for n in flow.sorted_nodes())
    batched_lowering = bool(jit_fusion
                            and (has_batch_hint or len(sample.rows) > 1))
    if jit_fusion:
        notes.append("batched lowering: "
                     + ("batch the row batches (batch-hinted ops or "
                        "multi-row sample)" if batched_lowering
                        else "per-row (single-row pipeline, no batch hints)"))
    return Plan(fusion=fusion, competitive_exec=competitive_exec,
                locality=locality, replicas=rep, profiles=profiles,
                notes=notes, jit_fusion=jit_fusion,
                batched_lowering=batched_lowering,
                default_replicas=replicas)


def auto_deploy(flow: Dataflow, runtime, sample: Table, *, runs: int = 3,
                **plan_kwargs):
    """Profile, plan, and deploy in one call (paper §7 made concrete)."""
    plan = make_plan(flow, sample, net=runtime.net, runs=runs,
                     kvs=runtime.kvs, **plan_kwargs)
    deployed = flow.deploy(runtime, pipeline=plan.build_pipeline(
        device=runtime.device))
    return deployed, plan
