"""Offline batch-sweep profiler (port of the reference package's
``profiling/profiler.py``): the *measure* step of the
measure -> model -> plan -> replan loop (InferLine-style per-operator
profiles over a Cloudflow plan).

``profile_plan`` sweeps every ``PhysicalOp`` of a compiled plan across
batch sizes (the same power-of-two buckets ``BatchedJittedFuse`` pads to)
and emits an :class:`OpLatencyCurve` per op — mean/p99/CV whole-batch
latency per bucket plus output payload bytes.  For batched-lowered chains
the per-row path is timed separately (``per_row_s``), which is what lets
the optimizer pick batched-vs-per-row lowering from data instead of
heuristics.

``profile_flow_curves`` is the same sweep over a *logical* ``Dataflow``
(keyed by flow node id); ``repro_torch.core.planner.profile_flow`` routes
through it.

Every timed application ends in a synchronise of the devices holding its
output (a CUDA call returns at launch, so an unsynchronised time would
count the launch alone); an error the device reports there propagates.

Curves serialize to/from plain JSON (:class:`FlowProfile`), so an offline
profile persists across processes and the online controller can refresh
the same curves from live ``ChainProfile`` measurements.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core import operators as ops
from repro_torch.core.ir import SOURCE_ID, PhysicalPlan
from repro_torch.core.table import DeviceTable, Row, Table
from repro_torch.device import synchronize
from repro_torch.runtime.netmodel import nbytes

#: default batch sizes swept per op — aligned with the lowering's
#: power-of-two padding buckets so the curve measures the shapes the
#: batched executable will actually run.
DEFAULT_SWEEP: Tuple[int, ...] = (1, 2, 4, 8, 16)


@dataclasses.dataclass
class BucketStats:
    """Whole-batch latency stats at one swept batch size."""
    mean_s: float
    p99_s: float
    cv: float
    runs: int
    out_bytes: int          # payload bytes of the whole output at this size

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BucketStats":
        return cls(mean_s=float(d["mean_s"]), p99_s=float(d["p99_s"]),
                   cv=float(d["cv"]), runs=int(d["runs"]),
                   out_bytes=int(d["out_bytes"]))


@dataclasses.dataclass
class OpLatencyCurve:
    """One operator's measured latency curve across batch sizes.

    ``buckets[b]`` is the whole-batch cost of serving ``b`` rows in one
    invocation; ``per_row_s`` is the measured seconds/row of the *un*
    batched (per-row executable / interpreted) path, when it was measured
    separately — ``None`` means the op has a single execution mode and
    ``buckets[1]`` is the per-row cost.
    """
    key: int
    name: str
    buckets: Dict[int, BucketStats] = dataclasses.field(default_factory=dict)
    per_row_s: Optional[float] = None

    # -- queries -------------------------------------------------------------
    def _bucket_for(self, b: int) -> Optional[int]:
        measured = sorted(self.buckets)
        if not measured:
            return None
        for m in measured:
            if m >= b:
                return m
        return measured[-1]

    def service_s(self, b: int) -> float:
        """Modeled whole-batch service time for ``b`` rows: the measured
        cost at the smallest bucket >= b (batched execution pads to the
        bucket, so that IS what a b-row batch costs); past the largest
        measured bucket, scale linearly."""
        m = self._bucket_for(b)
        if m is None:
            return 0.0
        st = self.buckets[m]
        return st.mean_s if m >= b else st.mean_s * (b / m)

    def p99_s(self, b: int) -> float:
        m = self._bucket_for(b)
        if m is None:
            return 0.0
        st = self.buckets[m]
        return st.p99_s if m >= b else st.p99_s * (b / m)

    def row_s(self, b: int = 1) -> float:
        """Per-row cost on the un-batched path (falls back to bucket 1)."""
        if self.per_row_s is not None:
            return self.per_row_s
        return self.service_s(1)

    def out_bytes_per_row(self, b: int = 1) -> float:
        m = self._bucket_for(b)
        if m is None:
            return 0.0
        return self.buckets[m].out_bytes / max(1, m)

    def cv(self, b: int = 1) -> float:
        m = self._bucket_for(b)
        return self.buckets[m].cv if m is not None else 0.0

    def crossover_rows(self, max_n: int = 1024) -> Optional[int]:
        """Smallest n where the batched path is measured to beat n per-row
        dispatches — the ONE crossover rule the live router also uses."""
        from repro_torch.core.lowering import crossover_from_costs
        return crossover_from_costs(
            self.per_row_s,
            {b: st.mean_s for b, st in self.buckets.items()}, max_n)

    # -- live refresh --------------------------------------------------------
    def merge_chain_profile(self, prof) -> bool:
        """Fold a live ``ChainProfile`` (or its ``to_dict`` form) into the
        curve: measured EWMAs replace the offline means, keeping each
        bucket's measured tail ratio.  Returns True if anything changed —
        the controller uses this to know its model went stale."""
        d = prof.to_dict() if hasattr(prof, "to_dict") else dict(prof)
        changed = False
        pr = d.get("per_row_s")
        if pr is not None and pr != self.per_row_s:
            self.per_row_s = float(pr)
            changed = True
        for b, s in (d.get("batched_s") or {}).items():
            b, s = int(b), float(s)
            old = self.buckets.get(b)
            if old is None:
                # a bucket the offline sweep never measured: inherit the
                # payload/CV shape from the nearest measured bucket
                # (zeroed out_bytes would erase the estimator's edge
                # transfer cost for any batch resolving here)
                near_b = min(self.buckets,
                             key=lambda m: abs(m - b)) \
                    if self.buckets else None
                if near_b is not None:
                    near = self.buckets[near_b]
                    out_bytes = int(near.out_bytes * b / max(1, near_b))
                    cv, tail = near.cv, max(
                        near.p99_s / near.mean_s if near.mean_s > 0
                        else 1.5, 1.0)
                else:
                    out_bytes, cv, tail = 0, 0.0, 1.5
                self.buckets[b] = BucketStats(
                    mean_s=s, p99_s=tail * s, cv=cv, runs=0,
                    out_bytes=out_bytes)
                changed = True
            elif abs(old.mean_s - s) > 1e-12:
                tail = old.p99_s / old.mean_s if old.mean_s > 0 else 1.5
                old.p99_s = s * tail
                old.mean_s = s
                changed = True
        return changed

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"key": self.key, "name": self.name,
                "per_row_s": self.per_row_s,
                "buckets": {str(b): st.to_dict()
                            for b, st in sorted(self.buckets.items())}}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OpLatencyCurve":
        pr = d.get("per_row_s")
        return cls(key=int(d["key"]), name=str(d.get("name", "")),
                   per_row_s=float(pr) if pr is not None else None,
                   buckets={int(b): BucketStats.from_dict(st)
                            for b, st in (d.get("buckets") or {}).items()})


@dataclasses.dataclass
class FlowProfile:
    """All of a plan's (or flow's) curves plus sweep metadata; the unit of
    persistence (``save``/``load``) and the estimator's input."""
    curves: Dict[int, OpLatencyCurve] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def curve(self, key: int) -> Optional[OpLatencyCurve]:
        return self.curves.get(key)

    def to_dict(self) -> Dict[str, Any]:
        return {"meta": dict(self.meta),
                "curves": {str(k): c.to_dict()
                           for k, c in sorted(self.curves.items())}}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FlowProfile":
        return cls(meta=dict(d.get("meta") or {}),
                   curves={int(k): OpLatencyCurve.from_dict(c)
                           for k, c in (d.get("curves") or {}).items()})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "FlowProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))


class ProfileCtx:
    """Execution context for profiling runs: KVS lookups resolve locally
    (no cache client, no network charge)."""

    def __init__(self, kvs=None):
        self.kvs = kvs

    def kvs_get(self, key):
        return self.kvs.get(key, charge=False)


# ---------------------------------------------------------------------------
# sweep machinery
# ---------------------------------------------------------------------------

def _replicate(sample: Table, b: int) -> Table:
    """A fresh b-row table cycling the sample's rows (new row ids — the
    sweep must not alias row identity across batch sizes)."""
    src = sample.rows or [Row((None,) * len(sample.schema))]
    t = Table(sample.schema, grouping=sample.grouping)
    t.rows = [Row(src[i % len(src)].values) for i in range(b)]
    return t


def _sync(out) -> None:
    """Block until device work behind ``out`` is done: a CUDA call returns
    at launch, and an unsynchronised timing would count the launch alone.
    Errors propagate."""
    if isinstance(out, DeviceTable):
        synchronize(out.columns)
    elif isinstance(out, Table):
        synchronize(v for r in out.rows for v in r.values)


def _stats(samples: List[float], out_bytes: int) -> BucketStats:
    mean = statistics.mean(samples)
    cv = (statistics.stdev(samples) / mean) if (len(samples) > 1 and mean > 0) \
        else 0.0
    return BucketStats(mean_s=mean,
                       p99_s=float(np.percentile(np.asarray(samples), 99)),
                       cv=cv, runs=len(samples), out_bytes=out_bytes)


def _timed_apply(apply: Callable, tables: List[Table], ctx) -> Tuple[float, Any]:
    t0 = time.perf_counter()
    out = apply(tables, ctx)
    _sync(out)
    return time.perf_counter() - t0, out


def _sweep_graph(node_iter: Callable[[], Iterable[Tuple[int, str, Any,
                                                        List[int]]]],
                 sample: Table, *, batch_sizes: Tuple[int, ...],
                 runs: int, warmup: int, kvs) -> FlowProfile:
    """The shared sweep core.  ``node_iter`` yields topologically sorted
    ``(key, name, op, input_keys)`` records (``SOURCE_ID`` = the input).
    For each batch size the graph is executed ``warmup + runs`` times;
    every op application is timed individually, propagating real
    intermediate results downstream (so each op is measured on the data it
    would actually see)."""
    ctx = ProfileCtx(kvs)
    curves: Dict[int, OpLatencyCurve] = {}
    per_row_samples: Dict[int, List[float]] = {}
    for b in batch_sizes:
        src = _replicate(sample, b)
        stats: Dict[int, List[float]] = {}
        sizes: Dict[int, int] = {}
        for it in range(warmup + runs):
            timed = it >= warmup
            results: Dict[int, Any] = {SOURCE_ID: src}
            for key, name, op, input_keys in node_iter():
                ins = [results[i] for i in input_keys]
                dt, out = _timed_apply(lambda ts, c: op.apply(ts, c),
                                       ins, ctx)
                results[key] = out
                if timed:
                    stats.setdefault(key, []).append(dt)
                    sizes[key] = nbytes(out)
                # batched-lowered chains: time the per-row path too
                # (JittedFuse.apply on the same instance) so the optimizer
                # can compare the two modes; only once, at the largest
                # swept size, where per-row cost per row is most stable.
                # Its errors propagate, as the batched call's do.
                if timed and b == max(batch_sizes) and len(src.rows) > 0 \
                        and _has_per_row_path(op):
                    from repro_torch.core.lowering import JittedFuse
                    dt2, _ = _timed_apply(
                        lambda ts, c: JittedFuse.apply(op, ts, c),
                        ins, ctx)
                    per_row_samples.setdefault(key, []).append(
                        dt2 / len(ins[0].rows))
            for key, name, op, _ in node_iter():
                if key not in curves:
                    curves[key] = OpLatencyCurve(key=key, name=name)
        for key, samples in stats.items():
            curves[key].buckets[b] = _stats(samples, sizes.get(key, 0))
    for key, samples in per_row_samples.items():
        curves[key].per_row_s = statistics.mean(samples)
    return FlowProfile(curves=curves,
                       meta={"batch_sizes": list(batch_sizes),
                             "runs": runs, "warmup": warmup,
                             "sample_rows": len(sample.rows)})


def _has_per_row_path(op) -> bool:
    from repro_torch.core.lowering import BatchedJittedFuse
    return isinstance(op, BatchedJittedFuse)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def profile_plan(plan: PhysicalPlan, sample: Table, *,
                 batch_sizes: Tuple[int, ...] = DEFAULT_SWEEP,
                 runs: int = 3, warmup: int = 1, kvs=None) -> FlowProfile:
    """Sweep every op of a compiled ``PhysicalPlan`` across batch sizes.
    Curve keys are plan op ids, matching ``PlanConfig``/estimator keys."""
    plan.validate()

    def node_iter():
        for o in plan.ops:
            yield o.op_id, o.op.name, o.op, list(o.inputs)

    fp = _sweep_graph(node_iter, sample, batch_sizes=tuple(batch_sizes),
                      runs=runs, warmup=warmup, kvs=kvs)
    fp.meta["kind"] = "plan"
    return fp


def profile_flow_curves(flow, sample: Table, *,
                        batch_sizes: Optional[Tuple[int, ...]] = None,
                        runs: int = 3, warmup: int = 0,
                        kvs=None) -> FlowProfile:
    """Sweep a *logical* ``Dataflow`` (curve keys = flow node ids).  The
    default sweep is the sample's own size — exactly what the cost-based
    planner's fuse/competitive/locality decisions need — pass explicit
    ``batch_sizes`` for a full curve."""
    flow.typecheck()
    if batch_sizes is None:
        batch_sizes = (max(1, len(sample.rows)),)

    def node_iter():
        for n in flow.sorted_nodes():
            if n.op is None:
                continue
            yield (n.id, n.op.name, n.op,
                   [u.id if u.op is not None else SOURCE_ID
                    for u in n.upstreams])

    fp = _sweep_graph(node_iter, sample, batch_sizes=tuple(batch_sizes),
                      runs=runs, warmup=warmup, kvs=kvs)
    fp.meta["kind"] = "flow"
    return fp


def seed_from_model_ops(plan: PhysicalPlan, *,
                        batch_sizes: Tuple[int, ...] = DEFAULT_SWEEP
                        ) -> FlowProfile:
    """Build a ``FlowProfile`` from the plan's ``ModelOp`` cost hooks:
    each hook measures its model stage natively batched at every swept
    size, and an op's curve is the sum of its (possibly fused) model-stage
    hooks per bucket.  This is how real model profiles enter the
    measure->model->plan loop without a full graph sweep — curves for the
    plan's non-model ops are left to ``profile_plan``/``refresh_from_plan``
    (``SLOController.refresh_profile`` merges live chain measurements into
    whatever this seeds)."""
    curves: Dict[int, OpLatencyCurve] = {}
    for o in plan.ops:
        subs = list(getattr(o.op, "ops", None) or [o.op])
        hooked = [s for s in subs
                  if isinstance(s, ops.ModelOp) and s.cost_hook is not None]
        if not hooked:
            continue
        curve = OpLatencyCurve(key=o.op_id, name=o.op.name)
        for b in batch_sizes:
            mean = p99 = cv = 0.0
            runs, out_bytes = 0, 0
            for s in hooked:
                d = s.cost_hook(b)
                mean += float(d["mean_s"])
                p99 += float(d["p99_s"])
                cv = max(cv, float(d["cv"]))
                runs = int(d["runs"]) if not runs \
                    else min(runs, int(d["runs"]))
                out_bytes = int(d["out_bytes"])   # last stage's payload
            curve.buckets[b] = BucketStats(mean_s=mean, p99_s=p99, cv=cv,
                                           runs=runs, out_bytes=out_bytes)
        curves[o.op_id] = curve
    return FlowProfile(curves=curves,
                       meta={"kind": "model-op-seed",
                             "batch_sizes": list(batch_sizes)})


def refresh_from_plan(profile: FlowProfile, plan: PhysicalPlan) -> bool:
    """Fold every live ``ChainProfile`` the plan's lowered ops have
    accumulated into the offline curves (the controller's measure step).
    Returns True if any curve moved."""
    changed = False
    for o in plan.ops:
        prof_fn = getattr(o.op, "profile", None)
        if prof_fn is None:
            continue
        curve = profile.curves.get(o.op_id)
        if curve is None:
            curve = profile.curves[o.op_id] = OpLatencyCurve(
                key=o.op_id, name=o.op.name)
        try:
            if curve.merge_chain_profile(prof_fn()):
                changed = True
        except Exception:
            continue
    return changed
