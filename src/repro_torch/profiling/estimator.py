"""DAG end-to-end latency estimator: the *model* step of the
measure -> model -> plan -> replan loop (port of the reference package's
``profiling/estimator.py``: a copy, the queueing model unchanged).

Per node the model is a batch-service queue: requests arrive at rate
``lambda``, coalesce into batches of ``b`` (paying a batch-formation wait
bounded by the batcher window), and the batches are served by ``c``
replicas whose service time comes from the node's measured
:class:`~repro_torch.profiling.profiler.OpLatencyCurve`.  Queueing delay uses
the M/M/c Erlang-C waiting-time formula on *batch* arrivals — the same
shape InferLine's pipeline model uses, kept deliberately coarse (the
benchmark reports the estimator's relative error against measured serve
latencies, which is the honest way to know how coarse).

End-to-end latency is a critical-path walk over the ``PhysicalPlan`` DAG:
node completion = combine(inputs) + edge cost (invocation overhead +
payload transfer) + node latency, where combine is ``max`` for ordinary
joins and ``min`` for wait-for-any (competitive) nodes — competitive
replication suppresses the tail, so wait-any nodes also use the mean
curve in the p99 walk.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.ir import SOURCE_ID, PhysicalPlan
from repro_torch.profiling.profiler import FlowProfile, OpLatencyCurve
from repro_torch.runtime.netmodel import NetModel

#: fallback service time for ops with no curve (pass-through anyof nodes
#: the competitive pass added, ops the profiler never saw): small but not
#: zero, so critical paths stay ordered sensibly.
DEFAULT_SERVICE_S = 50e-6

#: finite stand-in for "queue grows without bound" (seconds), scaled by
#: utilization so saturated configs still rank against each other.
SATURATION_PENALTY_S = 1e6


@dataclasses.dataclass
class Workload:
    """The open-loop arrival process the estimator models."""
    arrival_rate: float              # requests/s entering the flow
    request_rows: int = 1            # rows per request


@dataclasses.dataclass
class FaultStats:
    """Measured fault pressure (events/sec from the runtime's windowed
    fault counters) the estimator folds into its tail prediction: a
    request caught by a retry or a crash requeue pays roughly one extra
    service time plus the detector's reaction, so under fault pressure
    the clean-path p99 is an underestimate exactly when the controller
    most needs it to be honest."""
    crash_rate: float = 0.0          # executor crashes/s
    wedge_rate: float = 0.0          # wedge detections/s
    retry_rate: float = 0.0          # transient retries/s
    requeue_rate: float = 0.0        # items requeued by failover/s
    detection_s: float = 0.0         # detector reaction time (interval)

    def disturbed_fraction(self, arrival_rate: float) -> float:
        """Fraction of requests whose attempt is disturbed (retried or
        requeued) — the probability mass that pays the inflated path."""
        lam = max(arrival_rate, 1e-9)
        return min(1.0, (self.retry_rate + self.requeue_rate) / lam)

    def inflate_p99(self, p99_s: float, arrival_rate: float) -> float:
        """Predicted p99 with fault pressure folded in: the disturbed
        fraction re-pays the whole clean path (re-execution) plus the
        failure-detection delay.  Zero rates leave the estimate exactly
        unchanged."""
        p = self.disturbed_fraction(arrival_rate)
        if p <= 0.0:
            return p99_s
        return p99_s * (1.0 + p) + p * self.detection_s


def erlang_c(c: int, a: float) -> float:
    """P(wait) for an M/M/c queue with offered load ``a`` erlangs
    (``a = lambda / mu``).  Returns 1.0 at/above saturation."""
    if c <= 0 or a >= c:
        return 1.0
    if a <= 0:
        return 0.0
    s = sum(a ** k / math.factorial(k) for k in range(c))
    last = a ** c / (math.factorial(c) * (1.0 - a / c))
    return last / (s + last)


@dataclasses.dataclass
class NodeEstimate:
    op_id: int
    batch: int                       # modeled batch size (rows)
    replicas: int                    # modeled service replicas (M/M/c c)
    service_s: float                 # whole-batch service time
    service_p99_s: float
    batch_wait_s: float              # batch-formation wait (full window)
    queue_wait_s: float              # M/M/c mean wait for a free replica
    queue_p99_s: float
    rho: float                       # utilization (load per replica)
    mean_s: float                    # per-request mean at this node
    p99_s: float                     # per-request p99 at this node
    feasible: bool                   # rho < 1


@dataclasses.dataclass
class LatencyEstimate:
    mean_s: float
    p99_s: float
    feasible: bool
    nodes: Dict[int, NodeEstimate]
    critical_path: List[int]         # op ids on the p99-critical path

    def meets(self, slo_p99_s: float) -> bool:
        return self.feasible and self.p99_s <= slo_p99_s

    def summary(self) -> Dict[str, object]:
        return {"mean_ms": self.mean_s * 1e3, "p99_ms": self.p99_s * 1e3,
                "feasible": self.feasible,
                "critical_path": list(self.critical_path)}


class LatencyEstimator:
    """Maps (plan, per-node config, workload) -> predicted latency."""

    def __init__(self, profile: FlowProfile,
                 net: Optional[NetModel] = None,
                 fault: Optional[FaultStats] = None):
        self.profile = profile
        self.net = net or NetModel()
        # measured fault pressure; when set, estimate() inflates the p99
        # walk by the disturbed-request fraction (ROADMAP: fault-aware
        # estimator)
        self.fault = fault

    # -- per-node model ------------------------------------------------------
    def node_estimate(self, op_id: int, cfg, wl: Workload,
                      curve: Optional[OpLatencyCurve] = None) -> NodeEstimate:
        """``cfg`` duck-types ``repro_torch.profiling.optimizer.NodeConfig``:
        ``max_batch``, ``batch_wait_ms``, ``batched_lowering``,
        ``target_replicas``, ``competitive_replicas``."""
        curve = curve or self.profile.curve(op_id)
        lam = max(wl.arrival_rate, 1e-9)
        rows = max(1, wl.request_rows)
        max_batch = max(1, int(getattr(cfg, "max_batch", 1) or 1))
        batched = bool(getattr(cfg, "batched_lowering", True))
        c = max(1, int(getattr(cfg, "target_replicas", 1) or 1))
        window = max(0.0, float(getattr(cfg, "batch_wait_ms", 0.0)) / 1e3)

        # expected coalesced batch: what the window can accumulate at this
        # arrival rate, capped by max_batch
        b_req = max(1, min(max_batch, int(lam * window) + 1))
        b_rows = b_req * rows
        batch_wait = 0.0 if b_req <= 1 else min(window, (b_req - 1) / lam)

        if curve is None:
            service = DEFAULT_SERVICE_S
            service_p99 = DEFAULT_SERVICE_S
        elif batched:
            service = curve.service_s(b_rows)
            service_p99 = curve.p99_s(b_rows)
        else:
            service = curve.row_s() * b_rows
            service_p99 = service * (curve.p99_s(1) /
                                     max(curve.service_s(1), 1e-12)
                                     if curve.buckets else 1.0)
        service = max(service, 1e-9)
        service_p99 = max(service_p99, service)

        lam_batches = lam / b_req
        a = lam_batches * service            # offered erlangs
        rho = a / c
        feasible = rho < 1.0
        if feasible:
            pw = erlang_c(c, a)
            # M/M/c: Wq = P(wait) / (c*mu - lambda); tail is exponential
            # with the same rate, so p99 wait = ln(P(wait)/0.01) / rate.
            # Allen-Cunneen correction (Ca^2 + Cs^2)/2 with Poisson
            # arrivals (Ca=1) and the curve's measured service CV: mostly
            # deterministic services (sleep-bound compute) queue about
            # half as much as the exponential model says
            cs2 = (curve.cv(b_rows) ** 2) if curve is not None else 1.0
            ac = (1.0 + min(cs2, 4.0)) / 2.0
            drain = c / service - lam_batches
            queue = ac * pw / drain
            queue_p99 = (ac * math.log(pw / 0.01) / drain) \
                if pw > 0.01 else 0.0
        else:
            # saturated: a huge-but-FINITE penalty ordered by utilization,
            # so the optimizer's greedy search can still rank saturated
            # configs (inf - inf comparisons would stall the ascent) and
            # always walks downhill toward stability first
            queue = queue_p99 = SATURATION_PENALTY_S * rho

        # competitive replication (wait-any over k copies) suppresses the
        # service tail: the fastest of k draws sits near the mean
        if int(getattr(cfg, "competitive_replicas", 0) or 0) >= 2:
            service_p99 = service

        mean = batch_wait / 2.0 + queue + service
        p99 = batch_wait + queue_p99 + service_p99
        return NodeEstimate(op_id=op_id, batch=b_rows, replicas=c,
                            service_s=service, service_p99_s=service_p99,
                            batch_wait_s=batch_wait, queue_wait_s=queue,
                            queue_p99_s=queue_p99, rho=rho, mean_s=mean,
                            p99_s=p99, feasible=feasible)

    # -- DAG model -----------------------------------------------------------
    def estimate(self, plan: PhysicalPlan, config, wl: Workload) \
            -> LatencyEstimate:
        """``config`` duck-types ``PlanConfig``: ``.node(op_id)`` or a
        ``nodes`` dict of per-op configs (missing ops get defaults)."""
        get_node = getattr(config, "node", None)
        nodes_map = getattr(config, "nodes", {}) if get_node is None else None

        class _Default:
            max_batch = 1
            batch_wait_ms = 0.0
            batched_lowering = True
            target_replicas = 1
            competitive_replicas = 0

        def cfg_for(op_id: int):
            if get_node is not None:
                return get_node(op_id)
            return nodes_map.get(op_id, _Default)

        estimates: Dict[int, NodeEstimate] = {}
        done_mean: Dict[int, float] = {SOURCE_ID: 0.0}
        done_p99: Dict[int, float] = {SOURCE_ID: 0.0}
        pred: Dict[int, Optional[int]] = {SOURCE_ID: None}
        feasible = True
        for o in plan.ops:
            ne = estimates[o.op_id] = self.node_estimate(
                o.op_id, cfg_for(o.op_id), wl)
            feasible = feasible and ne.feasible
            in_mean, in_p99, best_in = 0.0, 0.0, None
            arrivals = []
            for i in o.inputs:
                up_curve = self.profile.curve(i)
                edge = self.net.invoke_overhead_s * self.net.scale
                if up_curve is not None:
                    edge += self.net.transfer_time(
                        up_curve.out_bytes_per_row() * ne.batch)
                arrivals.append((done_mean[i] + edge, done_p99[i] + edge, i))
            if arrivals:
                # wait-any fires on the FIRST completed input; ordinary
                # nodes wait for all of them
                pick = min if o.wait_any else max
                in_mean, in_p99, best_in = pick(arrivals)
            done_mean[o.op_id] = in_mean + ne.mean_s
            done_p99[o.op_id] = in_p99 + ne.p99_s
            pred[o.op_id] = best_in
        out = plan.output_id
        path: List[int] = []
        cur: Optional[int] = out
        while cur is not None and cur != SOURCE_ID:
            path.append(cur)
            cur = pred.get(cur)
        p99 = done_p99[out]
        if self.fault is not None:
            p99 = self.fault.inflate_p99(p99, wl.arrival_rate)
        return LatencyEstimate(mean_s=done_mean[out], p99_s=p99,
                               feasible=feasible, nodes=estimates,
                               critical_path=list(reversed(path)))
