"""Online SLO controller: the *replan* step of the
measure -> model -> plan -> replan loop (port of the reference package's
``profiling/controller.py``).

``SLOController`` periodically (or on explicit ``tick()``, which is what
tests drive) closes the loop over a LIVE deployment:

1. **measure** — snapshot ``Runtime.metrics`` (consistent under the
   metrics lock), derive the current arrival rate from request
   timestamps, and fold every lowered chain's live ``ChainProfile``
   (measured per-row / per-bucket EWMAs) back into the offline
   :class:`~repro_torch.profiling.profiler.FlowProfile` curves;
2. **model + plan** — re-run ``optimizer.propose`` at the measured rate;
3. **replan** — hot-apply the *runtime-safe* deltas (batcher window and
   max-batch, lowered-op padding buckets, autoscaler replica targets)
   through ``PlanConfig.apply_runtime`` — no flow re-registration, no
   executable re-trace; when the proposal needs compile-time changes
   (lowering mode, placement, competitive topology) AND the deployment
   misses the SLO — a missed latency estimate OR a rising error rate
   (failures must not read as "fast") — escalate: record a ``replan``
   event and invoke ``on_replan``.  When a ``replan_sample`` is
   provided, ``on_replan`` defaults to a
   :class:`~repro_torch.profiling.replan.BlueGreenReplanner` over the same
   deployment: compile the green plan off the hot path, pre-warm its
   executables through the shared cache, canary-verify, atomically swap
   generations, and confirm the post-swap SLO on the next tick
   (``post_replan_confirm`` in the event detail).  Without a sample the
   escalation only records the event — a swap that can be neither
   warmed nor verified is not taken by default.

The controller never blocks the serving path: every step is control
plane, reading locked snapshots and mutating batcher/bucket/target knobs
that the hot path reads per call.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs import keys as okeys
from repro_torch.obs.attribution import attribute
from repro_torch.obs.clock import now as _mono
from repro_torch.profiling.estimator import (FaultStats, LatencyEstimator,
                                             Workload)
from repro_torch.profiling.optimizer import NodeConfig, PlanConfig, propose
from repro_torch.profiling.profiler import FlowProfile, refresh_from_plan


@dataclasses.dataclass
class ControllerEvent:
    kind: str                    # "idle" | "steady" | "apply" | "replan"
    t: float
    arrival_rate: float
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)


class SLOController:
    """Watches one deployed flow and keeps its configuration matched to
    the measured traffic and the latency SLO."""

    def __init__(self, runtime, deployed, slo_p99_s: float, *,
                 profile: FlowProfile,
                 autoscaler=None,
                 interval_s: float = 0.5,
                 window_s: float = 5.0,
                 min_rate: float = 0.5,
                 max_replicas: int = 8,
                 max_window_ms: float = 10.0,
                 max_error_rate: float = 0.02,
                 replan_sample=None,
                 replan_cooldown_s: float = 30.0,
                 on_replan: Optional[Callable[[PlanConfig], Any]] = None):
        self.runtime = runtime
        self.deployed = deployed
        self.slo_p99_s = slo_p99_s
        self.profile = profile
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self.window_s = window_s
        self.min_rate = min_rate
        self.max_replicas = max_replicas
        self.max_window_ms = max_window_ms
        #: error fraction over the window above which the deployment
        #: counts as missing its SLO even if the (success-only) latency
        #: estimate looks fine
        self.max_error_rate = max_error_rate
        #: representative request table handed to the default replanner
        #: for executable warming + canary verification
        self.replan_sample = replan_sample
        #: after a FAILED replan (canary mismatch, compile error), wait
        #: this long before attempting another — each attempt costs a
        #: full compile + warm + canary round on the controller thread,
        #: and a persistent failure would otherwise re-run it every tick
        self.replan_cooldown_s = replan_cooldown_s
        self.on_replan = on_replan
        self.applied: Optional[PlanConfig] = None
        self.events: List[ControllerEvent] = []
        self._replanner = None          # lazily built default on_replan
        self._confirm_next = False      # a replan swapped; judge next tick
        self._last_handler = None       # who performed the last swap
                                        # (rollback target on failed confirm)
        self._next_replan_t = 0.0       # failure cooldown gate
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SLOController":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="slo-controller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop = True

    def _loop(self) -> None:
        while not self._stop:
            try:
                self.tick()
            except Exception:       # the control loop must never die
                pass
            time.sleep(self.interval_s)

    # -- measurement ---------------------------------------------------------
    def arrival_rate(self,
                     snapshot: Optional[Dict[str, List[float]]] = None) \
            -> float:
        """Requests/s over the recent window, from the runtime's request
        timestamps for this DAG."""
        snap = snapshot if snapshot is not None \
            else self.runtime.metrics_snapshot()
        ts = snap.get(okeys.dag(self.deployed.dag.name, "request_t"), [])
        if len(ts) < 2:
            return 0.0
        # window against NOW (same clock call_dag stamps), not the newest
        # request — anchoring on ts[-1] would re-measure the last burst's
        # rate forever after traffic stops, pinning stale replica targets
        now = _mono()
        recent = [t for t in ts if t >= now - self.window_s]
        if len(recent) < 2:
            return 0.0
        span = recent[-1] - recent[0]
        if span <= 0:
            return 0.0
        return (len(recent) - 1) / span

    def error_rate(self,
                   snapshot: Optional[Dict[str, List[float]]] = None) \
            -> float:
        """Failed fraction of this DAG's requests completing in the
        recent window (error completions over all completions)."""
        snap = snapshot if snapshot is not None \
            else self.runtime.metrics_snapshot()
        name = self.deployed.dag.name
        now = _mono()
        lo = now - self.window_s
        errs = sum(1 for t in snap.get(okeys.dag(name, "error_t"), [])
                   if t >= lo)
        if errs == 0:
            return 0.0
        # successes carry no completion timestamp series; approximate the
        # window's total with arrivals (completions lag arrivals by one
        # latency — negligible at controller timescales).  An error burst
        # whose arrivals already left the window still reads as 100%.
        arrivals = sum(
            1 for t in snap.get(okeys.dag(name, "request_t"), [])
            if t >= lo)
        return errs / max(1, errs, arrivals)

    #: retries outnumbering successful completions by this factor over
    #: the window is a retry storm: recovery work has become the load
    RETRY_STORM_FACTOR = 3.0

    def fault_rate(self,
                   snapshot: Optional[Dict[str, List[float]]] = None) \
            -> Dict[str, float]:
        """Fault-tolerance activity over the recent window, in events per
        second: executor crashes and wedges (fleet-wide — a dead replica
        degrades every DAG sharing the pool), plus this DAG's retries and
        hedges.  Kept SEPARATE from :meth:`error_rate`: a recovered fault
        is invisible to callers and must not read as a request failure.
        ``storm`` is True when retries outnumber completions by
        :data:`RETRY_STORM_FACTOR` — at that point recovery work IS the
        load, and the deployment counts as missing its SLO."""
        snap = snapshot if snapshot is not None \
            else self.runtime.metrics_snapshot()
        name = self.deployed.dag.name
        lo = _mono() - self.window_s

        def count(key: str) -> int:
            return sum(1 for t in snap.get(key, []) if t >= lo)

        retries = count(okeys.dag(name, "retry_t"))
        # successful completions carry a latency sample, not a timestamp;
        # window-total approximated by arrivals, as in error_rate
        completions = count(okeys.dag(name, "request_t"))
        w = max(self.window_s, 1e-9)
        return {"crash_rate": count(okeys.fault("crash")) / w,
                "wedge_rate": count(okeys.fault("wedge")) / w,
                "requeue_rate": count(okeys.FAULT_REQUEUED) / w,
                "retry_rate": retries / w,
                "hedge_rate": count(okeys.dag(name, "hedge_t")) / w,
                "storm": float(
                    retries > self.RETRY_STORM_FACTOR
                    * max(1, completions))}

    def protection_rates(self,
                         snapshot: Optional[Dict[str, List[float]]] = None) \
            -> Dict[str, float]:
        """Overload-protection activity over the recent window, in events
        per second: requests shed at the admission gate, expired before
        dispatch, and admitted degraded.  These series are SEPARATE from
        ``error_t`` by design — a deployment shedding by policy is
        protecting itself, not failing, and must not read as an
        error-rate SLO miss."""
        snap = snapshot if snapshot is not None \
            else self.runtime.metrics_snapshot()
        name = self.deployed.dag.name
        lo = _mono() - self.window_s

        def count(key: str) -> int:
            return sum(1 for t in snap.get(key, []) if t >= lo)

        degraded = sum(
            count(k) for k in snap
            if k.startswith(f"admission/{name}/")
            and k.endswith("/degraded_t"))
        w = max(self.window_s, 1e-9)
        return {"shed_rate": count(okeys.dag(name, "shed_t")) / w,
                "expired_rate": count(okeys.dag(name, "expired_t")) / w,
                "degraded_rate": degraded / w}

    def refresh_profile(self) -> bool:
        """Fold live ChainProfile measurements into the curves."""
        return refresh_from_plan(self.profile, self.deployed.plan)

    def _default_replanner(self):
        """The default ``on_replan``: a BlueGreenReplanner over this
        deployment (built lazily; needs the logical flow and the recorded
        compile flags to produce an op-id-stable recompile).  Without a
        ``replan_sample`` there is NO default: a sample is what makes the
        swap warm (zero post-swap traces) and canary-verified — silently
        swapping a cold, unverified plan under a live SLO miss would be
        worse than recording the event, the pre-PR-5 behavior."""
        if self._replanner is None:
            from repro_torch.profiling.replan import BlueGreenReplanner
            if getattr(self.deployed, "flow", None) is None \
                    or self.replan_sample is None:
                return None
            self._replanner = BlueGreenReplanner(
                self.runtime, self.deployed, sample=self.replan_sample,
                autoscaler=self.autoscaler)
        return self._replanner

    # -- the loop body -------------------------------------------------------
    def tick(self) -> ControllerEvent:
        now = _mono()
        # prefix-filtered snapshot: the controller only reads this DAG's
        # series plus the fleet-wide fault series, so the metrics-lock
        # hold no longer scales with every OTHER deployment's history
        name = self.deployed.dag.name
        snap = self.runtime.metrics_snapshot(
            prefix=(f"dag/{name}/", "faults/", f"admission/{name}/"))
        rate = self.arrival_rate(snap)
        if rate < self.min_rate:
            ev = ControllerEvent("idle", now, rate)
            self.events.append(ev)
            return ev
        self.refresh_profile()
        proposal = propose(self.deployed.plan, self.slo_p99_s, rate,
                           profile=self.profile, net=self.runtime.net,
                           max_replicas=self.max_replicas,
                           max_window_ms=self.max_window_ms)
        detail: Dict[str, Any] = {
            "predicted_p99_ms": (proposal.predicted.p99_s * 1e3
                                 if proposal.predicted else None)}

        kind = "steady"
        if self.applied is None or proposal.differs_runtime(self.applied):
            notes = proposal.apply_runtime(self.runtime, self.deployed.dag,
                                           autoscaler=self.autoscaler)
            if notes:
                kind = "apply"
                detail["applied"] = notes

        # does the deployment as it NOW stands meet the SLO?  That is the
        # proposal's runtime-safe knobs (just applied above) with the
        # compile-time facts — lowering mode, competitive topology,
        # placement — read back from the LIVE plan: judging against the
        # pre-apply config would escalate a replan whose safe deltas
        # already fixed the miss, and trusting the proposal's unapplied
        # compile-time knobs would mask a persistent miss forever
        current = self._live_config(proposal)
        # fault-tolerance activity feeds the estimator: crashes and
        # hedged stragglers that RECOVERED don't show up in error_t, but
        # disturbed requests re-pay the path — the fault-aware estimator
        # inflates the predicted p99 by the measured disturbed fraction
        # instead of judging the SLO against a clean-path fiction
        fault = self.fault_rate(snap)
        fstats = FaultStats(
            crash_rate=fault["crash_rate"],
            wedge_rate=fault["wedge_rate"],
            retry_rate=fault["retry_rate"],
            requeue_rate=fault["requeue_rate"],
            detection_s=getattr(self.runtime, "detector_interval_s", 0.0))
        cur_pred = LatencyEstimator(self.profile, net=self.runtime.net,
                                    fault=fstats) \
            .estimate(self.deployed.plan, current,
                      Workload(arrival_rate=rate))
        detail["current_p99_ms"] = cur_pred.p99_s * 1e3
        detail["fault_inflation"] = fstats.disturbed_fraction(rate)
        # a rising error rate is an SLO miss: the latency series only
        # records successes, so under failures the measured (and modeled)
        # p99 improves exactly when the system degrades
        err_rate = self.error_rate(snap)
        detail["error_rate"] = err_rate
        # a retry storm (recovery work exceeding completions) means the
        # deployment is burning capacity re-executing — an SLO miss even
        # while callers still get answers
        detail["fault"] = fault
        slo_ok = cur_pred.meets(self.slo_p99_s) \
            and err_rate <= self.max_error_rate \
            and not fault["storm"]
        detail["slo_ok"] = slo_ok
        # overload protection activity: shed/expired/degraded decisions
        # ride their own metric series, so the controller can tell
        # "overloaded and protecting itself" (admission gate active,
        # surviving traffic healthy) from "missing SLO" (it is not)
        prot = self.protection_rates(snap)
        detail["protection"] = prot
        detail["protecting"] = any(v > 0 for v in prot.values())
        # SLO-miss attribution from the tracer's kept traces: the
        # per-node queue/service/transfer/retry/hedge breakdown, with the
        # dominant contributor named — the "why" next to every miss
        tracer = getattr(self.runtime, "tracer", None)
        if tracer is not None and tracer.enabled:
            kept = tracer.kept(name)
            if kept:
                detail["attribution"] = attribute(
                    kept, slo_only=True).to_dict()
        adm = getattr(self.runtime, "admission_for", lambda _n: None)(
            self.deployed.dag.name)
        if adm is not None:
            # keep the gate's model pointed at the LIVE deployment: same
            # plan, same measured curves, same applied config the
            # controller just judged
            adm.update(plan=self.deployed.plan, profile=self.profile,
                       config=current)
            detail["admission"] = adm.snapshot()
        if self._confirm_next:
            # the previous tick swapped generations: judge the post-swap
            # deployment against the SLO and say so
            self._confirm_next = False
            confirm: Dict[str, Any] = {
                "p99_ms": cur_pred.p99_s * 1e3, "slo_ok": slo_ok}
            tracer = getattr(self.runtime, "tracer", None)
            if tracer is not None and getattr(tracer, "enabled", False):
                ce = getattr(tracer, "control_event", None)
                if ce is not None:
                    # the confirm verdict closes the swap lifecycle on
                    # the control track (prepare/warm/canary/swap/confirm)
                    ce(f"replan@{self.deployed.dag.name}", phase="confirm",
                       ok=slo_ok, p99_ms=cur_pred.p99_s * 1e3)
            if not slo_ok:
                # green failed its confirm: roll back to blue
                # automatically, and cool down so the very next tick does
                # not re-compile the same failing green
                sb = getattr(self._last_handler, "swap_back", None)
                rb = sb(f"post_replan_confirm failed: p99 "
                        f"{cur_pred.p99_s * 1e3:.1f}ms, err {err_rate:.3f}") \
                    if sb is not None else None
                if rb:
                    confirm["rollback"] = rb
                    kind = "replan"
                    detail["rolled_back"] = True
                    self._next_replan_t = now + self.replan_cooldown_s
            detail["post_replan_confirm"] = confirm
        if not slo_ok \
                and self._needs_recompile(proposal) \
                and proposal.predicted is not None \
                and proposal.predicted.p99_s < cur_pred.p99_s:
            # safe deltas alone don't reach the SLO and the proposal wants
            # compile-time changes the live plan can't express (lowering
            # mode / placement / competitive topology): escalate
            kind = "replan"
            detail["recompile"] = True
            if now < self._next_replan_t:
                # a recent attempt failed; don't burn a compile + warm +
                # canary round every tick on a fault that hasn't changed
                detail["replan_suppressed_s"] = self._next_replan_t - now
            else:
                handler = self.on_replan or self._default_replanner()
                if handler is not None:
                    result = handler(proposal)
                    report = getattr(result, "to_dict", None)
                    if report is not None:
                        detail["replan_report"] = report()
                    if getattr(result, "ok", False):
                        # green is live — confirm SLO on the next tick
                        self._confirm_next = True
                        self._last_handler = handler
                    elif hasattr(result, "ok"):
                        self._next_replan_t = now + self.replan_cooldown_s
        self.applied = proposal
        ev = ControllerEvent(kind, now, rate, detail)
        self.events.append(ev)
        return ev

    def _live_config(self, applied: Optional[PlanConfig]) -> PlanConfig:
        """The deployment as it actually is: the applied runtime-safe
        knobs (or defaults) with compile-time facts — lowering mode,
        competitive replication — read back from the live plan."""
        import dataclasses as _dc

        from repro_torch.core.lowering import BatchedJittedFuse
        plan = self.deployed.plan
        # competitive topology is EXPANDED in a compiled plan: the factor
        # lives in the wait-any consumer's input count, not in .replicas
        # (CompetitivePass resets the replica ops' annotation to 0)
        competitive: Dict[int, int] = {}
        for o in plan.ops:
            if o.wait_any and len(o.inputs) >= 2:
                competitive[o.op_id] = len(o.inputs)
                for i in o.inputs:
                    competitive[i] = len(o.inputs)
        cfg = PlanConfig(nodes={}, slo_p99_s=self.slo_p99_s)
        for o in plan.ops:
            base = applied.nodes.get(o.op_id) if applied else None
            nc = _dc.replace(base) if base is not None else NodeConfig()
            nc.batched_lowering = isinstance(o.op, BatchedJittedFuse)
            nc.competitive_replicas = competitive.get(o.op_id, o.replicas)
            nc.placement = o.placement
            cfg.nodes[o.op_id] = nc
        return cfg

    def _needs_recompile(self, proposal: PlanConfig) -> bool:
        """Does the proposal want compile-time changes relative to the
        LIVE plan?  Compared against what the deployment actually is, not
        against earlier proposals: a batched-lowered op serves both
        per-row and batched execution through its adaptive router, so a
        ``batched_lowering`` flip only needs a recompile in the
        per-row-lowered -> batched direction."""
        from repro_torch.core.lowering import BatchedJittedFuse, JittedFuse
        for o in self.deployed.plan.ops:
            cfg = proposal.nodes.get(o.op_id)
            if cfg is None:
                continue
            if o.wait_any:
                # this slot already IS a competitive wait-any consumer —
                # asking for competitive execution here is satisfied
                continue
            if cfg.placement is not None and cfg.placement != o.placement:
                return True
            if cfg.competitive_replicas >= 2 and o.replicas < 2:
                return True
            if cfg.batched_lowering and cfg.max_batch > 1 \
                    and isinstance(o.op, JittedFuse) \
                    and not isinstance(o.op, BatchedJittedFuse):
                return True
        return False
