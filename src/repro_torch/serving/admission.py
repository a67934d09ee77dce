"""Deadline-aware admission control: the front door's overload valve.
Port of the reference package's ``serving/admission.py``, less its
estimator gate: the M/M/c critical-path model lives in ``profiling/``,
which the port has not ported yet (``ROADMAP.md`` §4.3).  A gate given a
``plan`` AND a ``profile`` therefore raises ``NotImplementedError``
instead of quietly admitting everything; without them it behaves as the
reference does (no estimate, the queue penalty priced at
``queue_cost_s`` or the 1 ms floor).

An overloaded deployment that just queues is worse than useless — every
queued request blows its deadline AND inflates the queue for the requests
behind it, so one burst past capacity poisons p99 for *all* traffic
(cascading collapse).  Clipper sheds work against per-query deadlines and
InferLine provisions for bursty arrivals; this module is that idea applied
at the dataflow front door, using the SAME M/M/c critical-path model the
optimizer plans with (``profiling/estimator.py``) so admission and
planning never disagree about what the deployment can sustain.

Mechanics, per offered request:

1. **Token bucket per class** — each :class:`ClassPolicy` may carry a
   rate/burst budget; a class over budget is shed immediately
   (``rate_limit``), before any modeling.  Low-priority classes get small
   buckets, so they are the first traffic to go.
2. **Priority-ordered estimator gate** — the critical-path p99 estimate
   for a class-``k`` request is computed at the arrival rate of all
   traffic with priority **>= k's**: best-effort traffic is modeled
   against the full load (and shed/degraded as soon as the full load
   misses its deadline) while interactive traffic is modeled against only
   its peers — exactly the brownout ordering an operator wants, without a
   separate scheduler.
3. **Degrade instead of shed** — a class whose policy carries a
   :class:`~repro_torch.core.lowering.DegradePolicy` is *degraded* (routed to
   cheap, already-compiled variants: per-row path, capped buckets, no
   competitive racing) rather than fast-failed, as long as its token
   bucket still has room.

Every decision is surfaced as a :class:`Decision` so the runtime can
record ``admission/...`` metrics and the SLO controller can distinguish
"overloaded and protecting itself" from "missing SLO".

The typed errors (:class:`Overloaded`, :class:`DeadlineExceeded`) live
here so `runtime/`, `serving/`, and callers share one vocabulary; they
are deliberately dependency-free.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Deque, Dict, Optional, Tuple

from repro_torch.core.lowering import DegradePolicy
from repro_torch.obs import keys as okeys
from repro_torch.obs.clock import now as _mono


def _refuse_model(plan, profile) -> None:
    """Refuse a plan + profile: the estimator that would read them is not
    ported, and ignoring them would turn the gate permissive in silence."""
    if plan is not None and profile is not None:
        raise NotImplementedError(
            "admission with a plan and a profile needs the latency "
            "estimator of profiling/, not ported yet (ROADMAP.md §4.3)")


class Overloaded(RuntimeError):
    """Typed fast-fail: the deployment refused this request to protect
    itself (rate limit exceeded, or the critical-path estimate already
    misses the request's deadline)."""

    def __init__(self, msg: str, *, klass: str = "",
                 reason: str = "overload",
                 estimate_s: Optional[float] = None,
                 deadline_s: Optional[float] = None):
        super().__init__(msg)
        self.klass = klass
        self.reason = reason
        self.estimate_s = estimate_s
        self.deadline_s = deadline_s


class DeadlineExceeded(Overloaded):
    """The request's deadline passed while it waited (queue/batch slot):
    it fails fast instead of occupying capacity it can no longer use."""

    def __init__(self, msg: str, *, klass: str = "",
                 deadline_s: Optional[float] = None):
        super().__init__(msg, klass=klass, reason="deadline",
                         deadline_s=deadline_s)


class TokenBucket:
    """Thread-safe token bucket: ``rate`` tokens/s, capacity ``burst``.
    ``rate <= 0`` or ``None`` means unlimited."""

    def __init__(self, rate: Optional[float], burst: Optional[float] = None):
        self.rate = float(rate) if rate else 0.0
        self.burst = float(burst if burst is not None else
                           max(self.rate, 1.0))
        self._tokens = self.burst
        self._t = _mono()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            now = _mono()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


@dataclasses.dataclass(frozen=True)
class ClassPolicy:
    """How one request class is treated at the front door."""
    name: str
    priority: int                    # higher = protected longer
    rate: Optional[float] = None     # token-bucket rate (req/s); None = inf
    burst: Optional[float] = None    # token-bucket capacity
    degrade: Optional[DegradePolicy] = None   # degrade instead of shed
    default_deadline_s: Optional[float] = None


#: the canonical three-class split: interactive is protected, batch rides
#: in the middle, best_effort degrades first and sheds first.
def default_classes() -> Dict[str, ClassPolicy]:
    return {
        "interactive": ClassPolicy("interactive", priority=2,
                                   default_deadline_s=None),
        "batch": ClassPolicy("batch", priority=1),
        "best_effort": ClassPolicy("best_effort", priority=0,
                                   degrade=DegradePolicy()),
    }


@dataclasses.dataclass(frozen=True)
class Decision:
    """What the gate decided for one offered request."""
    action: str                      # "admit" | "degrade" | "shed"
    klass: str
    reason: str = "ok"               # "ok"|"rate_limit"|"deadline_risk"
    estimate_s: Optional[float] = None
    deadline_s: Optional[float] = None
    degrade: Optional[DegradePolicy] = None

    @property
    def admitted(self) -> bool:
        return self.action != "shed"


class AdmissionController:
    """The gate ``Runtime.call_dag`` consults before accepting a request.

    Stateless with respect to the runtime: it holds the plan + profile +
    config the deployment currently runs (refreshed via :meth:`update`
    after a replan) and measures per-class arrival rates itself from the
    offered stream.  Estimates are cached for ``reestimate_s`` and
    invalidated when the measured rate moves >10%, so the per-request
    cost is a dict lookup, not a DAG walk.
    """

    def __init__(self, plan=None, profile=None, config=None, *, net=None,
                 classes: Optional[Dict[str, ClassPolicy]] = None,
                 window_s: float = 1.0, reestimate_s: float = 0.25,
                 default_klass: str = "interactive",
                 queue_depth_fn=None, queue_cost_s: float = 0.0):
        self.plan = plan
        self.profile = profile
        self.config = config
        self.net = net
        self.classes = dict(classes) if classes else default_classes()
        self.window_s = float(window_s)
        self.reestimate_s = float(reestimate_s)
        self.default_klass = default_klass
        # leading overload indicator: live executor backlog.  The M/M/c
        # estimate is a steady-state model fed by a windowed arrival rate,
        # so it lags a burst (and a replica failure that shrinks capacity)
        # by up to window_s; the queue it leaves behind is visible NOW.
        # queue_cost_s is the modeled per-queued-item drain cost — when
        # 0 it is derived from the profile's bottleneck service time.
        self.queue_depth_fn = queue_depth_fn
        self.queue_cost_s = float(queue_cost_s)
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        for name, pol in self.classes.items():
            if pol.rate:
                self._buckets[name] = TokenBucket(pol.rate, pol.burst)
        self._arrivals: Dict[str, Deque[float]] = \
            collections.defaultdict(collections.deque)
        # (lam_used, p99_s, computed_at) per priority level
        self._est_cache: Dict[int, Tuple[float, float, float]] = {}
        self.counters: Dict[str, int] = collections.defaultdict(int)
        _refuse_model(plan, profile)

    # -- live-state refresh --------------------------------------------------
    def update(self, plan=None, profile=None, config=None) -> None:
        """Point the gate at the model of the NOW-live deployment (called
        after hot-applies and blue/green swaps)."""
        _refuse_model(plan if plan is not None else self.plan,
                      profile if profile is not None else self.profile)
        with self._lock:
            if plan is not None:
                self.plan = plan
            if profile is not None:
                self.profile = profile
            if config is not None:
                self.config = config
            self._est_cache.clear()
            self._btl_cost = None

    def set_class(self, policy: ClassPolicy) -> None:
        with self._lock:
            self.classes[policy.name] = policy
            if policy.rate:
                self._buckets[policy.name] = TokenBucket(policy.rate,
                                                         policy.burst)
            else:
                self._buckets.pop(policy.name, None)

    def policy(self, klass: Optional[str]) -> ClassPolicy:
        name = klass or self.default_klass
        pol = self.classes.get(name)
        if pol is None:
            # unknown classes ride at the bottom: they get best-effort
            # treatment, not a KeyError on the hot path
            pol = ClassPolicy(name, priority=0, degrade=DegradePolicy())
            self.classes[name] = pol
        return pol

    # -- measured arrival rates ----------------------------------------------
    def _note_arrival(self, name: str, now: float) -> None:
        dq = self._arrivals[name]
        dq.append(now)
        cut = now - self.window_s
        while dq and dq[0] < cut:
            dq.popleft()

    def rate_at_or_above(self, priority: int, now: float) -> float:
        """Measured offered rate (req/s) of all classes with priority >=
        ``priority`` — the load a request of that priority competes with."""
        cut = now - self.window_s
        total = 0
        for name, dq in self._arrivals.items():
            if self.classes.get(name, _BOTTOM).priority < priority:
                continue
            while dq and dq[0] < cut:
                dq.popleft()
            total += len(dq)
        return total / max(self.window_s, 1e-9)

    # -- estimator gate ------------------------------------------------------
    def _p99_at(self, priority: int, lam: float, now: float) -> float:
        cached = self._est_cache.get(priority)
        if cached is not None:
            lam0, p99, t0 = cached
            fresh = now - t0 < self.reestimate_s
            close = abs(lam - lam0) <= 0.1 * max(lam0, 1.0)
            if fresh and close:
                return p99
        p99 = self._estimate_p99(lam)
        self._est_cache[priority] = (lam, p99, now)
        return p99

    def _estimate_p99(self, lam: float) -> float:
        # with no plan and profile there is nothing to model against:
        # permissive, as in the reference; with both, refuse
        _refuse_model(self.plan, self.profile)
        return 0.0

    def _queue_penalty(self, now: float) -> float:
        """Extra expected wait implied by the backlog already sitting in
        executor queues: depth × per-item drain cost at the bottleneck.
        Computed OUTSIDE the estimate cache — the backlog moves faster
        than ``reestimate_s`` during exactly the events (bursts, replica
        failures) this signal exists to catch."""
        fn = self.queue_depth_fn
        if fn is None:
            return 0.0
        try:
            depth = int(fn())
        except BaseException:
            return 0.0
        if depth <= 0:
            return 0.0
        cost = self.queue_cost_s
        if cost <= 0.0:
            cost = self._bottleneck_cost_s()
        return depth * cost

    def _bottleneck_cost_s(self) -> float:
        """Per-queued-item drain cost: the slowest op's mean service time
        divided by its replica count (the pool drains the backlog at the
        bottleneck's aggregate rate).  Cached — the plan only changes via
        ``update``, which clears it."""
        cached = getattr(self, "_btl_cost", None)
        if cached is not None:
            return cached
        _refuse_model(self.plan, self.profile)
        cost = 1e-3              # permissive floor with nothing to model
        self._btl_cost = cost
        return cost

    # -- the gate ------------------------------------------------------------
    def admit(self, klass: Optional[str] = None,
              deadline_s: Optional[float] = None) -> Decision:
        """Decide one offered request.  Never raises — the caller turns a
        shed Decision into a typed :class:`Overloaded` failure."""
        now = _mono()
        pol = self.policy(klass)
        name = pol.name
        if deadline_s is None:
            deadline_s = pol.default_deadline_s
        with self._lock:
            self.counters[okeys.gate_counter(name, "offered")] += 1
            bucket = self._buckets.get(name)
            if bucket is not None and not bucket.try_take():
                self.counters[okeys.gate_counter(name, "shed")] += 1
                return Decision("shed", name, "rate_limit",
                                deadline_s=deadline_s)
            self._note_arrival(name, now)
            est = None
            if deadline_s is not None:
                lam = self.rate_at_or_above(pol.priority, now)
                penalty = self._queue_penalty(now)
                est = self._p99_at(pol.priority, lam, now) + penalty
                if est > deadline_s:
                    reason = ("queue_depth"
                              if penalty > 0.0
                              and est - penalty <= deadline_s
                              else "deadline_risk")
                    if pol.degrade is not None:
                        self.counters[okeys.gate_counter(name, "degraded")] += 1
                        return Decision("degrade", name, reason,
                                        estimate_s=est,
                                        deadline_s=deadline_s,
                                        degrade=pol.degrade)
                    self.counters[okeys.gate_counter(name, "shed")] += 1
                    return Decision("shed", name, reason,
                                    estimate_s=est, deadline_s=deadline_s)
            self.counters[okeys.gate_counter(name, "admitted")] += 1
            return Decision("admit", name, "ok", estimate_s=est,
                            deadline_s=deadline_s)

    def note_hedge(self, klass: Optional[str] = None,
                   deadline_s: Optional[float] = None) -> bool:
        """A straggler hedge is OFFERED LOAD: it occupies a replica like
        any request.  The runtime announces each would-be hedge here; the
        gate counts it into the class's arrival window and answers
        whether there is headroom for it.  False suppresses the hedge —
        under overload a backup dispatch only amplifies the queue the
        primary is already stuck in."""
        now = _mono()
        pol = self.policy(klass)
        name = pol.name
        with self._lock:
            self.counters[okeys.gate_counter(name, "hedge_offered")] += 1
            self._note_arrival(name, now)
            if deadline_s is None:
                deadline_s = pol.default_deadline_s
            if deadline_s is not None:
                lam = self.rate_at_or_above(pol.priority, now)
                est = self._p99_at(pol.priority, lam, now) \
                    + self._queue_penalty(now)
                if est > deadline_s:
                    self.counters[okeys.gate_counter(name, "hedge_suppressed")] += 1
                    return False
            self.counters[okeys.gate_counter(name, "hedge_admitted")] += 1
            return True

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)


_BOTTOM = ClassPolicy("_bottom", priority=-(10 ** 9))
