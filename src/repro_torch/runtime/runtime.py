"""The runtime facade: scheduler + client (Cloudburst analogue).  Port of
the reference package's ``runtime/runtime.py``.

Scheduling policy (paper §2.3/§4):
* partition executors by resource class; per-function replica assignment
* locality-aware: prefer an executor whose cache holds the request's ref
  (dynamic dispatch: the ref is resolved by the *to-be-continued* half of a
  split DAG and fed back to the scheduler before the continuation is placed)
* wait-for-any: anyof nodes fire on the first completed upstream
* batching: batch-aware functions are fed buckets via a per-function Batcher

``Runtime`` owns an explicit ``device`` (the CUDA device unless the caller
names another; it raises without a card) onto which compiled flows lower
their chains.  Everything else is the reference's: admission and
deadlines, request batching with host and device-resident demux, fault
injection and detection, retries, hedging, tracing, histogram metrics and
blue/green generations.  What the card changes is written where it is
handled:

* the wedge detector and long GPU calls: ``runtime/executor.py``;
* batch composition depends on timing: ``_dispatch_batched``;
* a device-resident batch returns before its device work ends, and the
  re-run of a device item: the device branch of ``_make_batch_fn``'s
  demux and the pinned branch of ``dispatch``;
* degraded requests bypass the batcher: ``dispatch``.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.lowering import (DEFAULT_BUCKETS, DegradePolicy,
                                       bucket_rows)
from repro_torch.core.table import DeviceTable, Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import keys as okeys
from repro_torch.obs.clock import now as _mono
from repro_torch.obs.metrics import (Histogram, HistogramSnapshot,
                                     WindowedCounter)
from repro_torch.obs.trace import Trace, Tracer, prepare_profiler
from repro_torch.runtime.dag import RuntimeDag, RuntimeNode
from repro_torch.runtime.executor import ExecutorPool, WorkItem
from repro_torch.runtime.kvs import KVS
from repro_torch.runtime.netmodel import NetModel
from repro_torch.serving.admission import (AdmissionController,
                                           DeadlineExceeded, Overloaded)
from repro_torch.serving.batcher import Batcher
from repro_torch.serving.faults import FaultInjector, FaultPlan
from repro_torch.serving.retry import (CompletionToken, ExecutorLost,
                                       RetryPolicy)

_req_ids = itertools.count()


def _attempt_attrs(log) -> Dict[str, Any]:
    """Summarize a WorkItem's shared attempt log (executor-side start /
    cancelled / requeue / done entries, shared across retry and hedge
    clones) into exec-span attributes."""
    attrs: Dict[str, Any] = {
        "attempts": sum(1 for e in log if e[0] == "start"),
        "cancelled": sum(1 for e in log if e[0] == "cancelled"),
        "requeues": sum(1 for e in log if e[0] == "requeue"),
    }
    return attrs


def _trace_exec_events(tr: Trace, node_name: str, log) -> None:
    """Replay loser/requeue entries from an attempt log onto the trace as
    zero-duration spans at their ORIGINAL timestamps (the callback fires
    once, after the winner — these happened earlier)."""
    for e in log:
        if e[0] == "cancelled":
            tr.span(f"cancelled@{node_name}", e[2], e[2], executor=e[1])
        elif e[0] == "requeue":
            tr.span(f"requeue@{node_name}", e[2], e[2], executor=e[1])
            tr.retried = True


def _exec_span_cb(tr: Trace, node_name: str, item, cb,
                  t_enq: float, link: Optional[int] = None):
    """Wrap a dispatch callback to close an ``exec@node`` span when the
    result (or error) is delivered: covers executor queue wait + service
    time + any retry/hedge overhead, with the measured split in attrs."""
    def wrapped(result, error, exec_id):
        t1 = _mono()
        log = list(item.attempt_log)
        attrs = _attempt_attrs(log)
        attrs["executor"] = exec_id
        done = None
        for e in log:
            if e[0] == "done" and e[1] == exec_id:
                done = e
        if done is not None:
            attrs["queue_s"] = done[3]
            attrs["exec_s"] = done[4]
            if done[5]:
                attrs["copies"] = done[5]
        if error is not None:
            attrs["error"] = type(error).__name__
        _trace_exec_events(tr, node_name, log)
        tr.span(f"exec@{node_name}", t_enq, t1, link=link, **attrs)
        if done is not None and done[6]:
            tr.spans.extend(done[6])
        cb(result, error, exec_id)
    return wrapped


@dataclasses.dataclass
class RequestContext:
    """Per-request overload-protection state, carried from ``call_dag``
    through node dispatch, batching, and executor queues."""
    klass: str = "interactive"
    deadline_t: Optional[float] = None    # absolute perf_counter deadline
    deadline_s: Optional[float] = None    # the caller's relative budget
    degrade: Optional[DegradePolicy] = None   # set when admitted degraded
    # idempotence: per-request id, part of every dispatched item's
    # ``dispatch_key`` so at-least-once redispatch can't double-apply
    req_id: Optional[int] = None
    # the request's live trace (None when tracing is disabled or the
    # request is synthetic); instrumentation sites gate on it
    trace: Optional[Trace] = None


class Runtime:
    def __init__(self, *, n_cpu: int = 4, n_gpu: int = 0,
                 net: Optional[NetModel] = None,
                 cache_bytes: int = 2 << 30,
                 max_batch: int = 10, batch_wait_ms: float = 2.0,
                 seed: int = 0,
                 reserved_cpu: int = 0, reserved_gpu: int = 0,
                 fault_plan: Optional[FaultPlan] = None,
                 hang_timeout_s: float = 5.0,
                 detector_interval_s: float = 0.05,
                 auto_replace: bool = True,
                 retry_policies: Optional[Dict[str, RetryPolicy]] = None,
                 tracer: Optional[Tracer] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.net = net or NetModel()
        # tracing defaults to tail-keep only (sample_rate=0): nothing is
        # retained unless a request sheds/errors/misses/retries.  Pass
        # Tracer(enabled=False) to strip even the per-request span
        # recording, or a higher sample_rate to also keep healthy traces.
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=True, sample_rate=0.0)
        # a caller's own tracer on the card: a device trace may be taken
        # while it serves, so the profiler's imports are made here
        if tracer is not None and tracer.enabled and \
                self.device.type == "cuda":
            prepare_profiler()
        self.kvs = KVS(self.net)
        injector = FaultInjector(fault_plan) if fault_plan is not None \
            else None
        self.pool = ExecutorPool(self.kvs, self.net, n_cpu=n_cpu, n_gpu=n_gpu,
                                 cache_bytes=cache_bytes,
                                 reserved_cpu=reserved_cpu,
                                 reserved_gpu=reserved_gpu,
                                 fault_injector=injector,
                                 hang_timeout_s=hang_timeout_s,
                                 auto_replace=auto_replace,
                                 on_fault=self._on_fault)
        # heartbeat failure detector: always on — a crashed or wedged
        # executor must never strand in-flight items, fault plan or not.
        # On the card a legitimate call can outlast the default
        # hang_timeout_s (see runtime/executor.py): serving a full-width
        # model, the caller sets it above the slowest call
        self.detector_interval_s = detector_interval_s
        self.pool.start_failure_detector(interval_s=detector_interval_s)
        # per-class transient-retry policies ("default" backs all classes
        # without an explicit entry); deadline-budget-aware backoff
        self._retry_policies: Dict[str, RetryPolicy] = \
            dict(retry_policies) if retry_policies else {}
        self._retry_policies.setdefault("default", RetryPolicy())
        self._retry_rng = random.Random(seed ^ 0x5EED)
        # straggler hedging: (dag name, node name) -> hedge delay seconds
        # (profile-derived via serving.faults.install_hedging, or set
        # directly with configure_hedging); absent = hedging off
        self._hedge_delays: Dict[Tuple[str, str], float] = {}
        # per-dag admission gates (set_admission); None = accept everything
        self._admission: Dict[str, AdmissionController] = {}
        self.dags: Dict[str, RuntimeDag] = {}
        self.plans: Dict[str, Any] = {}     # dag name -> PhysicalPlan
        self.max_batch = max_batch
        self.batch_wait_ms = batch_wait_ms
        # deployment state is keyed per GENERATION: two registered DAGs
        # sharing a node name (or the blue and green generation of one
        # DAG mid-swap) must never share a Batcher — its batch fn is a
        # closure over one generation's nodes, so a shared entry would run
        # the other deployment's captured code
        self._batchers: Dict[Tuple[str, int, str], Batcher] = {}
        self._batchers_lock = threading.Lock()
        self._retired_batchers: List[Batcher] = []
        self._rng = random.Random(seed)
        # metrics are appended from executor callback threads and read by
        # the SLO controller: every access goes through _metrics_lock so
        # snapshots are consistent (do not mutate self.metrics directly —
        # use record_metric / metrics_snapshot)
        self.metrics: Dict[str, List[float]] = {}
        self._metrics_lock = threading.Lock()
        # bounded parallel stores fed by record_metric: rate-valued *_t
        # series (values ARE event timestamps) into windowed counters,
        # everything else into log-bucketed mergeable histograms —
        # constant-memory, O(1)-record views the controller can read
        # without copying raw series
        self._hists: Dict[str, Histogram] = {}
        self._counters: Dict[str, WindowedCounter] = {}
        # per-node batching overrides (SLO optimizer PlanConfig), keyed
        # (dag name, node name) — LOGICAL, not per generation: a replanned
        # green generation inherits the hot-applied knobs of matching
        # nodes.  Consulted at batcher creation, hot-applied to the live
        # generation's batchers
        self._node_batch_cfg: Dict[Tuple[str, str], Dict[str, float]] = {}
        # generation lifecycle: in-flight request counts per
        # (dag name, generation); a superseded generation drains — its
        # in-flight executions finish on their own nodes/batchers — and
        # its batchers are retired only once the count hits zero
        self._gen_counter = itertools.count(1)
        self._inflight: Dict[Tuple[str, int], int] = {}
        self._draining: set = set()
        # generations whose batchers were already retired: a straggler
        # execution that creates a fresh batcher under a retired key gets
        # it re-retired on completion.  A PREPARED (never-registered)
        # generation is in neither set — its batchers persist, warm,
        # until the swap makes them the live ones.
        self._retired_gens: set = set()
        self._lifecycle_lock = threading.Lock()

    # -- registration / generation lifecycle ----------------------------------
    def prepare_dag(self, dag: RuntimeDag) -> RuntimeDag:
        """Validate ``dag`` and assign it a deployment generation WITHOUT
        routing any traffic to it.  A prepared dag can be driven directly
        via :meth:`call_dag_object` (warm-up, canary verification) and
        owns generation-keyed runtime state (batchers) from the start —
        the blue/green replanner's pre-swap phase."""
        dag.validate()
        if dag.generation == 0:
            dag.generation = next(self._gen_counter)
        return dag

    def register_dag(self, dag: RuntimeDag, plan=None):
        """Register (or atomically swap in) a runtime DAG; ``plan`` (the
        PhysicalPlan it was lowered from) is kept for introspection and
        bucket retuning.  Re-registering under an existing name is a
        blue/green generation swap: new ``call_dag`` requests route to the
        new generation immediately, in-flight executions finish on the old
        generation's nodes and batchers, and the old generation's batchers
        are retired once its last in-flight request completes — then
        closed when they are quiescent (no queued items, no active
        flush)."""
        self.prepare_dag(dag)
        old = self.dags.get(dag.name)
        with self._lifecycle_lock:
            # re-activating a previously swapped-out generation
            # (swap-back/rollback) must clear BOTH lifecycle marks: left
            # in _retired_gens its fresh batchers would be re-retired
            # after every request; left in _draining, the drain-to-zero
            # of its pre-swap in-flight requests would retire the now
            # LIVE generation's batchers out from under traffic.
            # Cleared BEFORE the registry write — a request completing
            # between publish and clear would re-retire the live
            # generation through the stale marks.
            self._retired_gens.discard((dag.name, dag.generation))
            self._draining.discard((dag.name, dag.generation))
        # the swap: a single dict assignment — call_dag reads the mapping
        # once per request, so every request runs entirely on one
        # generation (the GIL makes the read/replace atomic)
        self.dags[dag.name] = dag
        if plan is not None:
            self.plans[dag.name] = plan
        if old is not None and old is not dag:
            key = (old.name, old.generation)
            with self._lifecycle_lock:
                busy = self._inflight.get(key, 0) > 0
                if busy:
                    self._draining.add(key)
            if not busy:
                self._retire_generation(*key)
        self.sweep_retired()

    def register_plan(self, plan, name: str) -> RuntimeDag:
        """Lower a ``PhysicalPlan`` and register it in one step."""
        dag = RuntimeDag.from_plan(plan, name)
        self.register_dag(dag, plan=plan)
        return dag

    def _retire_generation(self, dag_name: str, generation: int) -> None:
        """Move a superseded generation's batchers out of the live table;
        they drain whatever they still hold and are closed by the sweep."""
        with self._lifecycle_lock:
            self._retired_gens.add((dag_name, generation))
        with self._batchers_lock:
            keys = [k for k in self._batchers
                    if k[0] == dag_name and k[1] == generation]
            for k in keys:
                self._retired_batchers.append(self._batchers.pop(k))

    def discard_dag(self, dag: RuntimeDag) -> None:
        """Discard a PREPARED generation that will never serve (an
        aborted blue/green replan): retire its batchers — created by
        warm-up/canary traffic — so their threads are closed by the sweep
        instead of leaking, and mark the generation retired so any
        straggler execution re-retires what it creates.  A registered
        generation must be superseded via ``register_dag``, not
        discarded."""
        if self.dags.get(dag.name) is dag:
            raise ValueError(f"{dag.name} gen {dag.generation} is live; "
                             "swap it out via register_dag instead")
        self._retire_generation(dag.name, dag.generation)
        self.sweep_retired()

    def sweep_retired(self) -> int:
        """Close retired batchers that have fully drained — queue empty
        AND no flush in progress (``Batcher.quiescent``; ``q.empty()``
        alone races with an active flush whose popped items are still
        live).  Returns how many are still draining.  Bounds thread
        leakage across repeated re-registrations."""
        with self._batchers_lock:
            still, done = [], []
            for b in self._retired_batchers:
                (done if b.quiescent() else still).append(b)
            self._retired_batchers = still
        for b in done:
            b.close()
        return len(still)

    def _track_execution(self, dag: RuntimeDag, fut: Future) -> None:
        """Count an execution against its generation; when a DRAINING (or
        already-superseded) generation's count reaches zero, retire its
        batchers."""
        key = (dag.name, dag.generation)
        with self._lifecycle_lock:
            self._inflight[key] = self._inflight.get(key, 0) + 1

        def _done(_f: Future):
            retire = False
            with self._lifecycle_lock:
                n = self._inflight.get(key, 1) - 1
                if n <= 0:
                    self._inflight.pop(key, None)
                    # superseded generation fully drained — or a batcher
                    # created by a straggler execution AFTER its
                    # generation was retired.  (A PREPARED, never-swapped
                    # generation is in neither set: its warm batchers
                    # survive until the swap makes them live.)
                    if key in self._draining or key in self._retired_gens:
                        self._draining.discard(key)
                        retire = True
                else:
                    self._inflight[key] = n
            if retire:
                self._retire_generation(*key)
                self.sweep_retired()
        fut.add_done_callback(_done)

    # -- scheduling -------------------------------------------------------------
    def pick_executor(self, node: RuntimeNode,
                      locality_key: Optional[str] = None,
                      prefer_reserved: bool = False):
        if prefer_reserved:
            # warm-up/canary work for a not-yet-live generation: the
            # reserved pool (when provisioned) keeps it off the serving
            # workers, so a saturated serving pool can't starve a canary
            rsvd = self.pool.by_class(node.resource_class, reserved=True)
            if rsvd:
                return min(rsvd, key=lambda e: e.load)
        cands = self.pool.candidates(node.name, node.resource_class)
        if not cands:
            raise RuntimeError(
                f"no executors for class {node.resource_class!r}")
        if locality_key is not None:
            cached = self.kvs.cached_where(locality_key)
            local = [e for e in cands if e.id in cached]
            if local:
                return min(local, key=lambda e: e.load)
        lo = min(e.load for e in cands)
        best = [e for e in cands if e.load == lo]
        return self._rng.choice(best)

    def _is_prepared(self, dag: Optional[RuntimeDag]) -> bool:
        """True for a generation that is NOT the live one for its name —
        i.e. warm-up/canary traffic (pre-swap green).  Checked at dispatch
        time, not batcher creation: the same batcher keeps serving after
        the swap makes its generation live."""
        return dag is not None and self.dags.get(dag.name) is not dag

    def dispatch(self, node: RuntimeNode, tables: List[Table],
                 produced_on: List[Optional[str]], callback,
                 locality_key: Optional[str] = None,
                 dag: Optional[RuntimeDag] = None,
                 ctx: Optional[RequestContext] = None):
        if node.batching and (ctx is None or ctx.degrade is None):
            self._dispatch_batched(node, tables, produced_on, callback,
                                   locality_key, dag, ctx)
            return
        # degraded requests bypass the batcher entirely: merging them
        # would degrade their batch-mates, and the per-row executable the
        # DegradePolicy routes to needs no coalescing anyway.  The policy
        # rides the WorkItem and the executor applies it around the fn
        # (degraded_execution is thread-local: it must be set on the
        # worker thread, where BatchedJittedFuse's router reads it)
        # a device-resident input lives in its producer's device
        # memory: the consumer MUST run there — shipping the batch to
        # another executor would be exactly the host round-trip (or
        # cross-device copy) the residency analysis eliminated, and would
        # invalidate buffer donation
        ex = None
        pinned = False
        for t, src in zip(tables, produced_on):
            if isinstance(t, DeviceTable) and src is not None:
                ex = self.pool.by_id(src)
                pinned = ex is not None
                break
        if ex is None:
            ex = self.pick_executor(node, locality_key,
                                    prefer_reserved=self._is_prepared(dag))
        key = None
        if ctx is not None and ctx.req_id is not None:
            key = (ctx.req_id, node.name)
        tr = ctx.trace if ctx is not None else None
        item = WorkItem(fn=node.fn, tables=tables,
                        produced_on=produced_on, callback=callback,
                        deadline_t=ctx.deadline_t if ctx else None,
                        degrade=ctx.degrade if ctx else None,
                        dispatch_key=key, traced=tr is not None)
        if tr is not None:
            item.callback = _exec_span_cb(tr, node.name, item, callback,
                                          _mono())
        if pinned:
            # pinned to the producer's device: redispatching elsewhere
            # would lose the resident buffers, so no retry/hedge — the
            # failure detector still recovers the item if the pinned
            # worker dies.  On the card every GPU worker shares one CUDA
            # context, so the DeviceTable stays valid on the replica the
            # requeue picks; the rule is kept anyway.  A requeued run
            # reads the same tensors again: correct only because the
            # decode step clones the KV cache instead of writing it in
            # place (ROADMAP.md, in-place KV-cache writes)
            try:
                ex.submit(item)
            except RuntimeError as e:
                item.deliver(None, ExecutorLost(str(e)), None)
            return
        self._submit_resilient(node, ex, item, ctx,
                               dag_name=dag.name if dag is not None else "")

    #: per-series retention: enough history for any rate/percentile window
    #: the controller uses, while keeping snapshot cost and memory constant
    #: under long-running traffic (series are trimmed amortized, at 2x)
    METRIC_SERIES_CAP = 4096

    def record_metric(self, key: str, value: float):
        with self._metrics_lock:
            series = self.metrics.setdefault(key, [])
            series.append(value)
            if len(series) >= 2 * self.METRIC_SERIES_CAP:
                del series[:-self.METRIC_SERIES_CAP]
            # bounded dual store: *_t series are event-timestamp streams
            # (rate-valued) -> windowed counter binned by the stamp;
            # everything else is value-distributed -> histogram
            if key.endswith("_t"):
                c = self._counters.get(key)
                if c is None:
                    c = self._counters[key] = WindowedCounter()
                c.note(value)
            else:
                h = self._hists.get(key)
                if h is None:
                    h = self._hists[key] = Histogram()
                h.record(value)

    def metrics_snapshot(self, prefix=None) -> Dict[str, List[float]]:
        """A consistent copy of metric series (the controller reads this
        while executor callbacks keep appending).  ``prefix`` — a string
        or tuple of strings — restricts the copy to matching keys, which
        keeps the lock hold (and the stall writers see) proportional to
        what the reader actually consumes instead of every series ever
        recorded."""
        with self._metrics_lock:
            if prefix is None:
                return {k: list(v) for k, v in self.metrics.items()}
            return {k: list(v) for k, v in self.metrics.items()
                    if k.startswith(prefix)}

    def metric_histogram(self, key: str) -> Optional[HistogramSnapshot]:
        """Mergeable snapshot of a value-distributed series' histogram
        (None if the key was never recorded)."""
        with self._metrics_lock:
            h = self._hists.get(key)
            return h.snapshot() if h is not None else None

    def metric_rate(self, key: str, window_s: float,
                    now: Optional[float] = None) -> float:
        """Events/sec for a ``*_t`` series over the trailing window, read
        from the windowed counter (no series scan, no copy)."""
        with self._metrics_lock:
            c = self._counters.get(key)
            if c is None:
                return 0.0
            return c.rate(window_s, now if now is not None else _mono())

    # -- fault tolerance ------------------------------------------------------
    def _on_fault(self, kind: str, executor_id: str, n_requeued: int):
        """Failure-detector hook: surface crash/wedge events and requeue
        volume as metric series (timestamps, like every *_t series) the
        SLO controller folds into ``fault_rate`` — kept SEPARATE from
        ``error_t``: a recovered fault is not a request failure."""
        now = _mono()
        self.record_metric(okeys.fault(kind), now)
        for _ in range(n_requeued):
            self.record_metric(okeys.FAULT_REQUEUED, now)

    def set_fault_plan(self, plan: Optional[FaultPlan]) -> \
            Optional[FaultInjector]:
        """Install (or clear, with None) a fault-injection plan on every
        executor — the chaos benchmark sweeps rates this way.  Returns
        the live injector so callers can read its counts."""
        injector = FaultInjector(plan) if plan is not None else None
        self.pool.set_injector(injector)
        return injector

    def configure_hedging(self, dag_name: str, node_name: str,
                          delay_s: Optional[float]) -> None:
        """Set (or clear, with None) a node's straggler-hedge delay: once
        a dispatch has been out this long with no result, a backup copy
        is raced on another replica, first-result-wins.  Derive delays
        from measured curves with ``serving.faults.install_hedging``."""
        if delay_s is None:
            self._hedge_delays.pop((dag_name, node_name), None)
        else:
            self._hedge_delays[(dag_name, node_name)] = float(delay_s)

    def _submit_resilient(self, node: RuntimeNode, target, item: WorkItem,
                          ctx: Optional[RequestContext],
                          dag_name: str = "",
                          traces: Optional[List[Trace]] = None) -> None:
        """Submit with the fault-tolerance wrapper:

        * **completion token** — every attempt (original, crash requeue,
          hedge, retry) of the logical item delivers at most once;
        * **transient retries** — a typed transient failure redispatches
          to another replica with capped jittered backoff, never past the
          request's deadline budget;
        * **straggler hedging** — if a hedge delay is configured for this
          node (profile-derived p99), a backup dispatch races the primary
          after that delay; the loser is cancelled by the token.  Hedges
          are announced to the admission gate as offered load and are
          suppressed when the gate sees no headroom, so hedging cannot
          amplify an overload.  Nodes in a competitive group are never
          hedged — competitive execution already races replicas.
        """
        klass = ctx.klass if ctx is not None else "interactive"
        deadline_s = ctx.deadline_s if ctx is not None else None
        if traces is None:
            traces = [ctx.trace] if ctx is not None \
                and ctx.trace is not None else []
        policy = self._retry_policies.get(
            klass, self._retry_policies["default"])
        hedge_delay = self._hedge_delays.get((dag_name, node.name))
        if node.competitive_group is not None:
            hedge_delay = None
        final_cb = item.callback

        def attempt_submit(work: WorkItem, ex) -> None:
            timers: List[threading.Timer] = []

            def guard(result, error, exec_id):
                for t in timers:
                    t.cancel()
                if error is not None:
                    delay = policy.next_delay(
                        work.attempt, error, _mono(),
                        deadline_t=work.deadline_t, rng=self._retry_rng)
                    if delay is not None:
                        if dag_name:
                            self.record_metric(
                                okeys.dag(dag_name, "retry_t"), _mono())
                        for tr in traces:
                            tr.event(f"retry@{node.name}",
                                     attempt=work.attempt + 1,
                                     delay_s=delay,
                                     cause=type(error).__name__)
                        nxt = work.clone()
                        nxt.token = CompletionToken()
                        nxt.attempt = work.attempt + 1

                        def fire_retry():
                            try:
                                t2 = self.pick_executor(node)
                                attempt_submit(nxt, t2)
                            except BaseException as e:
                                if nxt.token.claim(None):
                                    final_cb(None, e, None)
                        rt_t = threading.Timer(delay, fire_retry)
                        rt_t.daemon = True
                        rt_t.start()
                        return
                final_cb(result, error, exec_id)

            work.callback = guard
            if hedge_delay is not None:
                def fire_hedge():
                    if work.token.claimed:
                        return
                    adm = self._admission.get(dag_name)
                    if adm is not None and not adm.note_hedge(
                            klass, deadline_s=deadline_s):
                        # no headroom: a hedge now would amplify the
                        # overload the gate is defusing
                        return
                    others = [e for e in self.pool.candidates(
                                  node.name, node.resource_class)
                              if e.id != ex.id]
                    if not others:
                        return
                    if dag_name:
                        self.record_metric(
                            okeys.dag(dag_name, "hedge_t"), _mono())
                    for tr in traces:
                        tr.event(f"hedge_launch@{node.name}",
                                 delay_s=hedge_delay)
                    try:
                        # shared token: first result wins, loser cancelled
                        min(others, key=lambda e: e.load).submit(
                            work.clone())
                    except RuntimeError:
                        pass
                hg_t = threading.Timer(hedge_delay, fire_hedge)
                hg_t.daemon = True
                timers.append(hg_t)
                hg_t.start()
            try:
                ex.submit(work)
            except RuntimeError as e:
                # stopped between pick and submit: count it as a
                # transient executor loss so the retry path re-picks
                work.deliver(None, ExecutorLost(str(e)), None)

        attempt_submit(item, target)

    # -- online reconfiguration (SLO controller hot-apply) --------------------
    def batcher_for(self, dag_name: str, node_name: str,
                    generation: Optional[int] = None) -> Optional[Batcher]:
        """The live Batcher serving ``(dag, node)`` — by default the
        currently registered generation's."""
        if generation is None:
            dag = self.dags.get(dag_name)
            if dag is None:
                return None
            generation = dag.generation
        with self._batchers_lock:
            return self._batchers.get((dag_name, generation, node_name))

    def configure_batching(self, dag_name: str, node_name: str, *,
                           max_batch: Optional[int] = None,
                           batch_wait_ms: Optional[float] = None) -> bool:
        """Set a node's batching knobs — applied to its LIVE batcher (the
        batch loop reads them per iteration) and remembered for batchers
        created later.  The config is keyed logically (dag, node), so a
        replanned green generation inherits it where node names match.
        Pure control plane: no re-registration, no executable re-trace.
        Returns True if anything changed."""
        cfg = self._node_batch_cfg.setdefault((dag_name, node_name), {})
        changed = False
        if max_batch is not None and cfg.get("max_batch") != int(max_batch):
            cfg["max_batch"] = int(max_batch)
            changed = True
        if batch_wait_ms is not None and \
                cfg.get("batch_wait_ms") != float(batch_wait_ms):
            cfg["batch_wait_ms"] = float(batch_wait_ms)
            changed = True
        b = self.batcher_for(dag_name, node_name)
        if b is not None and changed:
            b.reconfigure(max_batch=cfg.get("max_batch"),
                          max_wait_ms=cfg.get("batch_wait_ms"))
        return changed

    def set_node_buckets(self, dag_name: str, node_name: str,
                         buckets) -> None:
        """Retune a deployed node's batch padding buckets in place (the
        ChainProfile-driven bucket auto-tuning): updates the runtime
        node's annotation and the lowered op's ``bucket_sizes``.  Already
        compiled bucket shapes keep hitting the executable cache; a new
        bucket compiles lazily on first use."""
        dag = self.dags[dag_name]
        node = dag.nodes[node_name]
        node.batch_buckets = tuple(buckets)
        plan = self.plans.get(dag_name)
        if plan is not None and node.plan_op_id is not None:
            op = plan.op(node.plan_op_id).op
            if hasattr(op, "bucket_sizes"):
                op.bucket_sizes = tuple(buckets)

    def _dispatch_batched(self, node: RuntimeNode, tables, produced_on,
                          callback, locality_key: Optional[str] = None,
                          dag: Optional[RuntimeDag] = None,
                          ctx: Optional[RequestContext] = None):
        """Queue one request into the node's batcher.  The batch function
        issues ONE executor submission per batch — a single batched
        dispatch when the node lowered to a ``BatchedJittedFuse``
        (``node.batched_fn``) — and demultiplexes results back to each
        request's callback from the executor callback (no per-request
        waiter threads).  Batchers are keyed ``(dag, generation, node)``:
        two DAGs sharing a node name — or two generations of one DAG mid
        blue/green swap — never share a batcher, whose batch fn captured
        exactly one generation's node closure.

        How a burst is cut into batches depends on timing: the batcher's
        adaptive wait follows the measured arrival gaps, and a flush
        starts when its window closes.  Nothing may assume a cut; read it
        from the tracer (``Tracer.batch_spans()``: id, size, bucket; each
        member's ``exec@`` span links to its batch id)."""
        dag_name = dag.name if dag is not None else ""
        generation = dag.generation if dag is not None else 0
        key = (dag_name, generation, node.name)
        with self._batchers_lock:
            # creation must be atomic: two concurrent first-dispatches used
            # to each build a Batcher, and the loser's requests ran outside
            # the shared queue (phantom batches, skewed histograms)
            b = self._batchers.get(key)
            if b is None:
                cfg = self._node_batch_cfg.get((dag_name, node.name), {})
                mkey = okeys.batch_prefix(dag_name, node.name)

                def _drop(args, err, _mkey=mkey, _node=node.name):
                    # a submit can slip in between the sweep's quiescence
                    # check and close() — the drained item's request
                    # callback must still fire, or its future would hang
                    # forever (nobody waits on Batcher item events here).
                    # Deadline expiries land here too; count them.
                    if isinstance(err, DeadlineExceeded):
                        self.record_metric(okeys.batch(_mkey, "expired_t"),
                                           _mono())
                    d_ctx = args[4]
                    if d_ctx is not None and d_ctx.trace is not None:
                        # the request died waiting in the batcher: close
                        # the queue span so attribution sees the wait
                        d_ctx.trace.span(f"queue@{_node}", args[5],
                                         dropped=type(err).__name__)
                    args[2](None, err, None)

                b = Batcher(self._make_batch_fn(node, dag_name, dag),
                            max_batch=int(cfg.get("max_batch",
                                                  self.max_batch)),
                            max_wait_ms=float(cfg.get("batch_wait_ms",
                                                      self.batch_wait_ms)),
                            on_drop=_drop)
                self._batchers[key] = b
        try:
            b.submit((tables, produced_on, callback, locality_key, ctx,
                      _mono()),
                     deadline_t=ctx.deadline_t if ctx else None)
        except RuntimeError as e:       # closed under our feet (stop())
            callback(None, e, None)

    def _make_batch_fn(self, node: RuntimeNode, dag_name: str = "",
                       dag: Optional[RuntimeDag] = None):
        def batched(arg_list):
            # merge all request tables into one invocation (paper §4)
            live = []
            for entry in arg_list:
                ts, po, cb, lk, _ctx, _tq = entry
                if not ts:
                    # a request with no input tables can't join the merge;
                    # fail it alone instead of crashing the whole batch
                    cb(None, ValueError(
                        f"{node.name}: batched dispatch needs >=1 table"),
                        None)
                else:
                    live.append(entry)
            if not live:
                return [None] * len(arg_list)
            try:
                # template carries schema/grouping; zero total rows is fine
                # — the fn sees an empty table, returns an empty result
                template = live[0][0][0]
                big = template.with_rows(
                    [r for ts, _, _, _, _, _ in live for t in ts
                     for r in t.rows])
                # locality: any request's resolved ref steers the whole
                # batch (members share the node, hence typically the ref)
                lk = next((k for _, _, _, k, _, _ in live
                           if k is not None), None)
                ex = self.pick_executor(
                    node, lk, prefer_reserved=self._is_prepared(dag))
            except BaseException as e:
                # nobody waits on the Batcher items — errors must reach the
                # per-request callbacks, not die in the batch thread
                for _, _, cb, _, _, _ in live:
                    try:
                        cb(None, e, None)
                    except BaseException:
                        pass
                return [None] * len(arg_list)
            fn = node.batched_fn or node.fn
            t_submit = _mono()
            # one id names the merged dispatch everywhere: the dispatch
            # key, the batch-level span, and the link on every member's
            # exec span
            bid = next(_req_ids)
            # batch formation closes each traced member's batcher-wait
            # queue span; EDF reordering of THIS batch is read off the
            # live batcher (the batch fn runs on its flush thread)
            batcher = self.batcher_for(
                dag_name, node.name,
                generation=dag.generation if dag is not None else 0)
            reordered = bool(batcher is not None
                             and batcher.last_reordered)
            traced = [c.trace for _, _, _, _, c, _ in live
                      if c is not None and c.trace is not None]
            for _, _, _, _, c, tq in live:
                if c is not None and c.trace is not None:
                    c.trace.span(f"queue@{node.name}", tq, t_submit,
                                 batch_size=len(big.rows),
                                 reordered=reordered)
            # the merged batch inherits the LOOSEST member deadline: a
            # batch is only pointless once every member's deadline passed
            # (per-member expiry already happened in the Batcher)
            deadlines = [c.deadline_t if c is not None else None
                         for _, _, _, _, c, _ in live]
            batch_deadline = (max(deadlines)
                              if deadlines and None not in deadlines
                              else None)
            # the merged batch is one logical item: its dispatch_key makes
            # KVS writes idempotent and its token makes demux exactly-once
            # across crash requeues / hedges of the whole batch
            item = WorkItem(fn=fn, tables=[big], produced_on=[None],
                            callback=None, deadline_t=batch_deadline,
                            dispatch_key=(dag_name, node.name, bid),
                            traced=bool(traced))

            # metric series are keyed by (dag, node) so two DAGs sharing a
            # node name don't interleave their histograms (generations of
            # one DAG intentionally share a series — the controller reads
            # one continuous signal across a blue/green swap)
            mkey = okeys.batch_prefix(dag_name, node.name)

            def demux(result, error, exec_id):
                t_done = _mono()
                lat = t_done - t_submit
                self.record_metric(okeys.batch(mkey, "size"), len(big.rows))
                self.record_metric(okeys.batch(mkey, "latency_s"), lat)
                if item.exec_s is not None:
                    self.record_metric(okeys.batch(mkey, "exec_s"),
                                       item.exec_s)
                if traced:
                    # ONE batch-level span held by the tracer; every
                    # member's exec span links to it via `bid`
                    log = list(item.attempt_log)
                    base = _attempt_attrs(log)
                    done_e = None
                    for e in log:
                        if e[0] == "done" and e[1] == exec_id:
                            done_e = e
                    if done_e is not None:
                        base["queue_s"] = done_e[3]
                        base["exec_s"] = done_e[4]
                        if done_e[5]:
                            base["copies"] = done_e[5]
                    if error is not None:
                        base["error"] = type(error).__name__
                    scoped = done_e[6] if done_e is not None else None
                    for trc in traced:
                        _trace_exec_events(trc, node.name, log)
                        trc.span(f"exec@{node.name}", t_submit, t_done,
                                 link=bid, executor=exec_id,
                                 batch=len(big.rows), **base)
                        if scoped:
                            trc.spans.extend(scoped)
                    buckets = node.batch_buckets or DEFAULT_BUCKETS
                    self.tracer.record_batch(
                        node.name, t_submit, t_done, bid,
                        dag=dag_name, size=len(big.rows),
                        n_requests=len(live),
                        bucket=bucket_rows(len(big.rows), buckets),
                        reordered=reordered, executor=exec_id)
                if error is not None:
                    for _, _, cb, _, _, _ in live:
                        cb(None, error, exec_id)
                    return
                if isinstance(result, DeviceTable):
                    # device-resident demux: the batch stays on the
                    # device — each request gets a device-side slice
                    # (row positions are preserved through the batched
                    # chain; fused filters only flip mask bits), re-padded
                    # to its bucket so downstream executables keep hitting
                    # cached shapes.  No host copy happens here.  Nor a
                    # synchronise: on the card the producer returned at
                    # launch time, so its exec@ span closed then, and its
                    # device time lands in the consumer's (or this
                    # demux's) span — as with JAX's asynchronous dispatch
                    buckets = node.batch_buckets or DEFAULT_BUCKETS
                    pos = 0
                    for ts, _, cb, _, c, _ in live:
                        k = sum(len(t.rows) for t in ts)
                        span = range(pos, pos + k)
                        pos += k
                        t_d0 = _mono()
                        try:
                            if k == 0:
                                part: Any = Table(result.schema,
                                                  grouping=result.grouping)
                            elif len(live) == 1 and k == result.nrows:
                                # single request spanning the whole batch
                                # (the sparse-traffic norm): nothing to
                                # slice — forward the result as-is
                                part = result
                            else:
                                part = result.take(
                                    span, pad_to=bucket_rows(k, buckets))
                            if isinstance(part, DeviceTable):
                                # the part inherits the producer's
                                # consumer-count analysis (take() marks
                                # every part donatable): with fan-out
                                # downstream, the same part reaches every
                                # consumer — donating it would delete
                                # buffers a sibling still needs
                                part.donatable = result.donatable
                            if c is not None and c.trace is not None:
                                c.trace.span(f"demux@{node.name}", t_d0,
                                             _mono(), rows=k, device=True)
                            cb(part, None, exec_id)
                        except BaseException as e:
                            try:
                                cb(None, e, exec_id)
                            except BaseException:
                                pass
                    return
                # demultiplex: positionally when the fn preserved row count
                # (maps/jitted chains — exact even when requests share
                # row_ids), else by row id with multiset semantics (each
                # result row consumed once, so duplicate ids are neither
                # duplicated nor dropped; absent ids = filtered rows)
                positional = len(result.rows) == len(big.rows)
                by_id: Dict[Any, List] = {}
                if not positional:
                    for r in result.rows:
                        by_id.setdefault(r.row_id, []).append(r)
                pos = 0
                for ts, _, cb, _, c, _ in live:
                    t_d0 = _mono()
                    out_rows = []
                    for t in ts:
                        for r0 in t.rows:
                            if positional:
                                out_rows.append(result.rows[pos])
                                pos += 1
                            else:
                                bucket = by_id.get(r0.row_id)
                                if bucket:
                                    out_rows.append(bucket.pop(0))
                    if c is not None and c.trace is not None:
                        c.trace.span(f"demux@{node.name}", t_d0, _mono(),
                                     rows=len(out_rows),
                                     positional=positional)
                    try:
                        cb(result.with_rows(out_rows), None, exec_id)
                    except BaseException as e:
                        # a broken callback must not starve its siblings
                        try:
                            cb(None, e, exec_id)
                        except BaseException:
                            pass

            item.callback = demux
            # retry/hedge budget from any member context (members of a
            # merged batch share the node's class and similar deadlines)
            ctx0 = next((c for _, _, _, _, c, _ in live if c is not None),
                        None)
            self._submit_resilient(node, ex, item, ctx0,
                                   dag_name=dag_name, traces=traced)
            return [None] * len(arg_list)

        return batched

    # -- admission control ----------------------------------------------------
    def set_admission(self, dag_name: str,
                      admission: Optional[AdmissionController]) -> None:
        """Install (or clear, with None) the overload-protection gate for
        a DAG's front door.  Without a gate, ``call_dag`` still honors
        explicit ``deadline_s`` (expiry in batcher/executor queues) but
        never sheds."""
        if admission is None:
            self._admission.pop(dag_name, None)
        else:
            if admission.queue_depth_fn is None:
                # leading overload indicator: executor backlog moves ahead
                # of the arrival-rate estimate during a burst or after a
                # replica failure shrinks effective capacity
                admission.queue_depth_fn = \
                    lambda: self.pool.total_depth()
            self._admission[dag_name] = admission

    def admission_for(self, dag_name: str) -> Optional[AdmissionController]:
        return self._admission.get(dag_name)

    # -- execution ----------------------------------------------------------------
    def call_dag(self, name: str, table: Table, *,
                 deadline_s: Optional[float] = None,
                 klass: Optional[str] = None) -> Future:
        # ONE registry read per request: the whole execution runs on the
        # generation that was live at arrival, even if a blue/green swap
        # lands mid-flight
        dag = self.dags[name]
        t0 = _mono()
        # the trace exists BEFORE the admission decision so a shed
        # request still has a (kept) trace saying why it never ran
        tr = self.tracer.start(name, klass or "interactive", t0)
        ctx: Optional[RequestContext] = None
        adm = self._admission.get(name)
        if adm is not None:
            d = adm.admit(klass, deadline_s)
            kname = d.klass
            if tr is not None:
                tr.klass = kname
                tr.span("admission", t0, _mono(), action=d.action,
                        reason=d.reason, klass=kname,
                        estimate_s=d.estimate_s)
            if deadline_s is None:
                deadline_s = d.deadline_s
            if not d.admitted:
                # typed fast-fail: the caller learns in microseconds —
                # not after a blown deadline — that the deployment is
                # protecting itself.  Sheds get their OWN series (NOT
                # error_t): the controller must distinguish "overloaded
                # and shedding by design" from "failing".
                now = _mono()
                self.record_metric(okeys.dag(name, "shed_t"), now)
                self.record_metric(okeys.admission(name, kname, "shed_t"),
                                   now)
                if tr is not None:
                    tr.finish(shed=True, shed_reason=d.reason)
                fut = Future()
                fut.set_exception(Overloaded(
                    f"{name}: {kname} request shed ({d.reason})",
                    klass=kname, reason=d.reason,
                    estimate_s=d.estimate_s, deadline_s=deadline_s))
                return fut
            if d.action == "degrade":
                self.record_metric(
                    okeys.admission(name, kname, "degraded_t"), _mono())
            ctx = RequestContext(klass=kname, degrade=d.degrade)
        elif tr is not None:
            # no gate installed: a zero-cost marker so every exported
            # trace starts with its admission decision
            tr.span("admission", t0, t0, action="admit", reason="no_gate")
        if ctx is None and (deadline_s is not None or klass is not None
                            or tr is not None):
            ctx = RequestContext(klass=klass or "interactive")
        if ctx is not None and deadline_s is not None:
            ctx.deadline_s = deadline_s
            ctx.deadline_t = t0 + deadline_s
        if ctx is not None and tr is not None:
            ctx.trace = tr
            tr.deadline_s = deadline_s
        return self.call_dag_object(dag, table, record=True, ctx=ctx)

    def call_dag_object(self, dag: RuntimeDag, table: Table, *,
                        record: bool = False,
                        ctx: Optional[RequestContext] = None) -> Future:
        """Execute a DAG *object* directly, registered or not — the
        blue/green replanner drives warm-up and canary requests through a
        prepared (not yet traffic-visible) green generation this way.
        ``record=False`` keeps synthetic requests out of the
        ``dag/<name>/…`` series the SLO controller measures."""
        fut: Future = Future()
        t0 = _mono()
        # every request gets a context with a unique id: (req_id, node)
        # is the dispatch key that makes redispatched KVS writes
        # idempotent and completions exactly-once
        if ctx is None:
            ctx = RequestContext()
        ctx.req_id = next(_req_ids)
        tr = ctx.trace
        if record:
            name = dag.name
            # arrival + end-to-end latency series: what the SLO
            # controller's rate estimate and the benchmark's measured p99
            # read back
            self.record_metric(okeys.dag(name, "request_t"), t0)

            def _record(f: Future):
                lat = _mono() - t0
                try:
                    exc = f.exception()
                except BaseException as e:
                    exc = e
                if exc is None:
                    self.record_metric(okeys.dag(name, "latency_s"), lat)
                elif isinstance(exc, DeadlineExceeded):
                    # admitted but its deadline passed in a queue: an
                    # EXPIRY, not an error — the request failed fast by
                    # design, in a fraction of its budget
                    self.record_metric(okeys.dag(name, "expired_t"),
                                       _mono())
                    self.record_metric(okeys.dag(name, "shed_latency_s"),
                                       lat)
                elif isinstance(exc, Overloaded):
                    self.record_metric(okeys.dag(name, "shed_t"), _mono())
                    self.record_metric(okeys.dag(name, "shed_latency_s"),
                                       lat)
                else:
                    # error-path latency goes to its OWN series plus an
                    # error counter whose values are completion
                    # timestamps (len = count, values = the window the
                    # controller rates errors over).  Folding failures
                    # into latency_s — or dropping them, as we used to —
                    # makes the measured p99 improve exactly when the
                    # system degrades.
                    self.record_metric(okeys.dag(name, "error_latency_s"),
                                       lat)
                    self.record_metric(okeys.dag(name, "error_t"), _mono())
                if tr is not None:
                    # tail-based keep decision happens here, with the
                    # request's true outcome in hand
                    if exc is None:
                        miss = (tr.deadline_s is not None
                                and lat > tr.deadline_s)
                        tr.finish(slo_miss=miss)
                    elif isinstance(exc, DeadlineExceeded):
                        tr.finish(slo_miss=True, shed=True,
                                  shed_reason="expired")
                    elif isinstance(exc, Overloaded):
                        tr.finish(shed=True,
                                  shed_reason=getattr(exc, "reason", None))
                    else:
                        tr.finish(error=exc)
            fut.add_done_callback(_record)
        self._track_execution(dag, fut)
        _DagExecution(self, dag, table, fut, ctx).start()
        return fut

    def stop(self):
        self.pool.stop()
        with self._batchers_lock:
            batchers = list(self._batchers.values()) + self._retired_batchers
        for b in batchers:
            b.close()


class _DagExecution:
    def __init__(self, rt: Runtime, dag: RuntimeDag, table: Table,
                 fut: Future, ctx: Optional[RequestContext] = None):
        self.rt = rt
        self.dag = dag
        self.input = table
        self.fut = fut
        self.ctx = ctx
        self.lock = threading.Lock()
        self.results: Dict[str, Table] = {}
        self.produced_on: Dict[str, Optional[str]] = {}
        self.dispatched: set = set()
        # competitive groups already dispatched for a degraded request
        # (one replica each instead of racing all of them)
        self._groups_fired: set = set()
        self.t0 = _mono()

    def start(self):
        self._advance()

    def _expired(self) -> bool:
        """Fail the whole execution fast once the request's deadline has
        passed — downstream nodes are never dispatched, so an expired
        request stops consuming capacity at the next DAG edge."""
        ctx = self.ctx
        if ctx is None or ctx.deadline_t is None:
            return False
        if ctx.deadline_t > _mono():
            return False
        if not self.fut.done():
            self.fut.set_exception(DeadlineExceeded(
                f"{self.dag.name}: deadline passed mid-execution",
                klass=ctx.klass, deadline_s=ctx.deadline_s))
        return True

    def _ready(self, node: RuntimeNode) -> Optional[List[str]]:
        """deps to consume, or None if not ready."""
        if node.wait_any:
            done = [d for d in node.deps if d in self.results]
            return [done[0]] if done else None
        if all(d in self.results for d in node.deps):
            return list(node.deps)
        return None

    def _advance(self):
        if self._expired():
            return
        degraded_serial = (self.ctx is not None
                           and self.ctx.degrade is not None
                           and not self.ctx.degrade.competitive)
        with self.lock:
            to_run = []
            for node in self.dag.nodes.values():
                if node.name in self.dispatched or node.name in self.results:
                    continue
                deps = self._ready(node)
                if deps is None:
                    continue
                if degraded_serial and node.competitive_group is not None:
                    # degraded request: dispatch ONE replica per
                    # competitive group — racing k copies for tail
                    # suppression is capacity a best-effort request does
                    # not get under overload (wait-any fires on the one)
                    if node.competitive_group in self._groups_fired:
                        self.dispatched.add(node.name)
                        continue
                    self._groups_fired.add(node.competitive_group)
                self.dispatched.add(node.name)
                tables = ([self.input] if not node.deps else
                          [self.results[d] for d in deps])
                srcs = ([None] if not node.deps else
                        [self.produced_on.get(d) for d in deps])
                to_run.append((node, tables, srcs))
        for node, tables, srcs in to_run:
            locality_key = node.locality_const
            if node.locality_ref_column is not None and tables \
                    and isinstance(tables[0], Table):
                # dynamic dispatch: resolved ref from the upstream's output
                # (device-resident upstreams keep values on the device
                # — reading a ref back would defeat the residency, and
                # device chains never carry lookup refs anyway)
                t = tables[0]
                try:
                    idx = t.column_index(node.locality_ref_column)
                    if t.rows:
                        locality_key = t.rows[0].values[idx]
                except KeyError:
                    pass
            try:
                self.rt.dispatch(node, tables, srcs,
                                 self._make_callback(node), locality_key,
                                 dag=self.dag, ctx=self.ctx)
            except BaseException as e:
                # a dispatch that cannot even start (e.g. every replica of
                # the class unhealthy) must still resolve the caller —
                # a hung Future is the one outcome fault tolerance forbids
                if not self.fut.done():
                    self.fut.set_exception(e)
                return

    def _make_callback(self, node: RuntimeNode):
        def cb(result, error, exec_id):
            if error is not None:
                if not self.fut.done():
                    self.fut.set_exception(error)
                return
            finish = False
            with self.lock:
                if node.name in self.results:   # competitive duplicate
                    return
                self.results[node.name] = result
                self.produced_on[node.name] = exec_id
                if node.name == self.dag.output:
                    finish = True
            if finish:
                if not self.fut.done():
                    self.fut.set_result(result)
                return
            self._advance()
        return cb
