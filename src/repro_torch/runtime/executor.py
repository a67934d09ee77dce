"""Executor pool: the FaaS workers (Cloudburst executor analogue).  Port
of the reference package's ``runtime/executor.py``.

Each ``Executor`` is one worker (thread) with a local cache; it executes
function invocations serially (one vCPU-ish).  ``resource_class`` partitions
the pool (paper §4: hardware-aware placement — "gpu" executors model
accelerator-attached workers).  Batch-aware functions are fed whole buckets
dequeued from the function queue.

Fault tolerance: workers can crash (thread dies mid-item), wedge
(straggle indefinitely), or throw transient errors — injected via a
:class:`~repro_torch.serving.faults.FaultInjector`, or for real.  Every
completion is gated by the item's
:class:`~repro_torch.serving.retry.CompletionToken`, so at-least-once
redispatch (crash recovery, straggler hedging, retries) delivers each
logical result exactly once.  The pool runs a heartbeat-based failure
detector: a dead or wedged executor is marked unhealthy, excluded from
``candidates()``, its queued + in-flight items are requeued onto healthy
replicas (items already past deadline expire through the normal
pre-dispatch path), and the replica is replaced — by the pool directly
(``auto_replace``) or by the autoscaler converging on the dropped
replica count.

On the card (what the port adds to the reference's picture):

* **A long GPU call looks like a wedge.**  The detector fails over any
  executor busy longer than ``hang_timeout_s`` (5 s by default, as in the reference) and runs a
  CLONE of its in-flight item on another replica.  A first call that
  loads the kernel library or runs the lazy ``nvcc`` build
  (``kernels/build.py``), or a large full-width batch, can take longer
  than 5 s; a false wedge then runs a second copy of the batch on the
  same card (twice the memory, half the speed), and only
  ``fault_counts["wedge"]`` says so.  Serving a full-width model, set
  ``hang_timeout_s`` above the slowest legitimate call (``chip_smoke.py``
  sets it from its measured first call and asserts no wedge).
* **All executors share one card and one stream.**  Every GPU executor
  thread (and the batcher flush threads and the detector) runs on the
  one CUDA context, and ``kernels.build.launch`` launches on the calling
  thread's current stream, which is the default stream: work from two
  executors is ordered on it, so a ``DeviceTable`` made by one worker is
  safe to read from another (a crash requeue of a pinned item).  Nothing
  here moves an executor onto a side stream; a change that does must add
  an event handoff for every ``DeviceTable`` that crosses threads.
* ``ExecutorPool.stop`` also joins the worker threads (bounded), so no
  worker still holds device tensors once it returns.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.lowering import DegradePolicy, degraded_execution
from repro_torch.core.table import copy_capture_end, copy_capture_start
from repro_torch.obs.trace import record_end, record_start, scope
from repro_torch.runtime.kvs import KVS, CacheClient
from repro_torch.runtime.netmodel import NetModel, nbytes
from repro_torch.serving.admission import DeadlineExceeded
from repro_torch.serving.faults import FaultCrash, FaultInjector
from repro_torch.serving.retry import CompletionToken, ExecutorLost

_exec_ids = itertools.count()


@dataclasses.dataclass
class WorkItem:
    fn: Callable
    tables: List[Any]
    produced_on: List[Optional[str]]     # executor id per input (for net cost)
    callback: Callable                   # callback(result|None, error|None, executor_id)
    enqueue_t: float = dataclasses.field(default_factory=time.perf_counter)
    # filled in by the executor before the callback fires — the per-stage
    # profile hook (queueing delay vs pure execution time) a batch-aware
    # planner needs (InferLine-style batch latency profiles)
    queue_s: Optional[float] = None
    exec_s: Optional[float] = None
    # overload protection: absolute perf_counter deadline — the worker
    # fails the item fast (DeadlineExceeded) if it dequeues it too late —
    # and the degrade variant the admission gate picked, applied around
    # the fn so the exec-path router sees it on the worker thread
    deadline_t: Optional[float] = None
    degrade: Optional[DegradePolicy] = None
    # at-least-once execution: every dispatch attempt of this logical item
    # (original, crash requeue, straggler hedge) shares one token; exactly
    # one completion claims it and fires the callback
    token: CompletionToken = dataclasses.field(
        default_factory=CompletionToken)
    # idempotence key for side effects: (request id, node, row ids) —
    # ``ExecutionContext.kvs_put`` routes writes through ``KVS.put_once``
    # when set, so a double-executed item cannot double-apply a write
    dispatch_key: Optional[Tuple] = None
    # which dispatch attempt this is (0 = original); the retry policy
    # reads it to cap redispatches and size backoff
    attempt: int = 0
    # observability: every attempt of the logical item (original, crash
    # requeue, hedge, retry clone) appends events to ONE shared log —
    # ("start"|"cancelled"|"requeue", executor_id, t) and
    # ("done", executor_id, t, queue_s, exec_s, copies, spans) — so the
    # single winning callback can reconstruct the full attempt history
    # (``spans``: the scopes recorded inside the fn, or None)
    attempt_log: List[Tuple] = dataclasses.field(default_factory=list)
    # host<->device copy counts captured around THIS item's execution
    copies: Optional[Dict[str, int]] = None
    # some member request is traced: the executor records the scopes
    # (upload, chain steps) run inside the fn, onto the ``done`` entry
    traced: bool = False

    def clone(self) -> "WorkItem":
        """A redispatchable copy sharing this item's completion token and
        dispatch key: whichever attempt finishes first wins the claim,
        the rest fall silent."""
        return WorkItem(fn=self.fn, tables=self.tables,
                        produced_on=self.produced_on,
                        callback=self.callback,
                        deadline_t=self.deadline_t, degrade=self.degrade,
                        token=self.token, dispatch_key=self.dispatch_key,
                        attempt=self.attempt,
                        attempt_log=self.attempt_log, traced=self.traced)

    def deliver(self, result, error, executor_id: Optional[str]) -> bool:
        """Claim the completion and fire the callback; False if another
        attempt already delivered."""
        if not self.token.claim(executor_id):
            return False
        self.callback(result, error, executor_id)
        return True


class ExecutionContext:
    """Passed to operators: KVS access via the executor's cache."""

    def __init__(self, executor: "Executor",
                 item: Optional[WorkItem] = None):
        self.executor = executor
        self.kvs = executor.cache.kvs
        self.dispatch_key = item.dispatch_key if item is not None else None

    def kvs_get(self, key: str):
        return self.executor.cache.get(key)

    def kvs_put(self, key: str, value):
        if self.dispatch_key is not None:
            # at-least-once execution: a redispatched/hedged item re-runs
            # the operator, but its writes apply exactly once
            if not self.kvs.put_once((self.dispatch_key, key), key, value):
                return
            self.executor.cache.observe(key, value)
            return
        self.executor.cache.put(key, value)


class Executor:
    def __init__(self, kvs: KVS, net: NetModel, resource_class: str = "cpu",
                 cache_bytes: int = 2 << 30, reserved: bool = False,
                 injector: Optional[FaultInjector] = None):
        tag = f"{resource_class}-rsvd" if reserved else resource_class
        self.id = f"{tag}-exec-{next(_exec_ids)}"
        self.resource_class = resource_class
        # reserved workers serve ONLY warm-up/canary traffic: a saturated
        # serving pool cannot starve the canary and abort a good swap
        self.reserved = reserved
        self.net = net
        self.cache = CacheClient(kvs, self.id, cache_bytes)
        self.q: "queue.Queue[WorkItem]" = queue.Queue()
        self._stop = False
        self._injector = injector
        self.busy = False
        self.completed = 0
        # failure-detection state: the worker beats on every loop
        # iteration; ``busy_since``/``current`` expose what it is chewing
        # on so a wedged worker's in-flight item can be recovered
        self.healthy = True
        self.crashed = False
        self.heartbeat_t = time.perf_counter()
        self.busy_since: Optional[float] = None
        self.current: Optional[WorkItem] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.id)
        self._thread.start()

    @property
    def load(self) -> int:
        return self.q.qsize() + (1 if self.busy else 0)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def submit(self, item: WorkItem):
        if self._stop:
            raise RuntimeError(f"{self.id} is stopped")
        self.q.put(item)

    def _run(self):
        try:
            self._loop()
        except FaultCrash:
            # the injected crash: the thread dies here, busy/current left
            # set for the failure detector — swallowed only to keep the
            # default threading excepthook from spamming stderr
            pass

    def _loop(self):
        while not self._stop:
            self.heartbeat_t = time.perf_counter()
            try:
                item = self.q.get(timeout=0.05)
            except queue.Empty:
                continue
            self.busy = True
            t_start = time.perf_counter()
            self.busy_since = t_start
            self.current = item
            if item.token.claimed:
                # another attempt (hedge winner, crash requeue) already
                # delivered: loser cancellation — skip without executing
                item.attempt_log.append(("cancelled", self.id, t_start))
                self.current = None
                self.busy = False
                self.completed += 1
                continue
            item.queue_s = t_start - item.enqueue_t
            if item.deadline_t is not None and item.deadline_t <= t_start:
                # the deadline passed while the item sat in this worker's
                # queue: fail fast instead of burning the worker on a
                # result nobody can use
                item.exec_s = 0.0
                try:
                    item.deliver(None, DeadlineExceeded(
                        "deadline passed in executor queue",
                        deadline_s=item.deadline_t), self.id)
                finally:
                    self.current = None
                    self.busy = False
                    self.completed += 1
                continue
            # the attempt starts HERE (worker claimed the item and went
            # busy) — logged before fault injection so a crashed or hung
            # attempt still counts in the winning span's attempt history
            item.attempt_log.append(("start", self.id, t_start))
            fault = None
            if self._injector is not None:
                fault = self._injector.draw(self.id, self.resource_class)
            if fault is not None and fault.kind == "crash":
                # the injected process crash: the raise propagates out of
                # _loop and kills this thread.  busy/current deliberately
                # stay set — the failure detector recovers the in-flight
                # item from them.
                self.crashed = True
                raise FaultCrash(f"injected crash on {self.id}")
            if fault is not None and fault.kind == "hang":
                # straggle: sleep while "busy" — the hedger and the wedge
                # detector race us; if either wins, skip the execution
                time.sleep(fault.hang_s)
                if item.token.claimed:
                    item.attempt_log.append(
                        ("cancelled", self.id, time.perf_counter()))
                    self.current = None
                    self.busy = False
                    self.completed += 1
                    continue
            spans = None
            try:
                if fault is not None and fault.kind == "transient":
                    raise self._injector.transient_error(self.id)
                self.net.charge_invoke()   # FaaS invocation overhead
                # charge network for inputs shipped from other executors
                for t, src in zip(item.tables, item.produced_on):
                    if src is not None and src != self.id:
                        self.net.charge(nbytes(t))
                ctx = ExecutionContext(self, item)
                node = item.dispatch_key[1] if item.dispatch_key else None
                if item.traced:
                    record_start(node)
                copy_capture_start()
                try:
                    # the service part of the exec@ span, as a profiler
                    # range only (the runtime closes the span itself)
                    with scope("exec", node=node, span=False):
                        if item.degrade is not None:
                            with degraded_execution(item.degrade):
                                result = item.fn(item.tables, ctx)
                        else:
                            result = item.fn(item.tables, ctx)
                finally:
                    item.copies = copy_capture_end()
                    if item.traced:
                        spans = record_end()
                t_end = time.perf_counter()
                item.exec_s = t_end - t_start
                item.attempt_log.append(("done", self.id, t_end,
                                         item.queue_s, item.exec_s,
                                         item.copies, spans))
                item.deliver(result, None, self.id)
            except BaseException as e:
                t_end = time.perf_counter()
                item.exec_s = t_end - t_start
                item.attempt_log.append(("done", self.id, t_end,
                                         item.queue_s, item.exec_s,
                                         item.copies, spans))
                item.deliver(None, e, self.id)
            finally:
                self.current = None
                self.busy = False
                self.completed += 1

    def drain(self) -> List[WorkItem]:
        """Pop everything still queued (items the worker has not started).
        The caller owns requeueing or failing them."""
        items: List[WorkItem] = []
        while True:
            try:
                items.append(self.q.get_nowait())
            except queue.Empty:
                return items

    def stop(self) -> List[WorkItem]:
        """Stop the worker and return its undispatched queue.  Callers
        MUST route the returned items somewhere (requeue or fail) — the
        pre-fault-tolerance ``stop()`` dropped them silently, hanging
        every caller whose callback never fired."""
        self._stop = True
        return self.drain()


class ExecutorPool:
    """All executors, partitioned by resource class, plus per-function
    replica assignment (the autoscaler mutates assignments) and the
    heartbeat failure detector."""

    def __init__(self, kvs: KVS, net: NetModel,
                 n_cpu: int = 4, n_gpu: int = 0,
                 cache_bytes: int = 2 << 30,
                 reserved_cpu: int = 0, reserved_gpu: int = 0,
                 fault_injector: Optional[FaultInjector] = None,
                 hang_timeout_s: float = 5.0,
                 auto_replace: bool = True,
                 on_fault: Optional[Callable[[str, str, int], None]] = None):
        self.kvs = kvs
        self.net = net
        self.cache_bytes = cache_bytes
        self.injector = fault_injector
        #: busy longer than this = wedged (conservatively above any
        #: legitimate whole-batch service time)
        self.hang_timeout_s = hang_timeout_s
        #: replace a failed executor with a fresh one of the same class
        #: immediately; with False, replacement is the autoscaler's job
        #: (it converges on the dropped replica count)
        self.auto_replace = auto_replace
        #: hook(kind, executor_id, n_requeued) for "crash"/"wedge"
        #: events — the runtime records fault metric series through it
        self.on_fault = on_fault
        self.fault_counts: Dict[str, int] = {"crash": 0, "wedge": 0,
                                             "requeued": 0, "replaced": 0,
                                             "lost": 0}
        self.executors: Dict[str, Executor] = {}
        self._lock = threading.Lock()
        self._detector: Optional[threading.Thread] = None
        self._detector_stop = False
        for _ in range(n_cpu):
            self.add_executor("cpu")
        for _ in range(n_gpu):
            self.add_executor("gpu")
        for _ in range(reserved_cpu):
            self.add_executor("cpu", reserved=True)
        for _ in range(reserved_gpu):
            self.add_executor("gpu", reserved=True)
        # function name -> executor ids allowed to run it (None = any in class)
        self.assignment: Dict[str, List[str]] = {}

    def add_executor(self, resource_class: str, *,
                     reserved: bool = False) -> Executor:
        ex = Executor(self.kvs, self.net, resource_class, self.cache_bytes,
                      reserved=reserved, injector=self.injector)
        with self._lock:
            self.executors[ex.id] = ex
        return ex

    def set_injector(self, injector: Optional[FaultInjector]) -> None:
        """Swap the fault plan at runtime (the chaos benchmark sweeps
        rates without rebuilding the pool)."""
        with self._lock:
            self.injector = injector
            for e in self.executors.values():
                e._injector = injector

    def by_class(self, resource_class: str, *,
                 reserved: bool = False) -> List[Executor]:
        """HEALTHY serving workers of a class; ``reserved=True`` returns
        the warm-up/canary pool instead.  The two never mix: serving
        traffic cannot spill onto reserved workers, and reserved work
        does not queue behind a saturated serving pool.  Unhealthy
        (crashed/wedged) workers are excluded everywhere."""
        with self._lock:
            return [e for e in self.executors.values()
                    if e.resource_class == resource_class
                    and e.reserved == reserved
                    and e.healthy and not e._stop]

    def by_id(self, executor_id: str) -> Optional[Executor]:
        with self._lock:
            return self.executors.get(executor_id)

    def candidates(self, fname: str, resource_class: str) -> List[Executor]:
        with self._lock:
            ids = self.assignment.get(fname)
            if ids:
                got = [self.executors[i] for i in ids
                       if i in self.executors
                       and self.executors[i].healthy
                       and not self.executors[i]._stop]
                if got:
                    return got
        return self.by_class(resource_class)

    # -- failure detection ---------------------------------------------------
    def start_failure_detector(self, interval_s: float = 0.05) -> None:
        """Start the heartbeat monitor: crashed (thread dead) and wedged
        (busy past ``hang_timeout_s``) executors are failed over.  Idempotent."""
        if self._detector is not None:
            return
        self._detector_stop = False

        def _watch():
            while not self._detector_stop:
                try:
                    self.check_health()
                except Exception:       # the detector must never die
                    pass
                time.sleep(interval_s)

        self._detector = threading.Thread(target=_watch, daemon=True,
                                          name="failure-detector")
        self._detector.start()

    def check_health(self, now: Optional[float] = None) -> List[str]:
        """One detection pass (tests drive this directly for determinism).
        Returns the ids of executors failed over in this pass."""
        now = now if now is not None else time.perf_counter()
        with self._lock:
            suspects = []
            for e in self.executors.values():
                if not e.healthy or e._stop:
                    continue
                if not e.alive:
                    suspects.append((e, "crash"))
                elif e.busy and e.busy_since is not None \
                        and now - e.busy_since > self.hang_timeout_s:
                    suspects.append((e, "wedge"))
        failed = []
        for e, kind in suspects:
            self._handle_failure(e, kind)
            failed.append(e.id)
        return failed

    def _handle_failure(self, ex: Executor, kind: str) -> None:
        """Fail over one executor: mark it unhealthy, requeue its queued
        + in-flight items onto healthy replicas, prune it from replica
        assignments (the autoscaler sees the dropped count), and replace
        it when ``auto_replace``."""
        with self._lock:
            if not ex.healthy:          # another pass got here first
                return
            ex.healthy = False
            # prune from assignments so replica_count drops — the signal
            # the autoscaler converges on
            lost_fnames = []
            for fname, ids in self.assignment.items():
                if ex.id in ids:
                    ids.remove(ex.id)
                    lost_fnames.append(fname)
            self.fault_counts[kind] += 1
        # a wedged worker is still alive: stop it so it exits after the
        # current item instead of chewing new work, and drain its queue
        # before it can wake up and reach it.  (A crashed worker's thread
        # is already gone; drain is uncontended.)
        ex._stop = True
        orphans = ex.drain()
        if ex.current is not None:
            # in-flight recovery: a clone shares the completion token, so
            # if the wedged original eventually finishes, exactly one of
            # the two attempts delivers
            orphans.append(ex.current.clone())
        replacement = None
        if self.auto_replace:
            replacement = self.add_executor(ex.resource_class,
                                            reserved=ex.reserved)
            with self._lock:
                for fname in lost_fnames:
                    self.assignment.setdefault(fname, []).append(
                        replacement.id)
                self.fault_counts["replaced"] += 1
        n = self.requeue(orphans, ex.resource_class,
                         exclude={ex.id}, reserved=ex.reserved)
        if self.on_fault is not None:
            try:
                self.on_fault(kind, ex.id, n)
            except Exception:
                pass

    def requeue(self, items: List[WorkItem], resource_class: str, *,
                exclude: Optional[set] = None,
                reserved: bool = False) -> int:
        """Redispatch orphaned items onto the least-loaded healthy
        replicas of a class.  Items whose completion was already claimed
        are dropped (their result was delivered elsewhere); with no
        healthy replica left, items fail typed (``ExecutorLost``) so
        callers never hang.  Returns how many items were requeued."""
        exclude = exclude or set()
        n = 0
        for item in items:
            if item.token.claimed:
                continue
            targets = [e for e in self.by_class(resource_class,
                                                reserved=reserved)
                       if e.id not in exclude]
            if not targets:
                with self._lock:
                    self.fault_counts["lost"] += 1
                try:
                    item.deliver(None, ExecutorLost(
                        f"no healthy {resource_class} replica to requeue "
                        "onto"), None)
                except Exception:
                    pass
                continue
            target = min(targets, key=lambda e: e.load)
            try:
                target.submit(item)
                item.attempt_log.append(
                    ("requeue", target.id, time.perf_counter()))
                n += 1
            except RuntimeError:        # stopped under our feet: next pass
                try:
                    item.deliver(None, ExecutorLost(
                        f"{target.id} stopped during requeue"), None)
                except Exception:
                    pass
        if n:
            with self._lock:
                self.fault_counts["requeued"] += n
        return n

    # -- autoscaler hooks ----------------------------------------------------
    def assign(self, fname: str, executor_ids: List[str]):
        with self._lock:
            self.assignment[fname] = list(executor_ids)

    def add_replica(self, fname: str, resource_class: str) -> str:
        ex = self.add_executor(resource_class)
        with self._lock:
            self.assignment.setdefault(fname, []).append(ex.id)
        return ex.id

    def remove_replica(self, fname: str) -> Optional[str]:
        with self._lock:
            ids = self.assignment.get(fname) or []
            if len(ids) <= 1:
                return None
            # prefer trimming an unhealthy replica: it serves nothing
            eid = next((i for i in ids
                        if i in self.executors
                        and not self.executors[i].healthy), ids[-1])
            ids.remove(eid)
            ex = self.executors.pop(eid, None)
        if ex:
            # lost-work fix: the removed replica's queued items used to be
            # dropped with their callbacks never fired — route them
            # through the requeue path instead
            orphans = ex.stop()
            if orphans:
                self.requeue(orphans, ex.resource_class,
                             exclude={eid}, reserved=ex.reserved)
        return eid

    def replica_count(self, fname: str) -> int:
        """Healthy replicas assigned to ``fname`` — a crashed replica no
        longer counts, which is exactly the deficit the autoscaler's
        target mode closes."""
        with self._lock:
            ids = self.assignment.get(fname)
            if not ids:
                return 0
            return sum(1 for i in ids
                       if i in self.executors
                       and self.executors[i].healthy)

    def queue_depth(self, fname: str, resource_class: str = "cpu") -> int:
        return sum(e.load for e in self.candidates(fname, resource_class))

    def total_depth(self, *, reserved: bool = False) -> int:
        """Queued + in-flight items across every healthy serving
        executor: the leading-indicator load signal the admission gate
        blends into its deadline-risk estimate."""
        with self._lock:
            return sum(e.load for e in self.executors.values()
                       if e.reserved == reserved
                       and e.healthy and not e._stop)

    #: how long ``stop`` waits, in all, for the workers to leave their
    #: current items
    STOP_JOIN_S = 5.0

    def stop(self):
        self._detector_stop = True
        with self._lock:
            executors = list(self.executors.values())
        for e in executors:
            for item in e.stop():
                # fail leftovers typed instead of stranding their callers
                try:
                    item.deliver(None, RuntimeError(
                        "executor pool stopped"), None)
                except Exception:
                    pass
        # wait (bounded) for the workers to leave their current item, so
        # their device tensors are released when stop() returns
        deadline = time.perf_counter() + self.STOP_JOIN_S
        for e in executors:
            if e._thread is not threading.current_thread():
                e._thread.join(max(0.0, deadline - time.perf_counter()))
