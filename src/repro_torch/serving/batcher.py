"""Request batcher — the paper's Batching optimization (§4, Fig 8).
Port of the reference package's ``serving/batcher.py``.

Collects individual requests into one batched model invocation (pad to the
batch bucket), runs a single batched call, and demultiplexes the results.
Used by the runtime's batch-aware executor; also usable standalone.

Deadline awareness (overload protection): items may carry an absolute
``deadline_t``.  The flush loop orders its backlog earliest-deadline-first
(plain FIFO when no item has a deadline, so the steady-state path is
untouched), and items whose deadline has already passed are *expired*
before dispatch — they fail fast with a typed
:class:`~repro_torch.serving.admission.DeadlineExceeded` instead of occupying
batch slots, and ``on_drop`` + the ``expired`` counter surface every such
decision to the runtime's metrics.
"""
from __future__ import annotations

import threading
import queue
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.serving.admission import DeadlineExceeded


#: queued by close() to wake the batch loop out of its poll immediately —
#: without it, close() blocks its caller (possibly an executor callback
#: thread on the serving path) for up to the full poll timeout
_WAKE = object()


class BatchItem:
    __slots__ = ("args", "event", "result", "error", "enqueue_t",
                 "deadline_t", "done")

    def __init__(self, args, deadline_t: Optional[float] = None):
        self.args = args
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.enqueue_t = time.perf_counter()
        # absolute perf_counter time after which dispatching is pointless
        self.deadline_t = deadline_t
        # completion is idempotent: exactly ONE path (flush, expiry, close
        # drain, call-timeout) decrements the accepted-minus-completed
        # counter, whichever claims the item first
        self.done = False


class Batcher:
    """Micro-batching queue in front of a batched function.

    ``fn`` maps a list of per-request arg dicts to a list of results (it is
    responsible for stacking/padding).  ``max_batch`` bounds the bucket
    (paper default: 10); ``max_wait_ms`` bounds queueing delay.

    The wait deadline is *adaptive*: an EWMA of recent inter-arrival gaps
    decides how much of ``max_wait`` is actually worth spending.  Under
    dense traffic (gaps well inside the window) the full window is used and
    requests coalesce; under sparse traffic the wait shrinks toward zero —
    a lone request should not sit out the whole window when the expected
    next arrival lies beyond it.  ``adaptive_wait=False`` restores the
    fixed-deadline behavior.
    """

    #: EWMA smoothing for inter-arrival gaps.
    GAP_ALPHA = 0.3

    def __init__(self, fn: Callable[[List[Any]], List[Any]], *,
                 max_batch: int = 10, max_wait_ms: float = 2.0,
                 adaptive_wait: bool = True,
                 on_drop: Optional[Callable[[Any, BaseException],
                                            None]] = None):
        self.fn = fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.adaptive_wait = adaptive_wait
        # called (args, error) for items failed by close()'s drain: a
        # caller whose waiters are callbacks buried in ``args`` (the
        # runtime) would otherwise hang them — nobody waits on
        # ``item.event`` there, so the event alone reaches no one
        self.on_drop = on_drop
        self.q: "queue.Queue[BatchItem]" = queue.Queue()
        self._stop = False
        self._lock = threading.Lock()       # serializes submit vs close
        # items accepted but not yet completed (queued OR popped into an
        # in-progress flush).  ``q.empty()`` alone is NOT a drain signal:
        # the batch loop pops items before running fn, so the queue can be
        # empty while a flush still holds live requests
        self._pending = 0
        # items popped off the queue but deferred past a full flush (EDF
        # overflow): owned by the batch loop thread; close() drains it
        # after joining that thread
        self._backlog: List[BatchItem] = []
        self._gap_ewma: Optional[float] = None
        self._last_submit_t: Optional[float] = None
        #: items failed before dispatch because their deadline passed
        self.expired = 0
        #: batches whose members were EDF-reordered out of arrival order
        self.reorders = 0
        #: whether the batch currently being flushed was EDF-reordered —
        #: written by the flush thread just before it invokes ``fn``, read
        #: by the batch fn (same thread) to annotate the batch-level span
        self.last_reordered = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self.batch_sizes: List[int] = []

    def _complete(self, item: BatchItem) -> bool:
        """Claim ``item``'s completion: True for exactly one caller.  The
        winner decrements the pending counter; losers must not touch the
        item's result/error."""
        with self._lock:
            if item.done:
                return False
            item.done = True
            self._pending -= 1
            return True

    def submit(self, args, deadline_t: Optional[float] = None) -> BatchItem:
        item = BatchItem(args, deadline_t)
        with self._lock:
            if self._stop:
                raise RuntimeError("batcher is closed")
            if self._last_submit_t is not None:
                # clamp the sample: beyond ~4 windows a gap is just "idle",
                # and folding a minutes-long pause into the EWMA would pin
                # the wait at zero for dozens of requests into the next
                # dense burst (clamped, recovery takes ~3 samples)
                gap = min(item.enqueue_t - self._last_submit_t,
                          4.0 * self.max_wait)
                self._gap_ewma = gap if self._gap_ewma is None else \
                    ((1.0 - self.GAP_ALPHA) * self._gap_ewma
                     + self.GAP_ALPHA * gap)
            self._last_submit_t = item.enqueue_t
            self._pending += 1
            self.q.put(item)
        return item

    def pending(self) -> int:
        """Live requests in this batcher: accepted and not yet completed
        (queued, mid-flush, or dispatched awaiting their callback).  The
        counter the accountancy tests reconcile against offered traffic —
        it must return to zero after every fault-recovery path."""
        with self._lock:
            return self._pending

    def quiescent(self) -> bool:
        """True when the batcher holds NO live requests: nothing queued
        *and* no flush in progress.  This is the drain signal retirement
        logic must use — ``q.empty()`` races with an active flush whose
        popped items are still being served."""
        with self._lock:
            return self._pending == 0

    def reconfigure(self, *, max_batch: Optional[int] = None,
                    max_wait_ms: Optional[float] = None) -> None:
        """Hot-apply new batching knobs (the SLO controller's safe config
        delta).  The batch loop reads ``max_batch``/``max_wait`` fresh on
        every iteration, so the change takes effect on the next batch —
        in-flight batches are untouched."""
        with self._lock:
            if max_batch is not None:
                self.max_batch = max(1, int(max_batch))
            if max_wait_ms is not None:
                self.max_wait = max(0.0, float(max_wait_ms)) / 1000.0

    def arrival_gap_s(self) -> Optional[float]:
        """The EWMA of recent inter-arrival gaps (None before 2 submits) —
        the controller's cheap read on how dense this node's traffic is."""
        with self._lock:
            return self._gap_ewma

    def effective_wait(self) -> float:
        """How long the batch loop holds a partial batch open.  Arrivals
        expected WITHIN the window keep the full window (so every merge
        the fixed deadline achieved still happens); beyond it the wait
        shrinks linearly, reaching zero at twice the window — a lone
        request during sparse traffic fires immediately."""
        if not self.adaptive_wait:
            return self.max_wait
        with self._lock:
            gap = self._gap_ewma
        if gap is None or gap <= self.max_wait:
            return self.max_wait
        return max(0.0, 2.0 * self.max_wait - gap)

    def call(self, args, timeout: Optional[float] = 30.0,
             deadline_t: Optional[float] = None):
        item = self.submit(args, deadline_t)
        if not item.event.wait(timeout):
            if self._complete(item):
                # claimed: the flush loop will skip this item, and the
                # accepted-minus-completed counter stays honest — a timed
                # out call must never wedge quiescent()/retirement
                item.error = TimeoutError("batched call timed out")
                item.event.set()
                raise item.error
            # lost the race: the flush completed it concurrently with our
            # timeout — fall through to its real result
        if item.error is not None:
            raise item.error
        return item.result

    def _fail_undispatched(self, item: BatchItem, err: BaseException):
        """Fail an item that never reached a dispatch (expiry, close
        drain); no-op if another path already claimed it."""
        if not self._complete(item):
            return
        item.error = err
        item.event.set()
        if self.on_drop is not None:
            try:
                self.on_drop(item.args, err)
            except BaseException:
                pass

    def _collect(self) -> List[BatchItem]:
        """One flush worth of items: queue arrivals (holding the adaptive
        window open only when there is no deferred backlog) merged with
        the backlog, expired items failed, the rest EDF-ordered."""
        items: List[BatchItem] = []
        if self._backlog:
            # deferred items already waited out a window — drain whatever
            # the queue has RIGHT NOW and flush without holding another
            while len(items) + len(self._backlog) < self.max_batch:
                try:
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _WAKE:
                    break
                items.append(nxt)
        else:
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                return []
            if first is _WAKE:
                return []                   # close() signal; re-check _stop
            items = [first]
            deadline = time.perf_counter() + self.effective_wait()
            while len(items) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _WAKE:
                    break                   # flush what we hold, then exit
                items.append(nxt)
        pool = self._backlog + items        # backlog first: it is older
        self._backlog = []
        now = time.perf_counter()
        live: List[BatchItem] = []
        for it in pool:
            if it.done:
                continue                    # call() timeout already claimed
            if it.deadline_t is not None and it.deadline_t <= now:
                self.expired += 1
                self._fail_undispatched(it, DeadlineExceeded(
                    "deadline passed before dispatch",
                    deadline_s=it.deadline_t))
            else:
                live.append(it)
        reordered = False
        if any(it.deadline_t is not None for it in live):
            # earliest deadline first; deadline-less items ride behind in
            # arrival order (sort is stable).  Plain FIFO traffic never
            # reaches this sort.
            before = list(live)
            live.sort(key=lambda it: (it.deadline_t is None,
                                      it.deadline_t or 0.0))
            reordered = live != before
            if reordered:
                self.reorders += 1
        self.last_reordered = reordered
        self._backlog = live[self.max_batch:]
        return live[:self.max_batch]

    def _loop(self):
        while not self._stop:
            items = self._collect()
            if not items:
                continue
            self.batch_sizes.append(len(items))
            try:
                results = self.fn([it.args for it in items])
                for it, r in zip(items, results):
                    it.result = r
            except BaseException as e:  # propagate to all waiters
                for it in items:
                    it.error = e
            for it in items:
                if self._complete(it):
                    it.event.set()

    def close(self):
        """Stop the batch thread and fail anything still queued.

        ``submit``/``close`` are serialized by ``_lock``: after close wins
        the race, concurrent submitters get an immediate ``RuntimeError``
        instead of a silently dropped item, and items enqueued before the
        close are drained with an error so no waiter sits out its full
        ``call`` timeout."""
        with self._lock:
            if self._stop:
                return
            self._stop = True
        # wake the loop out of its poll so the join below returns
        # promptly — close() may run on an executor callback thread (the
        # generation-drain path), where a poll-timeout-long block would
        # stall the serving hot path
        self.q.put(_WAKE)
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=1.0)
        # drain the EDF backlog as well as the queue: deferred items are
        # just as undispatched as queued ones
        leftovers, self._backlog = list(self._backlog), []
        while True:
            try:
                it = self.q.get_nowait()
            except queue.Empty:
                break
            if it is _WAKE:
                continue
            leftovers.append(it)
        for it in leftovers:
            self._fail_undispatched(
                it, RuntimeError("batcher closed before dispatch"))
