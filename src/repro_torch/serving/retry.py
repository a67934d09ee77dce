"""Retry policy + error taxonomy for at-least-once dispatch.  Port of
the reference package's ``serving/retry.py``.

A serverless substrate assumes functions can fail mid-request and the
dataflow still answers inside its latency goal (Cloudburst executors are
"unpredictably slow" by design; Clipper's straggler mitigation makes the
same point for ensembles).  That requires a vocabulary the dispatcher can
act on:

* :class:`Transient` — the *attempt* failed, not the request: a worker
  died or was injected with a recoverable fault.  Redispatching the same
  work to another replica is expected to succeed.
* :class:`Permanent` — the *request* failed: user code raised, inputs are
  malformed.  Re-executing would fail identically (or worse, double-apply
  side effects), so permanent errors are delivered immediately.

Everything not typed here is treated as permanent: re-running unknown user
exceptions is how at-least-once systems corrupt state.

:class:`RetryPolicy` is capped exponential backoff with jitter, and it is
**deadline-budget-aware**: a retry whose backoff would land past the
request's ``deadline_t`` is not taken — the caller gets the typed failure
while it can still act on it, instead of a late answer nobody can use.

:class:`CompletionToken` is the idempotence primitive for at-least-once
execution.  Every dispatch attempt of a logical work item (the original,
its crash-recovery requeue, its straggler hedge) shares one token; exactly
one completion *claims* it and delivers the callback.  Losers fall silent:
no double demux, no double-counted metrics, no double future resolution.
KVS writes are made idempotent the same way, keyed by the item's
``dispatch_key`` (request, node, row ids) — see ``KVS.put_once``.
"""
from __future__ import annotations

import dataclasses
import random
import threading
from typing import Optional

from repro_torch.obs.clock import now as _mono


class Transient(RuntimeError):
    """An attempt-scoped failure: redispatch to another replica is
    expected to succeed."""


class Permanent(RuntimeError):
    """A request-scoped failure: re-execution would fail identically (or
    double-apply side effects) — never retried."""


class TransientFault(Transient):
    """A typed transient error raised by fault injection (the chaos
    plan's ``transient`` kind)."""


class ExecutorLost(Transient):
    """The executor holding this work died or wedged; the item was (or
    could not be) redispatched."""


#: stdlib exception types that count as transient without wrapping —
#: infrastructure hiccups, not user-code failures.
TRANSIENT_TYPES = (ConnectionError, InterruptedError)


def is_transient(error: BaseException) -> bool:
    """Is this failure worth a redispatch?  Only typed transients (and a
    short list of infrastructure exceptions) qualify — unknown user
    exceptions are permanent by default."""
    if isinstance(error, Permanent):
        return False
    return isinstance(error, (Transient,) + TRANSIENT_TYPES)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with jitter, bounded by the request's
    deadline budget.

    ``max_attempts`` counts *dispatches*, not retries: 3 means the
    original plus at most two redispatches.  ``jitter`` spreads a
    correlated failure burst (every member of a dead executor's queue
    retrying at once) across the backoff window.
    """
    max_attempts: int = 3
    base_s: float = 0.002
    multiplier: float = 2.0
    cap_s: float = 0.05
    jitter: float = 0.5              # +/- fraction of the raw backoff

    def backoff_s(self, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
        """Backoff before dispatch attempt ``attempt + 1`` (0-based
        attempt index of the one that just failed)."""
        raw = min(self.cap_s, self.base_s * (self.multiplier ** attempt))
        if self.jitter <= 0:
            return raw
        r = (rng or random).uniform(-self.jitter, self.jitter)
        return max(0.0, raw * (1.0 + r))

    def next_delay(self, attempt: int, error: BaseException, now: float,
                   deadline_t: Optional[float] = None,
                   rng: Optional[random.Random] = None) -> Optional[float]:
        """Seconds to wait before redispatching, or None when this
        failure must be delivered: attempts exhausted, the error is
        permanent, or the backoff would land past the deadline."""
        if attempt + 1 >= self.max_attempts:
            return None
        if not is_transient(error):
            return None
        d = self.backoff_s(attempt, rng)
        if deadline_t is not None and now + d >= deadline_t:
            return None              # never retry past the budget
        return d


class CompletionToken:
    """One logical completion shared by every dispatch attempt of a work
    item.  ``claim()`` returns True exactly once, process-wide: the
    winner delivers the callback; crash-requeues, hedges, and stragglers
    that lose the race fall silent."""

    __slots__ = ("_lock", "_claimed", "winner", "claimed_t")

    def __init__(self):
        self._lock = threading.Lock()
        self._claimed = False
        self.winner: Optional[str] = None
        # monotonic time of the winning claim — attribution reads it to
        # split an exec span at the moment the result actually existed
        self.claimed_t: Optional[float] = None

    @property
    def claimed(self) -> bool:
        return self._claimed

    def claim(self, who: Optional[str] = None) -> bool:
        with self._lock:
            if self._claimed:
                return False
            self._claimed = True
            self.winner = who
            self.claimed_t = _mono()
            return True
