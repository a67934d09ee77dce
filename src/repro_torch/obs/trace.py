"""Low-overhead request tracing: spans on a per-request ``Trace``.  Port
of the reference package's ``obs/trace.py``.

Model
-----
A :class:`Trace` is one request's timeline: a flat list of :class:`Span`
(name, monotonic ``[t0, t1)``, attrs).  Span names carry the node in the
suffix (``queue@stage1``, ``exec@stage1``, ``demux@stage1``); request
boundary spans (``admission``) have no node.  A merged batch emits ONE
batch-level span held by the :class:`Tracer` (not duplicated into every
member trace); member request spans link to it via ``link`` (the batch's
dispatch sequence number), which the Chrome exporter renders as flow
arrows.

Sampling
--------
Recording is cheap (list appends + ``perf_counter`` calls), so every
request gets a live trace while the tracer is enabled; RETENTION is what
is sampled.  At finish a trace is kept when it was **head-sampled**
(deterministic 1-in-N at ``sample_rate``) or when the **tail** says it
is interesting regardless of the coin flip: SLO-missed, errored, shed,
or retried traces are always kept — the traces an operator actually
asks about.  Kept traces live in a bounded ring (old traces fall off),
so steady-state memory is constant.

Scopes
------
Work inside one dispatch (the chain's upload, each of its steps) is
timed live on the executor thread by :func:`scope`.  While the executor
has opened a recorder on the thread (:func:`record_start`, for an item
with traced members), a scope appends a ``<kind>@<node>`` span to it;
the recorded spans ride on the attempt's ``done`` log entry and land on
every traced member beside its ``exec@`` span.  While a
``torch.profiler`` records, a scope also enters a profiler range named
``<kind>@<node>:<op>``, so the device trace carries the program's spans
on its own clock.  The range is a ``_RecordFunctionFast`` (an ordinary
function scope): a ``record_function`` range is a user scope, which the
CUDA profiler mirrors into a ``gpu_user_annotation`` event on the device
track, where a reader of the trace would take it for a kernel.  With
neither consumer on, a scope costs one thread-local read and one read of
the profiler's module flag.

Thread-safety: spans are appended from executor callback threads and
hedge/retry timers; appends are list-atomic under the GIL and the keep
ring is lock-protected.  All timestamps are ``repro_torch.obs.clock.now``
(monotonic) — never wall clock.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from repro_torch.obs.clock import now

_trace_ids = itertools.count(1)

#: event names that flip a trace's tail-keep flags when recorded
_RETRY_EVENTS = frozenset({"retry", "requeue"})
_HEDGE_EVENTS = frozenset({"hedge_launch"})


class Span:
    """One timed region (or instant, when ``t1 == t0``) on a trace."""

    __slots__ = ("name", "t0", "t1", "attrs", "link")

    def __init__(self, name: str, t0: float, t1: float,
                 attrs: Optional[Dict[str, Any]] = None,
                 link: Optional[int] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs or {}
        self.link = link

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    @property
    def node(self) -> Optional[str]:
        """The node a ``kind@node`` span belongs to (None for request-
        boundary spans like ``admission``)."""
        _, sep, node = self.name.partition("@")
        return node if sep else None

    @property
    def kind(self) -> str:
        return self.name.partition("@")[0]

    def to_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "t0": self.t0, "t1": self.t1,
             "attrs": dict(self.attrs)}
        if self.link is not None:
            d["link"] = self.link
        return d

    def __repr__(self):
        return (f"Span({self.name}, {self.duration_s * 1e3:.3f}ms"
                f"{', link=' + str(self.link) if self.link else ''})")


class Trace:
    """One request's timeline.  Created by :meth:`Tracer.start`, carried
    on the request's ``RequestContext``, finished exactly once when the
    request resolves."""

    __slots__ = ("trace_id", "dag", "klass", "t0", "t1", "spans",
                 "sampled", "shed", "shed_reason", "error", "slo_miss",
                 "retried", "hedged", "finished", "deadline_s", "_tracer")

    def __init__(self, tracer: "Tracer", dag: str, klass: str,
                 t0: float, sampled: bool):
        self.trace_id = next(_trace_ids)
        self.dag = dag
        self.klass = klass
        self.t0 = t0
        self.t1: Optional[float] = None
        self.spans: List[Span] = []
        self.sampled = sampled
        self.shed = False
        self.shed_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.slo_miss = False
        self.retried = False
        self.hedged = False
        self.finished = False
        self.deadline_s: Optional[float] = None
        self._tracer = tracer

    # -- recording -----------------------------------------------------------
    def span(self, name: str, t0: float, t1: Optional[float] = None,
             link: Optional[int] = None, **attrs) -> Span:
        s = Span(name, t0, t1 if t1 is not None else now(),
                 attrs or None, link)
        self.spans.append(s)
        return s

    def event(self, name: str, **attrs) -> Span:
        """A zero-duration marker (retry fired, hedge launched, requeue).
        Retry-ish events flip the tail-keep flag: a disturbed request's
        trace is always worth keeping."""
        t = now()
        kind = name.partition("@")[0]
        if kind in _RETRY_EVENTS:
            self.retried = True
        if kind in _HEDGE_EVENTS:
            self.hedged = True
        return self.span(name, t, t, **attrs)

    # -- lifecycle -----------------------------------------------------------
    def finish(self, *, error: Optional[BaseException] = None,
               slo_miss: bool = False, shed: bool = False,
               shed_reason: Optional[str] = None) -> bool:
        """Close the trace and apply the keep policy.  Idempotent (first
        close wins); returns whether the trace was kept."""
        if self.finished:
            return False
        self.finished = True
        self.t1 = now()
        if error is not None:
            self.error = f"{type(error).__name__}: {error}"
        self.slo_miss = self.slo_miss or slo_miss
        self.shed = self.shed or shed
        if shed_reason is not None:
            self.shed_reason = shed_reason
        return self._tracer._finish(self)

    @property
    def kept_reason(self) -> Optional[str]:
        if self.slo_miss:
            return "slo_miss"
        if self.error is not None:
            return "error"
        if self.shed:
            return "shed"
        if self.retried:
            return "retried"
        if self.sampled:
            return "sampled"
        return None

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "dag": self.dag,
                "klass": self.klass, "t0": self.t0, "t1": self.t1,
                "latency_s": self.latency_s,
                "kept_reason": self.kept_reason,
                "slo_miss": self.slo_miss, "shed": self.shed,
                "shed_reason": self.shed_reason, "error": self.error,
                "retried": self.retried, "hedged": self.hedged,
                "deadline_s": self.deadline_s,
                "spans": [s.to_dict() for s in self.spans]}

    def __repr__(self):
        lat = f"{self.latency_s * 1e3:.2f}ms" if self.t1 else "open"
        return (f"Trace(#{self.trace_id} {self.dag}/{self.klass} {lat}, "
                f"{len(self.spans)} spans, keep={self.kept_reason})")


class Tracer:
    """Owns the sampling policy and the bounded rings of kept traces and
    batch-level spans.

    ``sample_rate`` is HEAD sampling: the fraction of requests whose
    trace is kept even when nothing went wrong (deterministic 1-in-N so
    overhead and retention are load-independent, not coin-flip noisy).
    SLO-miss / error / shed / retried traces are kept regardless — the
    tail-based policy, decided at :meth:`Trace.finish`.

    ``enabled=False`` turns the whole subsystem into ``None`` checks on
    the hot path: ``start`` returns None and every instrumentation site
    is gated on it.
    """

    def __init__(self, *, enabled: bool = True, sample_rate: float = 0.0,
                 capacity: int = 256, batch_capacity: Optional[int] = None):
        self.enabled = enabled
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self.capacity = int(capacity)
        self._kept: Deque[Trace] = deque(maxlen=self.capacity)
        # batch spans are shared by N member traces; keep enough that a
        # kept trace's linked batch span is still resolvable at export
        self._batches: Deque[Span] = deque(
            maxlen=batch_capacity or 4 * self.capacity)
        # control-plane events (autoscaler replica changes, blue/green
        # swap phases) ride their own bounded ring
        self._control: Deque[Span] = deque(
            maxlen=batch_capacity or 4 * self.capacity)
        self._lock = threading.Lock()
        self._offered = 0
        self.started = 0
        self.finished = 0
        self.kept_count = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self, dag: str, klass: str = "interactive",
              t0: Optional[float] = None) -> Optional[Trace]:
        if not self.enabled:
            return None
        with self._lock:
            self._offered += 1
            self.started += 1
            # deterministic 1-in-N head sampling: request k is sampled
            # when floor(k*rate) > floor((k-1)*rate) — exactly rate*N of
            # any N consecutive requests, no RNG on the hot path
            r = self.sample_rate
            sampled = r >= 1.0 or (
                r > 0.0 and int(self._offered * r) > int(
                    (self._offered - 1) * r))
        return Trace(self, dag, klass, t0 if t0 is not None else now(),
                     sampled)

    def _finish(self, trace: Trace) -> bool:
        keep = bool(trace.sampled or trace.slo_miss or trace.error
                    or trace.shed or trace.retried)
        with self._lock:
            self.finished += 1
            if keep:
                self.kept_count += 1
                self._kept.append(trace)
        return keep

    # -- batch-level spans ---------------------------------------------------
    def record_batch(self, node: str, t0: float, t1: float,
                     link: int, **attrs) -> Span:
        """ONE span for a merged batch dispatch; member request spans
        point at it via the same ``link`` id."""
        s = Span(f"batch@{node}", t0, t1, attrs or None, link)
        with self._lock:
            self._batches.append(s)
        return s

    # -- control-plane events ------------------------------------------------
    def control_event(self, name: str, t0: Optional[float] = None,
                      t1: Optional[float] = None, **attrs) -> Optional[Span]:
        """A control-plane span (``replan@dag`` phases, ``scale@pool``
        replica changes): not tied to any request, kept in its own
        bounded ring and exported on a separate track — so a during-swap
        p99 blip lines up against the swap phase that caused it.  Instant
        when only ``t0`` (or neither) is given."""
        if not self.enabled:
            return None
        t0 = t0 if t0 is not None else now()
        s = Span(name, t0, t1 if t1 is not None else t0, attrs or None)
        with self._lock:
            self._control.append(s)
        return s

    def control_events(self, kind: Optional[str] = None) -> List[Span]:
        with self._lock:
            spans = list(self._control)
        if kind is not None:
            spans = [s for s in spans if s.kind == kind]
        return spans

    # -- reads ---------------------------------------------------------------
    def kept(self, dag: Optional[str] = None) -> List[Trace]:
        with self._lock:
            traces = list(self._kept)
        if dag is not None:
            traces = [t for t in traces if t.dag == dag]
        return traces

    def batch_spans(self, links: Optional[set] = None) -> List[Span]:
        with self._lock:
            spans = list(self._batches)
        if links is not None:
            spans = [s for s in spans if s.link in links]
        return spans

    def clear(self) -> None:
        with self._lock:
            self._kept.clear()
            self._batches.clear()
            self._control.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"started": self.started, "finished": self.finished,
                    "kept": self.kept_count, "buffered": len(self._kept),
                    "batch_spans": len(self._batches),
                    "control_events": len(self._control)}


# -- scopes ------------------------------------------------------------------

#: this thread's open recorder: ``(node, spans)`` or None
_recorder = threading.local()


def record_start(node: Optional[str]) -> None:
    """Open this thread's recorder for the dispatch about to run on it:
    each :func:`scope` entered until :func:`record_end` records a span
    ``<kind>@<node>``."""
    _recorder.rec = (node or "-", [])


def record_end() -> Optional[List[Span]]:
    """Close this thread's recorder; returns its spans in the order they
    were entered (None when none was open)."""
    rec = getattr(_recorder, "rec", None)
    _recorder.rec = None
    return None if rec is None else rec[1]


class _NoScope:
    """What :func:`scope` returns with neither consumer on: enters
    nothing, records nothing, and reads false."""
    __slots__ = ()

    def __enter__(self) -> "_NoScope":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def note(self, **attrs) -> None:
        pass


_NO_SCOPE = _NoScope()


class _Scope:
    __slots__ = ("_name", "_span", "_spans", "_range")

    def __init__(self, kind: str, op: Optional[str], node: Optional[str],
                 attrs: Dict[str, Any], rec, profiling: bool):
        where = rec[0] if rec is not None else (node or "-")
        self._span = self._spans = self._range = None
        if rec is not None:
            if op is not None:
                attrs["op"] = op
            self._span = Span(f"{kind}@{where}", 0.0, 0.0, attrs)
            self._spans = rec[1]
        self._name = (f"{kind}@{where}:{op}" if op is not None
                      else f"{kind}@{where}") if profiling else None

    def __enter__(self) -> "_Scope":
        if self._name is not None:
            self._range = torch._C._profiler._RecordFunctionFast(self._name)
            self._range.__enter__()
        if self._span is not None:
            self._spans.append(self._span)
            self._span.t0 = now()
        return self

    def __exit__(self, *exc) -> bool:
        if self._span is not None:
            self._span.t1 = now()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def note(self, **attrs) -> None:
        """Add attrs known only once the scoped work ran (a byte count)."""
        if self._span is not None:
            self._span.attrs.update(attrs)


def prepare_profiler() -> None:
    """Make now the imports that starting a ``torch.profiler.profile``
    makes: its ``prepare_trace`` asks ``hasattr(torch, "_inductor")``,
    which imports ``torch._inductor`` lazily, and with it
    ``torch._dynamo`` and torch.distributed's FSDP and DTensor.  Made
    while requests are served, that import competes with the serving
    threads for the interpreter: on an H100 host it held a profile's
    start back 10 to 24 s, so a device trace taken on demand began that
    late."""
    import torch._inductor.config  # noqa: F401


def scope(kind: str, op: Optional[str] = None, *, node: Optional[str] = None,
          span: bool = True, **attrs):
    """A context manager timing one piece of a dispatch's work (see
    Scopes in the module docstring).  ``node`` names where it runs when
    no recorder is open (the recorder's node wins); ``span=False`` makes
    it a profiler range only.  The manager reads false when it records
    nothing, so a caller computes attrs for :meth:`note` only when some
    consumer is on."""
    rec = getattr(_recorder, "rec", None) if span else None
    profiling = _autograd_profiler._is_profiler_enabled
    if rec is None and not profiling:
        return _NO_SCOPE
    return _Scope(kind, op, node, attrs, rec, profiling)
