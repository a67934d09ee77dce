"""Trace exporters: plain JSON and Chrome trace-event format.  Port of
the reference package's ``obs/export.py``.

The Chrome trace-event output loads directly in ``chrome://tracing`` or
https://ui.perfetto.dev: one "process" holds the request tracks (one
thread-track per kept trace), a second holds the batcher tracks (one per
node) where the ONE-span-per-merged-batch events live, and flow arrows
connect each request's ``exec@node`` span to the batch span that served
it (the ``link`` id).  Timestamps are microseconds relative to the
earliest exported span, so traces from the process-local monotonic clock
render at t=0.  A third process holds the control-plane track —
autoscaler replica changes and blue/green swap phases — so a during-swap
p99 blip in the request tracks lines up against the control event that
caused it.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.obs.trace import Span, Trace

_REQ_PID = 1
_BATCH_PID = 2
_CONTROL_PID = 3


def to_json(traces: Iterable[Trace], indent: Optional[int] = None) -> str:
    return json.dumps([t.to_dict() for t in traces], indent=indent)


def _clean(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-serializable copy of span attrs (tuples of executor ids and
    floats survive; anything exotic is repr'd)."""
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [x if isinstance(x, (str, int, float, bool))
                      or x is None else repr(x) for x in v]
        else:
            out[k] = repr(v)
    return out


def to_chrome_events(traces: Sequence[Trace],
                     batch_spans: Sequence[Span] = (),
                     control_spans: Sequence[Span] = ()) \
        -> List[Dict[str, Any]]:
    """Flatten traces + batch spans + control-plane spans into a
    chrome://tracing event list."""
    events: List[Dict[str, Any]] = []
    all_t0 = [s.t0 for t in traces for s in t.spans] + \
        [t.t0 for t in traces] + [s.t0 for s in batch_spans] + \
        [s.t0 for s in control_spans]
    if not all_t0:
        return events
    base = min(all_t0)

    def us(t: float) -> float:
        return (t - base) * 1e6

    events.append({"ph": "M", "name": "process_name", "pid": _REQ_PID,
                   "args": {"name": "requests"}})
    events.append({"ph": "M", "name": "process_name", "pid": _BATCH_PID,
                   "args": {"name": "batchers"}})
    if control_spans:
        events.append({"ph": "M", "name": "process_name",
                       "pid": _CONTROL_PID,
                       "args": {"name": "control-plane"}})

    node_tids: Dict[str, int] = {}
    for t in traces:
        tid = t.trace_id
        label = f"req#{t.trace_id} {t.dag}/{t.klass}"
        if t.kept_reason:
            label += f" [{t.kept_reason}]"
        events.append({"ph": "M", "name": "thread_name", "pid": _REQ_PID,
                       "tid": tid, "args": {"name": label}})
        # the whole-request envelope
        if t.t1 is not None:
            events.append({
                "ph": "X", "name": f"request:{t.dag}", "cat": "request",
                "pid": _REQ_PID, "tid": tid, "ts": us(t.t0),
                "dur": max(0.0, (t.t1 - t.t0) * 1e6),
                "args": {"klass": t.klass, "slo_miss": t.slo_miss,
                         "shed": t.shed, "error": t.error,
                         "kept": t.kept_reason}})
        for s in t.spans:
            ev = {"ph": "X", "name": s.name, "cat": s.kind,
                  "pid": _REQ_PID, "tid": tid, "ts": us(s.t0),
                  "dur": max(0.0, s.duration_s * 1e6),
                  "args": _clean(s.attrs)}
            events.append(ev)
            if s.link is not None:
                # flow arrow: this request span was served by batch
                # dispatch `link` — the "f" end; the batch span emits "s"
                events.append({"ph": "f", "bp": "e", "cat": "batch-link",
                               "name": "batch", "id": int(s.link),
                               "pid": _REQ_PID, "tid": tid,
                               "ts": us(s.t0) + 1})
    for s in batch_spans:
        node = s.node or "batch"
        tid = node_tids.setdefault(node, 1000 + len(node_tids))
        if tid == 1000 + len(node_tids) - 1:
            events.append({"ph": "M", "name": "thread_name",
                           "pid": _BATCH_PID, "tid": tid,
                           "args": {"name": f"batcher:{node}"}})
        events.append({"ph": "X", "name": s.name, "cat": "batch",
                       "pid": _BATCH_PID, "tid": tid, "ts": us(s.t0),
                       "dur": max(0.0, s.duration_s * 1e6),
                       "args": _clean(s.attrs)})
        if s.link is not None:
            events.append({"ph": "s", "cat": "batch-link", "name": "batch",
                           "id": int(s.link), "pid": _BATCH_PID,
                           "tid": tid, "ts": us(s.t0)})
    control_tids: Dict[str, int] = {}
    for s in control_spans:
        # one thread-track per event kind (replan, scale, ...); a
        # zero-duration span renders as an instant marker
        kind = s.kind
        if kind not in control_tids:
            control_tids[kind] = 2000 + len(control_tids)
            events.append({"ph": "M", "name": "thread_name",
                           "pid": _CONTROL_PID, "tid": control_tids[kind],
                           "args": {"name": f"control:{kind}"}})
        tid = control_tids[kind]
        if s.duration_s > 0.0:
            events.append({"ph": "X", "name": s.name, "cat": "control",
                           "pid": _CONTROL_PID, "tid": tid,
                           "ts": us(s.t0),
                           "dur": max(0.0, s.duration_s * 1e6),
                           "args": _clean(s.attrs)})
        else:
            events.append({"ph": "i", "name": s.name, "cat": "control",
                           "pid": _CONTROL_PID, "tid": tid,
                           "ts": us(s.t0), "s": "g",
                           "args": _clean(s.attrs)})
    return events


def write_chrome(path: str, traces: Sequence[Trace],
                 batch_spans: Sequence[Span] = (),
                 control_spans: Sequence[Span] = ()) -> int:
    """Write a chrome://tracing / Perfetto-loadable JSON file; returns
    the number of events written."""
    events = to_chrome_events(traces, batch_spans, control_spans)
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)


def export_chrome(tracer, path: str, dag: Optional[str] = None) -> int:
    """Export a tracer's kept traces (optionally one DAG's) plus the
    batch spans they link to and every control-plane event."""
    traces = tracer.kept(dag)
    links = {s.link for t in traces for s in t.spans if s.link is not None}
    control = getattr(tracer, "control_events", lambda: [])()
    return write_chrome(path, traces, tracer.batch_spans(links), control)
