"""Observability: end-to-end request tracing, histogram metrics, and
SLO-miss attribution.  Port of the reference package's ``obs/``.

The serving stack makes many latency-affecting decisions per request
(admission shed/degrade, batch merging and EDF reordering, executor
queueing, retries, hedges, failover requeues, blue/green swaps).  This
package records WHERE each millisecond went so the SLO controller — and
a human — can answer "why did this request miss its deadline?":

* :mod:`repro_torch.obs.trace` — ``Trace``/``Span``/``Tracer``:
  monotonic-clock spans on a per-request trace carried by
  ``RequestContext``; head sampling plus tail-based always-keep for
  SLO-miss/error/shed/retried traces; bounded ring buffer of kept traces.
* :mod:`repro_torch.obs.metrics` — log-bucketed mergeable ``Histogram``
  and time-``WindowedCounter``, the bounded replacements for unbounded
  per-key value lists.
* :mod:`repro_torch.obs.export` — JSON and Chrome trace-event
  (``chrome://tracing`` / Perfetto) export of kept traces.
* :mod:`repro_torch.obs.attribution` — folds kept traces into a per-node
  queue/service/transfer/retry/hedge breakdown; an SLO miss names its
  dominant contributor.
* :mod:`repro_torch.obs.clock` — THE clock for rate-window timestamps
  (monotonic); every ``*_t`` metric series and every window anchor must
  use it, or rates silently window wall-clock values against monotonic
  anchors.
* :mod:`repro_torch.obs.keys` — the canonical metric-series name
  registry: every recorded key is built by a formatter here, with the
  reference's strings.
"""
from repro_torch.obs import keys
from repro_torch.obs.attribution import Attribution, NodeBreakdown, attribute
from repro_torch.obs.clock import now
from repro_torch.obs.export import (export_chrome, to_chrome_events, to_json,
                                    write_chrome)
from repro_torch.obs.metrics import (Histogram, HistogramSnapshot,
                                     WindowedCounter)
from repro_torch.obs.trace import Span, Trace, Tracer

__all__ = [
    "Attribution", "NodeBreakdown", "attribute", "keys", "now",
    "export_chrome", "to_chrome_events", "to_json", "write_chrome",
    "Histogram", "HistogramSnapshot", "WindowedCounter",
    "Span", "Trace", "Tracer",
]
