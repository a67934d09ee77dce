"""Canonical metric-series names (the obs key registry).  Port of the
reference package's ``obs/keys.py``: every string here equals the
reference's, because the SLO controller and the static verifier (both
still to be ported) read the series by these names.

Every series the runtime records is built through a formatter here, so
the name grammar lives in ONE place instead of inline f-strings spread
across ``runtime.py``/``admission.py`` — and the static verifier's CF401
lint checks every *recorded* key against :func:`known_key`, catching the
typo'd series that would otherwise just accumulate unread.

Grammar (``{}`` are caller-supplied path segments; node names may
themselves contain ``/``):

* ``dag/{dag}/{series}`` — per-DAG request stream
  (:data:`DAG_SERIES`)
* ``batch/{dag}/{node}/{series}`` (or ``batch/{node}/...`` for an
  unnamed DAG) — per-node batcher stream (:data:`BATCH_SERIES`)
* ``admission/{dag}/{class}/{series}`` — per-request-class gate
  outcomes (:data:`ADMISSION_SERIES`)
* ``faults/{kind}_t`` — injected-fault events (:data:`FAULT_KINDS`),
  plus :data:`FAULT_REQUEUED`
* ``replan/rollback`` — blue/green swap-backs
  (:data:`REPLAN_ROLLBACK`)

``*_t`` series are event timestamps (windowed counters); the rest are
value histograms (``Runtime.record_metric`` routes on the suffix).
New series: add the pattern here (or :func:`register_series` at
runtime) so the lint recognizes it.
"""
from __future__ import annotations

import re
from typing import List

# -- per-DAG request stream -------------------------------------------------

DAG_SERIES = ("request_t", "latency_s", "shed_t", "expired_t",
              "shed_latency_s", "error_latency_s", "error_t",
              "retry_t", "hedge_t")


def dag(dag_name: str, series: str) -> str:
    if series not in DAG_SERIES:
        raise ValueError(f"unknown dag series {series!r}")
    return f"dag/{dag_name}/{series}"


# -- per-node batcher stream ------------------------------------------------

BATCH_SERIES = ("size", "latency_s", "exec_s", "expired_t")


def batch_prefix(dag_name: str, node: str) -> str:
    """The per-node series prefix; generations of one DAG share it (the
    controller reads one continuous signal across a blue/green swap)."""
    return f"batch/{dag_name}/{node}" if dag_name else f"batch/{node}"


def batch(prefix: str, series: str) -> str:
    """``prefix`` is a :func:`batch_prefix` (node names contain ``/``,
    so the prefix is built once and reused per series)."""
    if series not in BATCH_SERIES:
        raise ValueError(f"unknown batch series {series!r}")
    return f"{prefix}/{series}"


# -- admission gate outcomes ------------------------------------------------

ADMISSION_SERIES = ("shed_t", "degraded_t")


def admission(dag_name: str, klass: str, series: str) -> str:
    if series not in ADMISSION_SERIES:
        raise ValueError(f"unknown admission series {series!r}")
    return f"admission/{dag_name}/{klass}/{series}"


#: the admission controller's internal per-request-class counters
#: (``gate.counters``) — not runtime metric series, but the same
#: single-source-of-truth rule
GATE_EVENTS = ("offered", "shed", "degraded", "admitted",
               "hedge_offered", "hedge_suppressed", "hedge_admitted")


def gate_counter(klass: str, event: str) -> str:
    if event not in GATE_EVENTS:
        raise ValueError(f"unknown gate event {event!r}")
    return f"{klass}/{event}"


# -- fault injection / replanning ------------------------------------------

FAULT_KINDS = ("crash", "wedge")
FAULT_REQUEUED = "faults/requeued_t"
REPLAN_ROLLBACK = "replan/rollback"


def fault(kind: str) -> str:
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}")
    return f"faults/{kind}_t"


# -- the registry lint ------------------------------------------------------

_PATTERNS: List[re.Pattern] = [
    re.compile(r"\Adag/.+/(" + "|".join(DAG_SERIES) + r")\Z"),
    re.compile(r"\Abatch/.+/(" + "|".join(BATCH_SERIES) + r")\Z"),
    re.compile(r"\Aadmission/[^/]+/[^/]+/("
               + "|".join(ADMISSION_SERIES) + r")\Z"),
    re.compile(r"\Afaults/(" + "|".join(FAULT_KINDS) + r")_t\Z"),
    re.compile(re.escape(FAULT_REQUEUED) + r"\Z"),
    re.compile(re.escape(REPLAN_ROLLBACK) + r"\Z"),
]


def register_series(pattern: str) -> None:
    """Teach the lint a new series shape (a full-match regex)."""
    _PATTERNS.append(re.compile(pattern))


def known_key(key: str) -> bool:
    """Does ``key`` match any registered series pattern?  The CF401
    lint calls this for every key the runtime actually recorded."""
    return any(p.fullmatch(key) for p in _PATTERNS)
