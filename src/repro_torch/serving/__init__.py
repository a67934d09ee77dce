"""Serving-layer building blocks: request batching, overload protection
(admission control, request classes, deadlines), and fault tolerance
(typed retries, fault injection, straggler hedging), and the model
engine.  Port of the reference package's ``serving/``.

* :mod:`repro_torch.serving.batcher` — deadline-aware micro-batching
  (``Batcher``): adaptive coalescing windows, earliest-deadline-first
  backlog ordering, pre-dispatch expiry;
* :mod:`repro_torch.serving.admission` — the front-door gate
  (``AdmissionController``): per-class token buckets, the
  priority-ordered estimator gate (``profiling.estimator``), live
  executor queue depth priced per queued item, typed ``Overloaded`` /
  ``DeadlineExceeded`` fast-fail errors, and ``DegradePolicy``-based
  degraded serving for low-priority traffic;
* :mod:`repro_torch.serving.retry` — the ``Transient`` / ``Permanent``
  error taxonomy, deadline-budget-aware ``RetryPolicy`` backoff, and the
  ``CompletionToken`` exactly-once-delivery primitive for at-least-once
  redispatch;
* :mod:`repro_torch.serving.faults` — seeded deterministic fault
  injection (``FaultPlan`` / ``FaultInjector``: crash, hang, transient) and
  profile-derived straggler-hedge delays (``install_hedging``);
* :mod:`repro_torch.serving.engine` — ``ServingEngine`` (prefill, decode
  and ``generate``) and ``make_engine``.
"""
from repro_torch.serving.admission import (AdmissionController,
                                           ClassPolicy, DeadlineExceeded,
                                           Decision, Overloaded,
                                           TokenBucket, default_classes)
from repro_torch.serving.batcher import Batcher, BatchItem
from repro_torch.serving.engine import ServingEngine, make_engine
from repro_torch.serving.faults import (FaultInjector, FaultPlan, FaultSpec,
                                        hedge_delays_from_profile,
                                        install_hedging)
from repro_torch.serving.retry import (CompletionToken, ExecutorLost,
                                       Permanent, RetryPolicy, Transient,
                                       TransientFault, is_transient)

__all__ = [
    "AdmissionController", "Batcher", "BatchItem", "ClassPolicy",
    "CompletionToken", "DeadlineExceeded", "Decision", "ExecutorLost",
    "FaultInjector", "FaultPlan", "FaultSpec", "Overloaded", "Permanent",
    "RetryPolicy", "ServingEngine", "TokenBucket", "Transient",
    "TransientFault", "default_classes", "hedge_delays_from_profile",
    "install_hedging", "is_transient", "make_engine",
]
