"""Seeded, deterministic fault injection for the executor fleet.  Port
of the reference package's ``serving/faults.py``.

Failure is a first-class, *measurable* event: a :class:`FaultPlan` makes
any executor crash (its thread dies mid-item), hang (straggle for a
configured duration), or throw a typed transient error, at configurable
per-kind rates.  The plan is installed via ``Runtime(fault_plan=...)`` /
``ExecutorPool(fault_injector=...)``; with no plan installed the
production code paths run unmodified (a single ``is None`` check per
item).

Determinism: every decision comes from a per-executor ``random.Random``
seeded by ``(plan.seed, executor_id)``, so a given executor sees the same
fault sequence for the same seed regardless of thread interleaving — the
chaos benchmark and the regression tests replay identical fault
schedules.

The module also derives **straggler-hedging delays** from the profiler's
latency curves: :func:`hedge_delays_from_profile` turns a deployed DAG's
per-op p99 into a per-node hedge delay (fire a backup dispatch once the
primary has taken longer than ``factor`` × p99), and
:func:`install_hedging` wires those delays into the runtime.
"""
from __future__ import annotations

import dataclasses
import random
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.serving.retry import TransientFault


class FaultCrash(BaseException):
    """Raised *outside* the executor's error-handling scope to kill the
    worker thread mid-item — the injected analogue of a process crash.
    Derives from BaseException so no user-level handler can swallow it."""


@dataclasses.dataclass
class FaultSpec:
    """One injectable failure mode.

    ``rate`` is the per-item probability; ``limit`` bounds how many times
    the spec fires in total (``limit=1, rate=1.0`` is the deterministic
    "fail the next item" used by regression tests).  ``classes``
    restricts the spec to executor resource classes (None = all).
    """
    kind: str                        # "crash" | "hang" | "transient"
    rate: float = 0.0
    hang_s: float = 0.2              # straggle duration for kind="hang"
    limit: Optional[int] = None      # max firings (None = unbounded)
    classes: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.kind not in ("crash", "hang", "transient"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclasses.dataclass
class FaultPlan:
    """A seeded schedule of :class:`FaultSpec`\\ s for the fleet."""
    specs: List[FaultSpec] = dataclasses.field(default_factory=list)
    seed: int = 0

    def crash(self, rate: float = 0.0, *, limit: Optional[int] = None,
              classes: Optional[Iterable[str]] = None) -> "FaultPlan":
        return self._add("crash", rate, limit=limit, classes=classes)

    def hang(self, rate: float = 0.0, *, hang_s: float = 0.2,
             limit: Optional[int] = None,
             classes: Optional[Iterable[str]] = None) -> "FaultPlan":
        return self._add("hang", rate, hang_s=hang_s, limit=limit,
                         classes=classes)

    def transient(self, rate: float = 0.0, *, limit: Optional[int] = None,
                  classes: Optional[Iterable[str]] = None) -> "FaultPlan":
        return self._add("transient", rate, limit=limit, classes=classes)

    def _add(self, kind, rate, *, hang_s=0.2, limit=None, classes=None):
        self.specs.append(FaultSpec(
            kind, rate, hang_s=hang_s, limit=limit,
            classes=tuple(classes) if classes else None))
        return self


class FaultInjector:
    """Draws fault decisions for executors from a :class:`FaultPlan`.

    Thread-safe; shared by every executor in a pool.  ``draw`` is called
    once per dequeued work item and returns the fault to apply (first
    matching spec wins) or None.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._rngs: Dict[str, random.Random] = {}
        self._fired: Dict[int, int] = {}         # spec index -> count
        self.counts: Dict[str, int] = {"crash": 0, "hang": 0,
                                       "transient": 0}

    def _rng(self, executor_id: str) -> random.Random:
        rng = self._rngs.get(executor_id)
        if rng is None:
            rng = random.Random(f"{self.plan.seed}/{executor_id}")
            self._rngs[executor_id] = rng
        return rng

    def draw(self, executor_id: str,
             resource_class: str) -> Optional[FaultSpec]:
        """The fault to inject for this item, or None.  One uniform draw
        per (executor, spec) keeps the sequence deterministic per
        executor under any thread interleaving."""
        with self._lock:
            rng = self._rng(executor_id)
            for i, spec in enumerate(self.plan.specs):
                if spec.classes is not None \
                        and resource_class not in spec.classes:
                    continue
                if spec.limit is not None \
                        and self._fired.get(i, 0) >= spec.limit:
                    continue
                if spec.rate <= 0.0 or rng.random() >= spec.rate:
                    continue
                self._fired[i] = self._fired.get(i, 0) + 1
                self.counts[spec.kind] += 1
                return spec
        return None

    def transient_error(self, executor_id: str) -> TransientFault:
        return TransientFault(
            f"injected transient fault on {executor_id}")

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)


# -- straggler hedging delays from the profiler's curves ---------------------

def hedge_delays_from_profile(deployed, profile, *, factor: float = 1.0,
                              floor_s: float = 0.001,
                              batch: int = 1) -> Dict[str, float]:
    """Per-node hedge delays for a deployed DAG: fire a backup dispatch
    once the primary has been out for ``factor`` × the op's measured p99
    at ``batch`` rows.  A replica slower than its own p99 is by
    definition a straggler; waiting that long first keeps the hedge rate
    ~1% under healthy operation (the Clipper/Dean tail-at-scale recipe).

    Returns ``{runtime node name: delay_s}`` for every node whose plan op
    has a measured curve."""
    delays: Dict[str, float] = {}
    for name, node in deployed.dag.nodes.items():
        if node.plan_op_id is None:
            continue
        curve = profile.curves.get(node.plan_op_id)
        if curve is None:
            continue
        p99 = curve.p99_s(batch)
        if p99 <= 0.0:
            continue
        delays[name] = max(floor_s, factor * p99)
    return delays


def install_hedging(runtime, deployed, profile, *, factor: float = 1.0,
                    floor_s: float = 0.001) -> Dict[str, float]:
    """Derive hedge delays from ``profile`` and install them on
    ``runtime`` for ``deployed``'s DAG.  Returns what was installed."""
    delays = hedge_delays_from_profile(deployed, profile, factor=factor,
                                       floor_s=floor_s)
    for node_name, delay_s in delays.items():
        runtime.configure_hedging(deployed.dag.name, node_name, delay_s)
    return delays
