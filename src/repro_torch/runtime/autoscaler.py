"""Queue-depth autoscaler (paper §5.1.3 / Fig 6).  Port of the
reference package's ``runtime/autoscaler.py``.

Monitors per-function pending work; adds replicas for saturated functions
and trims idle over-provisioned ones, leaving slack (the paper's observed
behavior: a couple of spare replicas after a spike settles).

Two control modes per function:

* **target mode** — an optimizer-suggested replica count set via
  ``set_target`` (the SLO controller's M/M/c ``c`` for the measured
  arrival rate): scale up toward the target immediately, trim (with
  hysteresis) anything beyond ``target + slack``.
* **depth heuristic** — the original queue-depth rule, used for
  functions with no target.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from repro_torch.runtime.executor import ExecutorPool


@dataclasses.dataclass
class AutoscalerConfig:
    interval_s: float = 0.25
    scale_up_depth: float = 2.0      # queued per replica before scaling up
    scale_up_count: int = 4          # replicas added per tick when saturated
    scale_down_idle: float = 0.2     # avg depth per replica to scale down
    min_replicas: int = 1
    max_replicas: int = 64
    slack: int = 2                   # keep this many spares


class Autoscaler:
    def __init__(self, pool: ExecutorPool, functions: Dict[str, str],
                 cfg: Optional[AutoscalerConfig] = None, *, tracer=None):
        """functions: fname -> resource_class to manage.  ``tracer`` (a
        ``repro_torch.obs.trace.Tracer``) receives a control-plane event per
        replica add/remove/replace, so scaling actions line up against
        request latency in trace exports."""
        self.pool = pool
        self.functions = functions
        self.tracer = tracer
        self.cfg = cfg or AutoscalerConfig()
        self._stop = False
        self.history: List[Dict[str, int]] = []
        self._idle_ticks: Dict[str, int] = {f: 0 for f in functions}
        self._targets: Dict[str, int] = {}
        self._targets_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop = True

    # -- optimizer-suggested targets (SLO controller hook) --------------------
    def set_target(self, fname: str, replicas: int) -> None:
        """Pin ``fname``'s replica count to an optimizer-suggested target
        (clamped to the configured bounds).  Overrides the queue-depth
        heuristic until ``clear_target``."""
        with self._targets_lock:
            self._targets[fname] = max(self.cfg.min_replicas,
                                       min(int(replicas),
                                           self.cfg.max_replicas))

    def clear_target(self, fname: str) -> None:
        with self._targets_lock:
            self._targets.pop(fname, None)

    def _event(self, action: str, fname: str, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.control_event(f"scale@{fname}", action=action,
                                      **attrs)

    def target(self, fname: str) -> Optional[int]:
        with self._targets_lock:
            return self._targets.get(fname)

    def _tick_target(self, fname: str, rclass: str, n: int,
                     target: int) -> None:
        """Converge toward the target: scale up fast (bounded per tick),
        trim anything beyond ``target + slack`` slowly (hysteresis), so a
        spike's replicas settle with the paper's observed slack."""
        c = self.cfg
        if n < target:
            added = min(c.scale_up_count, target - n)
            for _ in range(added):
                self.pool.add_replica(fname, rclass)
            self._event("replica_add", fname, count=added, reason="target",
                        replicas=n + added, target=target)
            self._idle_ticks[fname] = 0
        elif n > target + c.slack:
            self._idle_ticks[fname] += 1
            if self._idle_ticks[fname] >= 4:      # hysteresis
                self.pool.remove_replica(fname)
                self._event("replica_remove", fname, count=1,
                            reason="target", replicas=n - 1, target=target)
                self._idle_ticks[fname] = 0
        else:
            self._idle_ticks[fname] = 0

    def _tick_depth(self, fname: str, rclass: str, n: int) -> None:
        """The original queue-depth heuristic (no target set)."""
        c = self.cfg
        depth = self.pool.queue_depth(fname, rclass)
        per = depth / n
        if per > c.scale_up_depth and n < c.max_replicas:
            added = min(c.scale_up_count, c.max_replicas - n)
            for _ in range(added):
                self.pool.add_replica(fname, rclass)
            self._event("replica_add", fname, count=added, reason="depth",
                        replicas=n + added, depth=depth)
            self._idle_ticks[fname] = 0
        elif per < c.scale_down_idle and n > c.min_replicas + c.slack:
            self._idle_ticks[fname] += 1
            if self._idle_ticks[fname] >= 8:       # hysteresis
                self.pool.remove_replica(fname)
                self._event("replica_remove", fname, count=1,
                            reason="idle", replicas=n - 1, depth=depth)
                self._idle_ticks[fname] = 0
        else:
            self._idle_ticks[fname] = 0

    def _loop(self):
        while not self._stop:
            snapshot = {}
            for fname, rclass in self.functions.items():
                # failed-replica floor: replica_count counts HEALTHY
                # executors, so a crashed/wedged worker shows up here as a
                # shortfall — replace it even when the queue is empty (a
                # dead replica with no backlog would otherwise never
                # trigger the depth heuristic, and the next burst would
                # land on a short fleet).  Only for functions that HAVE an
                # assignment: creating a first one would narrow
                # candidates() away from the pool-wide default executors.
                if fname in self.pool.assignment:
                    n0 = self.pool.replica_count(fname)
                    replaced = 0
                    while n0 < self.cfg.min_replicas:
                        self.pool.add_replica(fname, rclass)
                        n0 += 1
                        replaced += 1
                    if replaced:
                        self._event("replica_replace", fname,
                                    count=replaced, reason="failed_floor",
                                    replicas=n0)
                n = max(1, self.pool.replica_count(fname))
                target = self.target(fname)
                if target is not None:
                    self._tick_target(fname, rclass, n, target)
                else:
                    self._tick_depth(fname, rclass, n)
                snapshot[fname] = self.pool.replica_count(fname)
            self.history.append(snapshot)
            time.sleep(self.cfg.interval_s)
