"""Bounded metric primitives: log-bucketed histograms and windowed
counters.  Port of the reference package's ``obs/metrics.py``.

The runtime's original metric store appended every observation to a
per-key python list.  Lists answer "give me the raw series" but make
every percentile read copy the whole series under the metrics lock, and
rate reads re-scan thousands of timestamps per controller tick.  The two
shapes of series get the two right structures:

* **latency-valued** series (``*_s``, ``*/size``): a :class:`Histogram`
  — log-spaced buckets, O(1) record, O(buckets) snapshot, and snapshots
  MERGE (sum counts bucket-wise), so per-node histograms roll up to a
  fleet view without raw data.
* **rate-valued** series (``*_t`` timestamp streams): a
  :class:`WindowedCounter` — counts binned into coarse time slots on the
  monotonic clock, so "events in the last W seconds" is a sum over
  ~W/slot integers instead of a scan over every timestamp ever kept.

Both are lock-free at this layer (callers serialize; the runtime records
under its metrics lock) and strictly bounded in memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence


class Histogram:
    """Log-bucketed histogram for positive-ish values (latencies, sizes).

    Bucket ``i`` holds values in ``[lo * growth**i, lo * growth**(i+1))``;
    values below ``lo`` land in bucket 0, values above the top in the
    overflow bucket.  With the defaults (1us floor, 100s ceiling, 1.25x
    growth) that is ~83 buckets at <=12.5% relative quantile error —
    plenty for "which stage ate the budget" questions.
    """

    __slots__ = ("lo", "growth", "_log_growth", "counts", "n",
                 "total", "vmin", "vmax")

    N_BUCKETS = 1 + int(math.log(100.0 / 1e-6) / math.log(1.25)) + 1

    def __init__(self, lo: float = 1e-6, growth: float = 1.25):
        self.lo = lo
        self.growth = growth
        self._log_growth = math.log(growth)
        self.counts = [0] * self.N_BUCKETS
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = 1 + int(math.log(v / self.lo) / self._log_growth)
        return min(i, self.N_BUCKETS - 1)

    def record(self, v: float) -> None:
        self.counts[self._bucket(v)] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def _bucket_hi(self, i: int) -> float:
        return self.lo * self.growth ** i

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-th percentile (<=12.5%
        relative overestimate by construction); exact for min/max ends."""
        if self.n == 0:
            return 0.0
        target = max(1, math.ceil(self.n * p / 100.0))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return min(self._bucket_hi(i), self.vmax)
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def snapshot(self) -> "HistogramSnapshot":
        return HistogramSnapshot(lo=self.lo, growth=self.growth,
                                 counts=list(self.counts), n=self.n,
                                 total=self.total,
                                 vmin=self.vmin if self.n else 0.0,
                                 vmax=self.vmax if self.n else 0.0)


@dataclasses.dataclass
class HistogramSnapshot:
    """An immutable, MERGEABLE copy of a histogram's state.  Merging sums
    counts bucket-wise — per-replica or per-node snapshots roll up to an
    aggregate with the same quantile error bound."""
    lo: float
    growth: float
    counts: List[int]
    n: int
    total: float
    vmin: float
    vmax: float

    def merge(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        if (other.lo, other.growth) != (self.lo, self.growth):
            raise ValueError("cannot merge histograms with different "
                             "bucket layouts")
        return HistogramSnapshot(
            lo=self.lo, growth=self.growth,
            counts=[a + b for a, b in zip(self.counts, other.counts)],
            n=self.n + other.n, total=self.total + other.total,
            vmin=min(self.vmin, other.vmin) if self.n and other.n
            else (self.vmin if self.n else other.vmin),
            vmax=max(self.vmax, other.vmax))

    def percentile(self, p: float) -> float:
        if self.n == 0:
            return 0.0
        target = max(1, math.ceil(self.n * p / 100.0))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return min(self.lo * self.growth ** i, self.vmax)
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def summary(self) -> Dict[str, float]:
        return {"n": self.n, "mean": self.mean,
                "p50": self.percentile(50), "p99": self.percentile(99),
                "min": self.vmin, "max": self.vmax}

    @staticmethod
    def merge_all(snaps: Sequence["HistogramSnapshot"]) \
            -> Optional["HistogramSnapshot"]:
        out: Optional[HistogramSnapshot] = None
        for s in snaps:
            out = s if out is None else out.merge(s)
        return out


class WindowedCounter:
    """Event counts binned into fixed-width time slots on the monotonic
    clock — answers "how many events in the last W seconds" in
    O(W / slot) regardless of total event volume.

    ``note(t)`` bins by the EVENT timestamp (callers pass the same
    monotonic stamp they would have appended to a ``*_t`` list), so
    series recorded with synthetic/backdated stamps still window
    correctly.  Slots older than ``horizon_s`` are pruned on write;
    memory is bounded by ``horizon_s / slot_s`` live slots.
    """

    __slots__ = ("slot_s", "horizon_s", "_slots", "total")

    def __init__(self, slot_s: float = 0.25, horizon_s: float = 120.0):
        self.slot_s = float(slot_s)
        self.horizon_s = float(horizon_s)
        self._slots: Dict[int, int] = {}
        self.total = 0

    def note(self, t: float, n: int = 1) -> None:
        slot = int(t / self.slot_s)
        self._slots[slot] = self._slots.get(slot, 0) + n
        self.total += n
        # amortized prune: drop slots past the horizon behind this write
        if len(self._slots) > 2 * int(self.horizon_s / self.slot_s):
            cut = slot - int(self.horizon_s / self.slot_s)
            for s in [s for s in self._slots if s < cut]:
                del self._slots[s]

    def count(self, window_s: float, now: float) -> int:
        """Events with timestamp in ``(now - window_s, now]`` (slot
        granularity: a slot counts when its START lies in the window)."""
        lo = int((now - window_s) / self.slot_s)
        hi = int(now / self.slot_s)
        if hi - lo > len(self._slots):
            return sum(c for s, c in self._slots.items() if lo <= s <= hi)
        return sum(self._slots.get(s, 0) for s in range(lo, hi + 1))

    def rate(self, window_s: float, now: float) -> float:
        return self.count(window_s, now) / max(window_s, 1e-9)
