"""Anna-like KVS + per-executor caches (paper §2.3).

``KVS`` is the durable store (network cost on every access).  Each executor
owns a ``CacheClient``: reads hit the local cache for free; misses fetch from
the KVS (paying the modeled transfer) and populate the cache with LRU
eviction.  The scheduler asks ``cached_where(key)`` for locality-aware
placement (paper §4: Data Locality via Dynamic Dispatch).
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional, Set

from repro_torch.runtime.netmodel import NetModel, nbytes


class KVS:
    #: retention bound for the applied-write journal (put_once keys)
    APPLIED_CAP = 65536

    def __init__(self, net: Optional[NetModel] = None):
        self.net = net or NetModel()
        self._data: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # which executor caches (likely) hold each key — the scheduler's index
        self._cache_index: Dict[str, Set[str]] = collections.defaultdict(set)
        # idempotence journal: tokens of writes already applied, so an
        # at-least-once redispatch (crash requeue, straggler hedge)
        # re-running an operator cannot double-apply its writes
        self._applied: "collections.OrderedDict[Any, None]" = \
            collections.OrderedDict()
        self.stats = collections.Counter()

    def put(self, key: str, value: Any, *, charge: bool = True):
        if charge:
            self.net.charge(nbytes(value))
        with self._lock:
            self._data[key] = value
            self.stats["puts"] += 1

    def put_once(self, token: Any, key: str, value: Any, *,
                 charge: bool = True) -> bool:
        """Apply a write exactly once per ``token`` (the dispatch key of
        the executing work item + the KVS key).  Returns False — and
        applies nothing, charges nothing — when the token was already
        applied by another execution attempt of the same logical item."""
        with self._lock:
            if token in self._applied:
                self.stats["dedup_puts"] += 1
                return False
            self._applied[token] = None
            while len(self._applied) > self.APPLIED_CAP:
                self._applied.popitem(last=False)
        self.put(key, value, charge=charge)
        return True

    def get(self, key: str, *, charge: bool = True) -> Any:
        with self._lock:
            value = self._data[key]
            self.stats["gets"] += 1
        if charge:
            self.net.charge(nbytes(value))
        return value

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    # -- locality index ------------------------------------------------------
    def note_cached(self, key: str, executor_id: str):
        with self._lock:
            self._cache_index[key].add(executor_id)

    def note_evicted(self, key: str, executor_id: str):
        with self._lock:
            self._cache_index[key].discard(executor_id)

    def cached_where(self, key: str) -> Set[str]:
        with self._lock:
            return set(self._cache_index.get(key, ()))


class CacheClient:
    """Executor-local cache over the KVS (LRU by bytes)."""

    def __init__(self, kvs: KVS, executor_id: str,
                 capacity_bytes: int = 2 << 30):
        self.kvs = kvs
        self.executor_id = executor_id
        self.capacity = capacity_bytes
        self._cache: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Any:
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                self.hits += 1
                return self._cache[key]
        value = self.kvs.get(key)          # modeled network cost
        self.misses += 1
        self._insert(key, value)
        return value

    def put(self, key: str, value: Any):
        """Write-through."""
        self.kvs.put(key, value)
        self._insert(key, value)

    def observe(self, key: str, value: Any):
        """Populate the local cache WITHOUT writing through — used after
        an idempotent ``KVS.put_once`` already applied (or deduplicated)
        the durable write, so this executor still serves reads locally."""
        self._insert(key, value)

    def _insert(self, key: str, value: Any):
        size = nbytes(value)
        with self._lock:
            if key in self._cache:
                self._bytes -= nbytes(self._cache[key])
            self._cache[key] = value
            self._cache.move_to_end(key)
            self._bytes += size
            while self._bytes > self.capacity and len(self._cache) > 1:
                k, v = self._cache.popitem(last=False)
                self._bytes -= nbytes(v)
                self.kvs.note_evicted(k, self.executor_id)
        self.kvs.note_cached(key, self.executor_id)

    def holds(self, key: str) -> bool:
        with self._lock:
            return key in self._cache
