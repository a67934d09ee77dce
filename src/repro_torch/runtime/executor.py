"""Executor pool: the FaaS workers (Cloudburst executor analogue).  Port of
the subset of the reference package's ``runtime/executor.py`` that the
serving path uses.

Each ``Executor`` is one worker thread with a local cache; it executes
function invocations serially.  ``resource_class`` partitions the pool
(paper §4: hardware-aware placement — "gpu" executors model
accelerator-attached workers).  Fault injection, the heartbeat failure
detector, requeueing, completion tokens and replica assignment are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.table import copy_capture_end, copy_capture_start
from repro_torch.runtime.kvs import KVS, CacheClient
from repro_torch.runtime.netmodel import NetModel, nbytes

_exec_ids = itertools.count()


@dataclasses.dataclass
class WorkItem:
    fn: Callable
    tables: List[Any]
    produced_on: List[Optional[str]]     # executor id per input (for net cost)
    callback: Callable                   # callback(result|None, error|None, executor_id)
    enqueue_t: float = dataclasses.field(default_factory=time.perf_counter)
    # filled in by the executor before the callback fires: queueing delay
    # vs pure execution time
    queue_s: Optional[float] = None
    exec_s: Optional[float] = None
    # host<->device copy counts captured around THIS item's execution
    copies: Optional[Dict[str, int]] = None


class ExecutionContext:
    """Passed to operators: KVS reads via the executor's cache (the
    ``Lookup`` operator)."""

    def __init__(self, executor: "Executor"):
        self.executor = executor
        self.kvs = executor.cache.kvs

    def kvs_get(self, key: str):
        return self.executor.cache.get(key)


class Executor:
    def __init__(self, kvs: KVS, net: NetModel, resource_class: str = "cpu",
                 cache_bytes: int = 2 << 30):
        self.id = f"{resource_class}-exec-{next(_exec_ids)}"
        self.resource_class = resource_class
        self.net = net
        self.cache = CacheClient(kvs, self.id, cache_bytes)
        self.q: "queue.Queue[WorkItem]" = queue.Queue()
        self._stop = False
        self.busy = False
        self.completed = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.id)
        self._thread.start()

    @property
    def load(self) -> int:
        return self.q.qsize() + (1 if self.busy else 0)

    def submit(self, item: WorkItem):
        if self._stop:
            raise RuntimeError(f"{self.id} is stopped")
        self.q.put(item)

    def _run(self):
        while not self._stop:
            try:
                item = self.q.get(timeout=0.05)
            except queue.Empty:
                continue
            self.busy = True
            t_start = time.perf_counter()
            item.queue_s = t_start - item.enqueue_t
            try:
                self.net.charge_invoke()   # FaaS invocation overhead
                # charge network for inputs shipped from other executors
                for t, src in zip(item.tables, item.produced_on):
                    if src is not None and src != self.id:
                        self.net.charge(nbytes(t))
                copy_capture_start()
                try:
                    result = item.fn(item.tables, ExecutionContext(self))
                finally:
                    item.copies = copy_capture_end()
                item.exec_s = time.perf_counter() - t_start
                item.callback(result, None, self.id)
            except BaseException as e:
                item.exec_s = time.perf_counter() - t_start
                item.callback(None, e, self.id)
            finally:
                self.busy = False
                self.completed += 1

    def drain(self) -> List[WorkItem]:
        """Pop everything still queued (items the worker has not started)."""
        items: List[WorkItem] = []
        while True:
            try:
                items.append(self.q.get_nowait())
            except queue.Empty:
                return items

    def stop(self, timeout: float = 5.0) -> List[WorkItem]:
        """Stop the worker, wait for its thread, and return its
        undispatched queue (callers fail those items)."""
        self._stop = True
        left = self.drain()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout)
        return left


class ExecutorPool:
    """All executors, partitioned by resource class."""

    def __init__(self, kvs: KVS, net: NetModel, n_cpu: int = 4,
                 n_gpu: int = 0, cache_bytes: int = 2 << 30):
        self.kvs = kvs
        self.net = net
        self.cache_bytes = cache_bytes
        self.executors: Dict[str, Executor] = {}
        self._lock = threading.Lock()
        for _ in range(n_cpu):
            self.add_executor("cpu")
        for _ in range(n_gpu):
            self.add_executor("gpu")

    def add_executor(self, resource_class: str) -> Executor:
        ex = Executor(self.kvs, self.net, resource_class, self.cache_bytes)
        with self._lock:
            self.executors[ex.id] = ex
        return ex

    def by_class(self, resource_class: str) -> List[Executor]:
        with self._lock:
            return [e for e in self.executors.values()
                    if e.resource_class == resource_class and not e._stop]

    def by_id(self, executor_id: str) -> Optional[Executor]:
        with self._lock:
            return self.executors.get(executor_id)

    def stop(self):
        with self._lock:
            executors = list(self.executors.values())
        for e in executors:
            for item in e.stop():
                # fail leftovers instead of stranding their callers
                try:
                    item.callback(None, RuntimeError(
                        "executor pool stopped"), None)
                except Exception:
                    pass
