"""The runtime facade: scheduler + client (Cloudburst analogue).  Port of
the subset of the reference package's ``runtime/runtime.py`` that the
compiled serving path uses.

Scheduling policy (paper §2.3/§4):
* partition executors by resource class; pick the least-loaded executor
* wait-for-any: anyof nodes fire on the first completed upstream
* device residency: a node consuming a ``DeviceTable`` runs on the
  executor that produced it

``Runtime`` owns an explicit ``device`` (the CUDA device unless the caller
names another; it raises without a card) onto which compiled flows lower
their chains.  Request batching (``Batcher``), admission control,
deadlines, fault injection and detection, retries, hedging, tracing,
histogram metrics, locality-aware placement and blue/green generations
are not ported yet: a node's ``batching`` hint and locality refs are not
acted on, and metrics are plain series.
"""
from __future__ import annotations

import random
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional

from repro_torch.core.table import DeviceTable, Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.clock import now as _mono
from repro_torch.runtime.dag import RuntimeDag, RuntimeNode
from repro_torch.runtime.executor import ExecutorPool, WorkItem
from repro_torch.runtime.kvs import KVS
from repro_torch.runtime.netmodel import NetModel


class Runtime:
    def __init__(self, *, n_cpu: int = 4, n_gpu: int = 0,
                 net: Optional[NetModel] = None,
                 cache_bytes: int = 2 << 30, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.net = net or NetModel()
        self.kvs = KVS(self.net)
        self.pool = ExecutorPool(self.kvs, self.net, n_cpu=n_cpu,
                                 n_gpu=n_gpu, cache_bytes=cache_bytes)
        self.dags: Dict[str, RuntimeDag] = {}
        self._rng = random.Random(seed)
        # appended from executor callback threads: every access goes
        # through _metrics_lock
        self.metrics: Dict[str, List[float]] = {}
        self._metrics_lock = threading.Lock()

    # -- registration -----------------------------------------------------------
    def register_dag(self, dag: RuntimeDag):
        """Register (or replace) a runtime DAG under its name."""
        dag.validate()
        self.dags[dag.name] = dag

    def register_plan(self, plan, name: str) -> RuntimeDag:
        """Lower a ``PhysicalPlan`` and register it in one step."""
        dag = RuntimeDag.from_plan(plan, name)
        self.register_dag(dag)
        return dag

    # -- scheduling -------------------------------------------------------------
    def pick_executor(self, node: RuntimeNode):
        cands = self.pool.by_class(node.resource_class)
        if not cands:
            raise RuntimeError(
                f"no executors for class {node.resource_class!r}")
        lo = min(e.load for e in cands)
        best = [e for e in cands if e.load == lo]
        return self._rng.choice(best)

    def dispatch(self, node: RuntimeNode, tables: List[Table],
                 produced_on: List[Optional[str]], callback):
        # a device-resident input lives in its producer's accelerator
        # memory: the consumer MUST run there — shipping the batch to
        # another executor would be the host round-trip the residency
        # analysis eliminated
        ex = None
        for t, src in zip(tables, produced_on):
            if isinstance(t, DeviceTable) and src is not None:
                ex = self.pool.by_id(src)
                break
        if ex is None:
            ex = self.pick_executor(node)
        ex.submit(WorkItem(fn=node.fn, tables=tables,
                           produced_on=produced_on, callback=callback))

    def record_metric(self, key: str, value: float):
        with self._metrics_lock:
            self.metrics.setdefault(key, []).append(value)

    def metrics_snapshot(self, prefix=None) -> Dict[str, List[float]]:
        """A consistent copy of metric series (optionally only the keys
        starting with ``prefix``)."""
        with self._metrics_lock:
            return {k: list(v) for k, v in self.metrics.items()
                    if prefix is None or k.startswith(prefix)}

    # -- execution ----------------------------------------------------------------
    def call_dag(self, name: str, table: Table) -> Future:
        """Run one request through the registered DAG ``name``; the future
        resolves to the output table, or to the first node's error."""
        dag = self.dags[name]
        fut: Future = Future()
        t0 = _mono()
        self.record_metric(f"dag/{name}/request_t", t0)

        def _record(f: Future):
            ok = f.exception() is None
            self.record_metric(
                f"dag/{name}/{'latency_s' if ok else 'error_latency_s'}",
                _mono() - t0)

        fut.add_done_callback(_record)
        _DagExecution(self, dag, table, fut).start()
        return fut

    def stop(self):
        self.pool.stop()


class _DagExecution:
    def __init__(self, rt: Runtime, dag: RuntimeDag, table: Table,
                 fut: Future):
        self.rt = rt
        self.dag = dag
        self.input = table
        self.fut = fut
        self.lock = threading.Lock()
        self.results: Dict[str, Table] = {}
        self.produced_on: Dict[str, Optional[str]] = {}
        self.dispatched: set = set()

    def start(self):
        self._advance()

    def _ready(self, node: RuntimeNode) -> Optional[List[str]]:
        """deps to consume, or None if not ready."""
        if node.wait_any:
            done = [d for d in node.deps if d in self.results]
            return [done[0]] if done else None
        if all(d in self.results for d in node.deps):
            return list(node.deps)
        return None

    def _advance(self):
        with self.lock:
            to_run = []
            for node in self.dag.nodes.values():
                if node.name in self.dispatched or node.name in self.results:
                    continue
                deps = self._ready(node)
                if deps is None:
                    continue
                self.dispatched.add(node.name)
                tables = ([self.input] if not node.deps else
                          [self.results[d] for d in deps])
                srcs = ([None] if not node.deps else
                        [self.produced_on.get(d) for d in deps])
                to_run.append((node, tables, srcs))
        for node, tables, srcs in to_run:
            try:
                self.rt.dispatch(node, tables, srcs,
                                 self._make_callback(node))
            except BaseException as e:
                # a dispatch that cannot even start must still resolve
                # the caller
                if not self.fut.done():
                    self.fut.set_exception(e)
                return

    def _make_callback(self, node: RuntimeNode):
        def cb(result, error, exec_id):
            if error is not None:
                if not self.fut.done():
                    self.fut.set_exception(error)
                return
            finish = False
            with self.lock:
                if node.name in self.results:   # competitive duplicate
                    return
                self.results[node.name] = result
                self.produced_on[node.name] = exec_id
                if node.name == self.dag.output:
                    finish = True
            if finish:
                if not self.fut.done():
                    self.fut.set_result(result)
                return
            self._advance()
        return cb
