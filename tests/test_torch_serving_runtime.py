"""The port's serving runtime on the CPU (``device="cpu"``): request
batching of the f32 tiny yi-9b cascade held token for token to the
reference package's ``reference_decode`` on each prompt alone (same
params, bridged with ``interop.params_from_numpy``), the runtime's metric
series and per-request span names held to the reference runtime's on the
same traffic, and the fault-tolerance, deadline, admission and
generation paths.

No assertion rests on thread timing: how a burst is cut into batches is
read from the tracer, and waits are bounded polls or ``.result(timeout)``.
"""
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.compiler import compile_flow as r_compile_flow  # noqa: E402
from repro.core.dataflow import Dataflow as RDataflow  # noqa: E402
from repro.core.table import Table as RTable  # noqa: E402
from repro.obs.trace import Tracer as RTracer  # noqa: E402
from repro.runtime.netmodel import NetModel as RNetModel  # noqa: E402
from repro.runtime.runtime import Runtime as RRuntime  # noqa: E402
from repro.serving.admission import (  # noqa: E402
    AdmissionController as RAdmissionController, ClassPolicy as RClass)
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.core.compiler import compile_flow  # noqa: E402
from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.core.ir import PhysicalPlan  # noqa: E402
from repro_torch.core.lowering import DegradePolicy  # noqa: E402
from repro_torch.core.passes import build_pipeline  # noqa: E402
from repro_torch.core.table import DeviceTable, Table  # noqa: E402
from repro_torch.examples import decode_cascade as tdc  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import Tracer, attribute  # noqa: E402
from repro_torch.runtime import (Autoscaler, AutoscalerConfig,  # noqa: E402
                                 KVS, NetModel, Runtime)
from repro_torch.runtime.executor import ExecutorPool, WorkItem  # noqa: E402
from repro_torch.serving import (AdmissionController,  # noqa: E402
                                 ClassPolicy, DeadlineExceeded, FaultInjector,
                                 FaultPlan, Overloaded)

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
PROMPTS = 5


class _Jitted:
    """The reference model's serving stages under ``jax.jit``."""

    def __init__(self, model):
        self.prefill = jax.jit(model.prefill, static_argnums=2)
        self.decode_step = jax.jit(model.decode_step)


@pytest.fixture(scope="module")
def ref():
    """Reference tiny yi-9b (f32) params and each prompt's tokens from the
    reference example's ``reference_decode`` on that prompt alone; the
    same params bridged to the port."""
    sys.path.insert(0, os.path.join(SRC, os.pardir))
    from examples import decode_cascade as jdc
    jcfg = dataclasses.replace(jdc.get_tiny_config("yi-9b"),
                               dtype="float32")
    jm = jdc.build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (PROMPTS, jdc.SEQ), dtype=np.int32)
    jit = _Jitted(jm)
    want = [jdc.reference_decode(jit, jparams, jnp.asarray(toks[i:i + 1]),
                                 steps=tdc.STEPS, cache_len=jdc.CACHE)[0]
            for i in range(PROMPTS)]
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return {"params": params, "toks": torch.from_numpy(toks),
            "want": want}


def _model():
    cfg = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32",
                              use_kernels=True)
    return build_model(cfg, device="cpu")


@pytest.fixture
def rt():
    r = Runtime(n_cpu=2, n_gpu=2, net=NetModel(scale=0.0), max_batch=8,
                batch_wait_ms=50.0, detector_interval_s=0.02,
                tracer=Tracer(sample_rate=1.0), device="cpu")
    yield r
    r.stop()


def _wait(cond, what, timeout_s=10.0):
    deadline = time.perf_counter() + timeout_s
    while not cond():
        assert time.perf_counter() < deadline, what
        time.sleep(0.005)


def op_name(dep):
    (name,) = dep.dag.nodes
    return name


# -- request batching of the cascade ------------------------------------------

def test_batched_cascade_matches_reference_per_prompt(ref, rt):
    """Five concurrent one-prompt requests through the batching cascade:
    each gets the reference's tokens for its prompt alone; the chain ran
    one dispatch per batch the tracer saw."""
    pre, dec = tdc.build_ops(_model(), ref["params"], cache_len=tdc.CACHE)
    dep = tdc.build(rt, pre, dec, steps=tdc.STEPS, name="batched",
                    batching=True)
    got, sizes, _ = tdc.serve_requests(dep, ref["toks"])
    assert got == ref["want"]
    assert sum(sizes) == PROMPTS
    (op,) = dep.plan.ops
    chain = op.op
    # a batch of one takes the per-row path; every other batch is ONE
    # batched dispatch
    assert chain.batch_dispatches + chain.row_dispatches == len(sizes)
    assert chain.batch_dispatches == sum(1 for s in sizes if s > 1)
    spans = rt.metrics_snapshot("batch/batched/")
    assert sorted(spans[f"batch/batched/{op_name(dep)}/size"]) == \
        sorted(sizes)
    _wait(lambda: len(rt.tracer.kept("batched")) == PROMPTS,
          "every trace finished")
    for tr in rt.tracer.kept("batched"):
        node = op_name(dep)
        # the dispatch's upload and each chain step ride beside exec@
        assert [s.name for s in tr.spans] == [
            "admission", f"queue@{node}", f"exec@{node}", f"upload@{node}",
            *[f"step@{node}"] * (1 + tdc.STEPS), f"demux@{node}"]
        assert tr.spans[2].link is not None
        att = attribute([tr])
        assert sum(nb.total_s for nb in att.nodes.values()) >= \
            0.9 * tr.latency_s
    assert rt.pool.fault_counts["wedge"] == 0


# -- the runtime's observable surface against the reference's -----------------

def _map_flow(DF):
    def fn(i: int) -> int:
        return i + 1

    fl = DF([("i", int)])
    fl.output = fl.map(fn, names=["i"], batching=True)
    return fl


def _drive(runtime, compile_fn, DF, T, Gate, Class):
    """The same deterministic traffic on either package: three served
    requests one after another, a deadline that has passed on arrival,
    then a rate-limited gate that admits one request and sheds the
    next.  Returns (metric-series names, span names per request in
    arrival order, error types)."""
    compile_fn(_map_flow(DF), runtime, name="m")
    errors = []
    for i in range(3):
        out = runtime.call_dag("m", T([("i", int)], [(i,)])).result(10)
        assert out.rows[0].values[0] == i + 1
    futs = [runtime.call_dag("m", T([("i", int)], [(9,)]), deadline_s=0.0)]
    runtime.set_admission("m", Gate(classes={"interactive": Class(
        "interactive", priority=2, rate=1e-3, burst=1)}))
    futs += [runtime.call_dag("m", T([("i", int)], [(i,)]))
             for i in (5, 6)]
    for f in futs:
        try:
            f.result(10)
            errors.append(None)
        except Exception as e:
            errors.append((type(e).__name__, getattr(e, "reason", None)))
    _wait(lambda: len(runtime.tracer.kept("m")) == 6, "traces finished")
    traces = sorted(runtime.tracer.kept("m"), key=lambda t: t.trace_id)
    return (sorted(runtime.metrics_snapshot()),
            [[s.name for s in t.spans] for t in traces], errors)


def test_metric_series_and_span_names_match_reference():
    port = Runtime(n_cpu=2, net=NetModel(scale=0.0), batch_wait_ms=5.0,
                   tracer=Tracer(sample_rate=1.0), device="cpu")
    refr = RRuntime(n_cpu=2, net=RNetModel(scale=0.0), batch_wait_ms=5.0,
                    tracer=RTracer(sample_rate=1.0))
    try:
        got = _drive(port, compile_flow, Dataflow, Table,
                     AdmissionController, ClassPolicy)
        want = _drive(refr, r_compile_flow, RDataflow, RTable,
                      RAdmissionController, RClass)
    finally:
        port.stop()
        refr.stop()
    assert got == want
    keys, _, errors = got
    assert "dag/m/expired_t" in keys and "dag/m/shed_t" in keys
    assert errors == [("DeadlineExceeded", "deadline"), None,
                      ("Overloaded", "rate_limit")]


def test_deadline_expiry_and_shed_are_typed(rt):
    fl = _map_flow(Dataflow)
    compile_flow(fl, rt, name="typed")
    with pytest.raises(DeadlineExceeded):
        rt.call_dag("typed", Table([("i", int)], [(1,)]),
                    deadline_s=0.0).result(10)
    rt.set_admission("typed", AdmissionController(classes={
        "interactive": ClassPolicy("interactive", priority=2, rate=1e-3,
                                   burst=1)}))
    assert rt.call_dag("typed", Table([("i", int)], [(1,)])) \
        .result(10).rows[0].values[0] == 2
    with pytest.raises(Overloaded) as exc:
        rt.call_dag("typed", Table([("i", int)], [(1,)])).result(10)
    assert exc.value.reason == "rate_limit"
    snap = rt.metrics_snapshot("dag/typed/")
    assert len(snap["dag/typed/expired_t"]) == 1
    assert len(snap["dag/typed/shed_t"]) == 1


def _f1(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x * 1.01 + 0.1)


def _f2(x: torch.Tensor) -> torch.Tensor:
    return x * x - 0.5 * x


def test_degraded_request_bypasses_batcher_and_runs_per_row(rt):
    """Admission with ``degrade`` routes to the per-row executable on the
    worker thread: no batcher, no batched dispatch."""
    fl = Dataflow([("x", torch.Tensor)])
    fl.output = fl.map(_f1, names=["x"], gpu=True, batching=True).map(
        _f2, names=["x"], gpu=True, batching=True)
    dep = compile_flow(fl, rt, fusion=True, name="deg")
    rt.set_admission("deg", AdmissionController(
        classes={"best_effort": ClassPolicy(
            "best_effort", priority=0, degrade=DegradePolicy())},
        queue_depth_fn=lambda: 10 ** 6, queue_cost_s=1.0))
    xs = [torch.linspace(-1, 1, 4) * (i + 1) for i in range(3)]
    out = rt.call_dag("deg", Table([("x", torch.Tensor)],
                                   [(x,) for x in xs]),
                      deadline_s=1.0, klass="best_effort").result(30)
    for x, r in zip(xs, out.rows):
        torch.testing.assert_close(r.values[0], _f2(_f1(x)))
    chain = dep.plan.ops[0].op
    assert (chain.row_dispatches, chain.batch_dispatches) == (3, 0)
    assert rt.batcher_for("deg", op_name(dep)) is None
    assert len(rt.metrics_snapshot()["admission/deg/best_effort/"
                                     "degraded_t"]) == 1


def test_dispatch_counters_hold_under_concurrent_workers():
    """More threads than cores run one lowered chain at once, as executor
    threads do when the runtime serves concurrent batches: its dispatch
    counters lose no update under a short switch interval."""
    fl = Dataflow([("x", torch.Tensor)])
    fl.output = fl.map(_f1, names=["x"], gpu=True).map(
        _f2, names=["x"], gpu=True)
    plan = build_pipeline(fusion=True, device="cpu").run(
        PhysicalPlan.from_dataflow(fl))
    chain = plan.ops[0].op
    chain.adaptive_routing = False       # two rows always batch
    one = Table([("x", torch.Tensor)], [(torch.ones(4),)])
    two = Table([("x", torch.Tensor)], [(torch.ones(4),)] * 2)
    n_threads, n_iter = 2 * (os.cpu_count() or 4), 20

    def work():
        for _ in range(n_iter):
            chain.apply_batched([one])
            chain.apply_batched([two])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert chain.row_dispatches == n_threads * n_iter
    assert chain.batch_dispatches == n_threads * n_iter
    assert chain.rows_batched == 2 * n_threads * n_iter


# -- faults -------------------------------------------------------------------

class _OnNode:
    """A fault injector that draws from a real ``FaultInjector`` only for
    work items of one node (the consumer of a device-resident edge)."""

    def __init__(self, pool, fn, plan):
        self.pool, self.fn = pool, fn
        self.inj = FaultInjector(plan)

    def draw(self, executor_id, resource_class):
        ex = self.pool.by_id(executor_id)
        item = ex.current if ex is not None else None
        if item is None or item.fn is not self.fn:
            return None
        return self.inj.draw(executor_id, resource_class)

    def transient_error(self, executor_id):
        return self.inj.transient_error(executor_id)


def _split_flow(pre, dec_batched, dec):
    """[prefill, decode] merged across requests, then three decode steps
    per request: the first chain's DeviceTable is demuxed on the device
    and each part runs pinned to the producer's worker.  The hints live
    on the op, so the batched decode step is an op instance of its own."""
    fl = Dataflow([("tokens", torch.Tensor)])
    node = fl.apply_op(pre, gpu=True, batching=True).apply_op(
        dec_batched, gpu=True, batching=True)
    for _ in range(tdc.STEPS - 1):
        node = node.apply_op(dec, gpu=True)
    fl.output = node
    return fl


def test_crash_on_device_resident_edge_gives_clean_tokens(ref, rt):
    """A crash of the worker that holds a request's device-resident part
    requeues the item onto another worker, which reads the same tensors
    again: the tokens equal the clean run's (and the reference's)."""
    model = _model()
    pre, dec = tdc.build_ops(model, ref["params"], cache_len=tdc.CACHE)
    _, dec_batched = tdc.build_ops(model, ref["params"], cache_len=tdc.CACHE)
    dep = compile_flow(_split_flow(pre, dec_batched, dec), rt, fusion=True,
                       name="split")
    first, second = (dep.dag.nodes[n] for n in dep.dag.nodes)
    assert first.emits_device and not second.batching
    inputs = []
    inner = second.fn

    def spy(tables, ctx):
        inputs.append(type(tables[0]))
        return inner(tables, ctx)

    second.fn = spy
    tables = [Table([("tokens", torch.Tensor)], [(ref["toks"][i],)])
              for i in range(3)]
    clean = [int(f.result(120).rows[0].values[0])
             for f in [dep.execute(t) for t in tables]]
    assert clean == ref["want"][:3]
    assert inputs == [DeviceTable] * 3
    rt.pool.set_injector(_OnNode(rt.pool, spy, FaultPlan(seed=7).crash(
        rate=1.0, limit=1, classes=("gpu",))))
    crashed = [int(f.result(120).rows[0].values[0])
               for f in [dep.execute(t) for t in tables]]
    rt.pool.set_injector(None)
    assert crashed == clean
    counts = rt.pool.fault_counts
    assert counts["crash"] == 1 and counts["requeued"] >= 1
    assert counts["replaced"] == 1 and counts["wedge"] == 0


def test_hedge_is_won_once(rt):
    """The primary blocks until its hedge has run: the hedge delivers,
    the primary's completion finds the token claimed and falls silent."""
    hedge_ran = threading.Event()
    calls = []

    def fn(i: int) -> int:
        calls.append(i)
        if len(calls) == 1:
            assert hedge_ran.wait(10)
        else:
            hedge_ran.set()
        return i + 1

    fl = Dataflow([("i", int)])
    fl.output = fl.map(fn, names=["i"])
    dep = compile_flow(fl, rt, name="h")
    rt.configure_hedging("h", op_name(dep), 0.02)
    assert rt.call_dag("h", Table([("i", int)], [(3,)])) \
        .result(10).rows[0].values[0] == 4
    _wait(lambda: len(calls) == 2 and not any(
        e.busy for e in rt.pool.executors.values()), "primary finished")
    (tr,) = rt.tracer.kept("h")
    names = [s.name for s in tr.spans]
    assert names.count(f"exec@{op_name(dep)}") == 1
    assert f"hedge_launch@{op_name(dep)}" in names
    assert len(rt.metrics_snapshot()["dag/h/hedge_t"]) == 1


def test_item_under_hang_timeout_is_not_requeued():
    """The wedge detector leaves an executor alone while its item is busy
    for less than ``hang_timeout_s`` (a long GPU call is not a wedge) and
    fails it over past it, running a clone elsewhere; one delivery."""
    pool = ExecutorPool(KVS(), NetModel(scale=0.0), n_cpu=2,
                        hang_timeout_s=5.0)
    release, delivered = threading.Event(), []
    try:
        item = WorkItem(fn=lambda tables, ctx: release.wait(10),
                        tables=[None], produced_on=[None],
                        callback=lambda r, e, x: delivered.append((r, e)))
        ex = pool.by_class("cpu")[0]
        ex.submit(item)
        _wait(lambda: ex.current is item, "item started")
        t = ex.busy_since
        assert pool.check_health(now=t + 4.99) == []
        assert pool.fault_counts["wedge"] == 0
        assert pool.fault_counts["requeued"] == 0
        assert pool.check_health(now=t + 5.01) == [ex.id]
        assert pool.fault_counts["wedge"] == 1
        assert pool.fault_counts["requeued"] == 1
        release.set()
        _wait(lambda: not any(e.busy for e in pool.executors.values()),
              "both attempts finished")
        assert delivered == [(True, None)]
    finally:
        release.set()
        pool.stop()


# -- generations and the autoscaler -------------------------------------------

def test_generation_swap_drains_and_retires_batchers(rt):
    def mk(k):
        def model(x: int) -> int:
            return x * k
        fl = Dataflow([("x", int)])
        fl.output = fl.map(model, names=["y"], batching=True)
        return compile_flow(fl, rt, name="redep")

    d1 = mk(10)
    assert d1.execute(Table([("x", int)], [(1,)])) \
        .result(10).rows[0].values[0] == 10
    old = (d1.dag.name, d1.dag.generation, op_name(d1))
    assert old in rt._batchers
    d2 = mk(100)
    assert d2.dag.generation > d1.dag.generation
    assert d2.execute(Table([("x", int)], [(2,)])) \
        .result(10).rows[0].values[0] == 200
    # the old generation's batcher left the live table and, drained,
    # was closed by the sweep
    assert old not in rt._batchers
    _wait(lambda: rt.sweep_retired() == 0, "old batcher drained")
    assert (d2.dag.name, d2.dag.generation, op_name(d2)) in rt._batchers


def test_autoscaler_replaces_failed_replica_below_min():
    pool = ExecutorPool(KVS(), NetModel(scale=0.0), n_cpu=2,
                        auto_replace=False)
    asc = None
    try:
        ids = list(pool.executors)
        pool.assign("f", ids)
        asc = Autoscaler(pool, {"f": "cpu"},
                         AutoscalerConfig(interval_s=0.02, min_replicas=2))
        asc.start()
        pool._handle_failure(pool.executors[ids[0]], "crash")
        assert pool.replica_count("f") == 1
        _wait(lambda: pool.replica_count("f") == 2,
              "autoscaler replaced the failed replica", 5.0)
        assert pool.fault_counts["replaced"] == 0     # the autoscaler did
    finally:
        if asc is not None:
            asc.stop()
        pool.stop()
