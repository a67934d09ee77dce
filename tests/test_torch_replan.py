"""Blue/green replanning and the SLO controller of the port on the CPU,
with the tiny f32 yi-9b cascade (``device="cpu"``) as the served flow.

Ports the replan cases of the reference package's ``tests/test_replan.py``
(zero executable builds after a swap, in-flight requests finishing on
blue, a canary failure aborting the swap while blue stays live,
``warm_deployment`` covering every bucket, the default replanner's
escalation and confirm, rollback on a failed confirm, the reserved pool),
each request's tokens held to the reference package's ``reference_decode``
on its prompt alone (same params, bridged with
``interop.params_from_numpy``).  Then the canary's row comparison on bf16
and mis-shaped tensors, and both packages' controllers driven through the
same scripted metrics on one recorded clock, event for event.

No rate comes from the host's clock: the runtime's timestamps and the
controller's clock are one recorded clock that the test advances, and
nothing sleeps to make a rate.
"""
import copy
import dataclasses
import os
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.profiling as r_prof  # noqa: E402
import repro.profiling.controller as r_ctl_mod  # noqa: E402
import repro.profiling.replan as r_replan  # noqa: E402
import repro_torch.profiling as t_prof  # noqa: E402
import repro_torch.profiling.controller as t_ctl_mod  # noqa: E402
import repro_torch.profiling.replan as t_replan  # noqa: E402
import repro_torch.runtime.runtime as t_runtime_mod  # noqa: E402
from repro.configs import get_tiny_config as r_tiny  # noqa: E402
from repro.core.dataflow import Dataflow as RFlow  # noqa: E402
from repro.core.ir import PhysicalPlan as RPlan  # noqa: E402
from repro.core.passes import build_pipeline as r_pipeline  # noqa: E402
from repro.core.table import Table as RTable  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models.registry import model_stage_op as r_stage_op  # noqa: E402
from repro.runtime.dag import RuntimeDag as RDag  # noqa: E402
from repro.runtime.netmodel import NetModel as RNet  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.core.compiler import compile_flow  # noqa: E402
from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.core.ir import PhysicalPlan  # noqa: E402
from repro_torch.core.lowering import (EXECUTABLE_CACHE,  # noqa: E402
                                       BatchedJittedFuse, JittedFuse)
from repro_torch.core.passes import build_pipeline  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.examples import decode_cascade as tdc  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.profiling import (BlueGreenReplanner,  # noqa: E402
                                   BucketStats, FlowProfile, NodeConfig,
                                   OpLatencyCurve, PlanConfig,
                                   SLOController, warm_deployment)
from repro_torch.runtime import NetModel, Runtime  # noqa: E402
from repro_torch.runtime.dag import RuntimeDag  # noqa: E402
from repro_torch.runtime.executor import WorkItem  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
PROMPTS, STEPS = 6, 2


class _Jitted:
    def __init__(self, model):
        self.prefill = jax.jit(model.prefill, static_argnums=2)
        self.decode_step = jax.jit(model.decode_step)


@pytest.fixture(scope="module")
def ref():
    """Reference tiny yi-9b (f32) params, prompts and each prompt's tokens
    from the reference example's ``reference_decode`` on that prompt
    alone; the same params bridged to the port."""
    sys.path.insert(0, os.path.join(SRC, os.pardir))
    from examples import decode_cascade as jdc
    jcfg = dataclasses.replace(jdc.get_tiny_config("yi-9b"),
                               dtype="float32")
    jm = jdc.build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (PROMPTS, jdc.SEQ), dtype=np.int32)
    jit = _Jitted(jm)
    want = [jdc.reference_decode(jit, jparams, jnp.asarray(toks[i:i + 1]),
                                 steps=STEPS, cache_len=jdc.CACHE)[0]
            for i in range(PROMPTS)]
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return {"params": params, "toks": torch.from_numpy(toks), "want": want}


def _model():
    cfg = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32",
                              use_kernels=True)
    return build_model(cfg, device="cpu")


def _flow(params):
    pre, dec = tdc.build_ops(_model(), params, measure=False)
    return tdc.build_flow(pre, dec, steps=STEPS, batching=True)


def _request(ref, i):
    return Table([("tokens", torch.Tensor)], [(ref["toks"][i],)])


def _sample(ref):
    return _request(ref, 0)


def _tokens(futs):
    return [int(f.result(60).rows[0].values[0]) for f in futs]


def _serve(dep, ref, idx):
    """One request per prompt in ``idx``, all in flight at once; tokens."""
    return _tokens([dep.execute(_request(ref, i)) for i in idx])


def _want(ref, idx):
    return [ref["want"][i] for i in idx]


def _chain_id(dep):
    (node,) = [n for n in dep.dag.nodes.values() if n.batching]
    return node, node.plan_op_id


class _RecordedClock:
    """The one clock of the runtime's rate timestamps and the controller:
    it moves only when the test moves it."""

    def __init__(self):
        self.t = 5000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _RecordedClock()
    for m in (t_runtime_mod, t_ctl_mod):
        monkeypatch.setattr(m, "_mono", c)
    return c


def _paced(dep, ref, idx, clock, gap_s):
    """Submit one request per prompt in ``idx``, ``gap_s`` apart on the
    recorded clock; returns the futures."""
    futs = []
    for i in idx:
        clock.t += gap_s
        futs.append(dep.execute(_request(ref, i)))
    return futs


def _rt(**kw):
    kw.setdefault("batch_wait_ms", 2.0)
    return Runtime(n_cpu=2, n_gpu=1, net=NetModel(scale=0.0), device="cpu",
                   **kw)


def _saturating_curve(op_id):
    """Per-row saturates at a few hundred requests a second, the batched
    path is comfortably cheap: ``propose`` flips a per-row-lowered
    deployment to batched lowering, which needs a recompile."""
    c = OpLatencyCurve(key=op_id, name="chain", per_row_s=5e-3)
    for b in (1, 2, 4, 8, 16):
        c.buckets[b] = BucketStats(mean_s=1e-3 + 5e-5 * b,
                                   p99_s=1.5e-3 + 7e-5 * b, cv=0.05,
                                   runs=3, out_bytes=64 * b)
    return c


# -- blue/green replanning ----------------------------------------------------

def test_blue_green_swap_zero_retrace_and_state_carryover(ref):
    rt = _rt()
    try:
        dep = compile_flow(_flow(ref["params"]), rt, fusion=True, name="bg")
        blue_dag = dep.dag
        node, op_id = _chain_id(dep)
        assert _serve(dep, ref, range(PROMPTS)) == _want(ref, range(PROMPTS))
        rt.configure_batching("bg", node.name, max_batch=5,
                              batch_wait_ms=3.0)
        proposal = PlanConfig(nodes={op_id: NodeConfig(
            max_batch=5, batch_buckets=(1, 2, 4), batch_wait_ms=3.0,
            batched_lowering=True)})
        rep = BlueGreenReplanner(rt, dep, sample=_sample(ref)).replan(
            proposal)
        assert rep.ok, rep
        assert rep.phase == "done" and rep.canary.get("ok") is True
        assert rep.green_generation != rep.blue_generation
        assert rt.dags["bg"] is dep.dag and dep.dag is not blue_dag
        green_node, _ = _chain_id(dep)
        assert tuple(dep.plan.op(op_id).op.bucket_sizes) == (1, 2, 4)
        assert 8 in rep.warm["buckets"]     # a full merge of 5 pads to 8
        traces0 = EXECUTABLE_CACHE.traces()
        idx = [i % PROMPTS for i in range(10)]
        assert _serve(dep, ref, idx) == _want(ref, idx)
        assert EXECUTABLE_CACHE.traces() == traces0
        b = rt.batcher_for("bg", green_node.name)
        assert b is not None and b.max_batch == 5
        assert b.max_wait == pytest.approx(3e-3)
    finally:
        rt.stop()


def test_blue_green_inflight_requests_finish_on_blue(ref):
    rt = _rt()
    try:
        dep = compile_flow(_flow(ref["params"]), rt, fusion=True, name="bg2")
        _, op_id = _chain_id(dep)
        _serve(dep, ref, [0])
        blue_key = (dep.dag.name, dep.dag.generation)
        idx = [i % PROMPTS for i in range(24)]
        futs = [dep.execute(_request(ref, i)) for i in idx]   # in flight
        rep = BlueGreenReplanner(rt, dep, sample=_sample(ref)).replan(
            PlanConfig(nodes={op_id: NodeConfig(
                max_batch=4, batch_buckets=(1, 2, 4),
                batched_lowering=True)}))
        assert rep.ok
        idx2 = list(range(PROMPTS)) + [0, 1]
        futs += [dep.execute(_request(ref, i)) for i in idx2]   # on green
        assert _tokens(futs) == _want(ref, idx + idx2)
        deadline = time.time() + 10.0
        while rt._inflight.get(blue_key) and time.time() < deadline:
            time.sleep(0.02)
        assert not rt._inflight.get(blue_key)
    finally:
        rt.stop()


def _assert_blue_untouched(rt, dep, blue_dag, blue_plan, ref, name):
    assert rt.dags[name] is blue_dag
    assert dep.dag is blue_dag and dep.plan is blue_plan
    assert _serve(dep, ref, [1, 2]) == _want(ref, [1, 2])
    # the aborted green generation's canary batchers were discarded
    deadline = time.time() + 5.0
    while rt.sweep_retired() and time.time() < deadline:
        time.sleep(0.02)
    assert not rt._retired_batchers
    with rt._batchers_lock:
        gens = {k[1] for k in rt._batchers}
    assert gens <= {blue_dag.generation}


def test_canary_failure_aborts_swap_blue_stays_live(ref):
    rt = _rt()
    try:
        fl = _flow(ref["params"])
        dep = compile_flow(fl, rt, fusion=True, name="bg3")
        blue_dag, blue_plan = dep.dag, dep.plan
        _, op_id = _chain_id(dep)
        # poison the canary reference: green's (correct) output will not
        # match, so the replan must abort before the swap
        wrong = fl.execute_local(_sample(ref))
        (row,) = wrong.rows
        wrong.rows = [row.replace((row.values[0] + 1,) + row.values[1:])]
        fl.execute_local = lambda t, ctx=None: wrong
        rep = BlueGreenReplanner(rt, dep, sample=_sample(ref),
                                 reference="local").replan(
            PlanConfig(nodes={op_id: NodeConfig(
                max_batch=4, batch_buckets=(1, 4), batched_lowering=True)}))
        assert not rep.ok and rep.phase == "canary"
        assert "mismatch" in str(rep.canary.get("error"))
        _assert_blue_untouched(rt, dep, blue_dag, blue_plan, ref, "bg3")
    finally:
        rt.stop()


def _nudged(params):
    """A copy of the params with one weight of the first key projection
    (``wk``) scaled by 1.5: the decode step writes other keys into the
    cache."""
    out = copy.deepcopy(params)
    out["blocks"]["0"]["attn"]["wk"].view(-1)[0] *= 1.5
    return out


def test_canary_catches_a_green_with_one_weight_changed(ref):
    """A green compiled from a flow whose decode op holds params with one
    weight changed: the canary against blue aborts it."""
    rt = _rt()
    try:
        dep = compile_flow(_flow(ref["params"]), rt, fusion=True, name="bg4")
        blue_dag, blue_plan = dep.dag, dep.plan
        _, op_id = _chain_id(dep)
        pre, _ = tdc.build_ops(_model(), ref["params"], measure=False)
        _, bad_dec = tdc.build_ops(_model(), _nudged(ref["params"]),
                                   measure=False)
        drill = copy.copy(dep)
        drill.flow = tdc.build_flow(pre, bad_dec, steps=STEPS,
                                    batching=True)
        rep = BlueGreenReplanner(rt, drill, sample=_sample(ref)).replan(
            PlanConfig(nodes={op_id: NodeConfig(
                max_batch=4, batch_buckets=(1, 2, 4),
                batched_lowering=True)}))
        assert not rep.ok and rep.phase == "canary"
        assert "mismatch" in str(rep.canary.get("error"))
        _assert_blue_untouched(rt, dep, blue_dag, blue_plan, ref, "bg4")
    finally:
        rt.stop()


def test_warm_deployment_pretraces_all_buckets(ref):
    rt = _rt()
    try:
        fl = _flow(ref["params"])
        probe = compile_flow(fl, rt, fusion=True, name="warm0")
        _, op_id = _chain_id(probe)
        cfg = PlanConfig(nodes={op_id: NodeConfig(
            max_batch=4, batch_buckets=(1, 2, 4), batched_lowering=True)})
        green = compile_flow(fl, rt, fusion=True, plan_config=cfg,
                             name="warm1", register=False)
        assert "warm1" not in rt.dags and green.dag.generation > 0
        w = warm_deployment(rt, green, _sample(ref))
        # the buckets, and the one a full merge of the runtime's default
        # batch (max_batch 10) pads to
        assert rt.max_batch == 10
        assert not w["errors"] and w["buckets"] == [1, 2, 4, 16]
        traces0 = EXECUTABLE_CACHE.traces()
        for b in (1, 2, 4):
            t = Table([("tokens", torch.Tensor)],
                      [(ref["toks"][i],) for i in range(b)])
            out = rt.call_dag_object(green.dag, t).result(timeout=60)
            assert [int(r.values[0]) for r in out.rows] == \
                _want(ref, range(b))
        assert EXECUTABLE_CACHE.traces() == traces0, \
            "post-warm traffic built an executable"
    finally:
        rt.stop()


# -- the controller's escalation, confirm and rollback --------------------------

def _per_row_deploy(rt, params, name):
    dep = compile_flow(_flow(params), rt, fusion=True,
                       batched_lowering=False, name=name)
    _, op_id = _chain_id(dep)
    op0 = dep.plan.op(op_id).op
    assert isinstance(op0, JittedFuse) \
        and not isinstance(op0, BatchedJittedFuse)
    return dep, op_id


def test_controller_default_replanner_escalates_swaps_and_confirms(ref,
                                                                    clock):
    """A per-row-lowered deployment saturates at the recorded rate -> the
    optimizer proposes the batched flip (compile-time) -> the controller
    escalates to its default BlueGreenReplanner -> green (batched) swaps
    in with zero drops -> the next tick confirms the post-swap SLO."""
    rt = _rt()
    try:
        dep, op_id = _per_row_deploy(rt, ref["params"], "ctl")
        ctl = SLOController(rt, dep, slo_p99_s=2.0,
                            profile=FlowProfile(
                                curves={op_id: _saturating_curve(op_id)}),
                            window_s=1.0, min_rate=1.0,
                            replan_sample=_sample(ref))
        idx = [i % PROMPTS for i in range(40)]
        assert _tokens(_paced(dep, ref, idx, clock, 1e-3)) == _want(ref, idx)
        ev = ctl.tick()
        assert ev.kind == "replan", ev
        assert ev.arrival_rate == pytest.approx(1000.0)
        assert ev.detail.get("replan_report", {}).get("ok") is True
        assert isinstance(dep.plan.op(op_id).op, BatchedJittedFuse)
        assert rt.dags["ctl"] is dep.dag
        clock.t += 2.0                       # blue's burst leaves the window
        idx = [i % PROMPTS for i in range(20)]
        assert _tokens(_paced(dep, ref, idx, clock, 1e-2)) == _want(ref, idx)
        ev2 = ctl.tick()
        confirm = ev2.detail.get("post_replan_confirm")
        assert confirm is not None and confirm["slo_ok"] is True, ev2
        assert ev2.kind != "replan"
    finally:
        rt.stop()


def test_failed_confirm_rolls_back_to_blue_automatically(ref, clock):
    rt = _rt()
    try:
        dep, op_id = _per_row_deploy(rt, ref["params"], "rb")
        blue_dag, blue_plan = dep.dag, dep.plan
        ctl = SLOController(rt, dep, slo_p99_s=2.0,
                            profile=FlowProfile(
                                curves={op_id: _saturating_curve(op_id)}),
                            window_s=1.0, min_rate=1.0,
                            replan_sample=_sample(ref))
        idx = [i % PROMPTS for i in range(40)]
        _tokens(_paced(dep, ref, idx, clock, 1e-3))
        ev = ctl.tick()
        assert ev.kind == "replan", ev
        assert ev.detail.get("replan_report", {}).get("ok") is True
        assert dep.dag is not blue_dag
        # green "fails" in production: malformed requests drive the error
        # rate past max_error_rate, so the confirm tick judges slo_ok
        # False even though the modeled latency is fine
        clock.t += 2.0
        bad = Table([("tokens", torch.Tensor)], [("junk",)])
        futs = []
        for _ in range(30):
            clock.t += 1e-3
            futs.append(dep.execute(bad))
        for f in futs:
            with pytest.raises(Exception):
                f.result(timeout=60)
        ev2 = ctl.tick()
        confirm = ev2.detail.get("post_replan_confirm")
        assert confirm is not None and confirm["slo_ok"] is False, ev2
        rb = confirm.get("rollback")
        assert rb and rb["rolled_back"] is True
        assert rb["restored_generation"] == blue_dag.generation
        assert ev2.detail.get("rolled_back") is True
        assert rt.dags["rb"] is blue_dag
        assert dep.dag is blue_dag and dep.plan is blue_plan
        assert "replan/rollback" in rt.metrics_snapshot()
        assert "replan_report" not in ev2.detail
        assert _serve(dep, ref, [3]) == _want(ref, [3])
        # inside the cooldown the controller does not re-compile
        clock.t += 2.0
        _tokens(_paced(dep, ref, idx, clock, 1e-3))
        ev3 = ctl.tick()
        assert ev3.kind == "replan" and "replan_report" not in ev3.detail
        assert ev3.detail.get("replan_suppressed_s", 0) > 0
    finally:
        rt.stop()


# -- reserved warm-up/canary executors ---------------------------------------

def _blocked_serving_pool(rt, resource_class):
    """Saturate every serving executor of a class with a blocking item;
    returns the release event."""
    release = threading.Event()

    def blocker(tables, ctx):
        release.wait(30.0)

    for ex in rt.pool.by_class(resource_class):
        ex.submit(WorkItem(fn=blocker, tables=[], produced_on=[],
                           callback=lambda *a: None))
    return release


@pytest.mark.parametrize("reserved", [1, 0])
def test_reserved_pool_keeps_canary_off_saturated_serving_pool(ref,
                                                              reserved):
    """With ``reserved_gpu`` provisioned, a replan completes while every
    serving GPU worker is busy: the green generation's canary runs on
    the reserved worker.  Without one (the negative control) the canary
    times out and blue stays live."""
    rt = _rt(reserved_gpu=reserved)
    release = None
    try:
        dep = compile_flow(_flow(ref["params"]), rt, fusion=True,
                           name=f"rsv{reserved}")
        blue_dag = dep.dag
        _, op_id = _chain_id(dep)
        assert len(rt.pool.by_class("gpu")) == 1
        assert len(rt.pool.by_class("gpu", reserved=True)) == reserved
        release = _blocked_serving_pool(rt, "gpu")
        rep = BlueGreenReplanner(
            rt, dep, sample=_sample(ref), reference="local",
            canary_timeout_s=5.0 if reserved else 1.0).replan(
            PlanConfig(nodes={op_id: NodeConfig(max_batch=4,
                                                batch_wait_ms=1.0)}))
        if reserved:
            assert rep.ok, rep
            assert rep.canary.get("ok") is True
            release.set()
            assert _serve(dep, ref, [4]) == _want(ref, [4])
        else:
            assert not rep.ok and rep.phase == "canary"
            assert rt.dags[f"rsv{reserved}"] is blue_dag
    finally:
        if release is not None:
            release.set()
        rt.stop()


# -- the canary's row comparison ---------------------------------------------

def _row_table(*values):
    return Table([(f"c{i}", object) for i in range(len(values))],
                 [tuple(values)])


@pytest.mark.parametrize("case", ["equal", "one_ulp", "differ", "shape",
                                  "int", "arity"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rows_match_compares_tensors_as_tensors(case, dtype):
    """The canary's comparison returns a message (never raises) for bf16
    columns and mis-shaped tensors; where numpy can represent the values
    its message equals the reference's."""
    dt = getattr(torch, dtype)
    base = torch.linspace(-2, 2, 6, dtype=torch.float32)
    got = base.to(dt)
    want = {"equal": base.to(dt),
            "one_ulp": torch.nextafter(base, base + 1).to(dt)
            if dtype == "float32" else base.to(dt),
            "differ": (base + 0.5).to(dt),
            "shape": base[:4].to(dt),
            "int": base.to(dt),
            "arity": base.to(dt)}[case]
    g_row, w_row = [got, torch.tensor(3)], [want, torch.tensor(3)]
    if case == "int":
        w_row[1] = torch.tensor(4)
    if case == "arity":
        w_row.append(torch.tensor(0))
    msg = t_replan._rows_match(_row_table(*g_row), _row_table(*w_row), 1e-5)
    expect = {"equal": None, "one_ulp": None,
              "differ": "row 0 col 0: values differ",
              "shape": "row 0 col 0: shape (6,) != (4,)",
              "int": "row 0 col 1: values differ",
              "arity": "row 0: arity 2 != 3"}[case]
    assert msg == expect
    if dtype == "float32":
        rmsg = r_replan._rows_match(
            RTable([("a", object), ("b", object)], [tuple(
                v.numpy() for v in g_row)]),
            RTable([(f"c{i}", object) for i in range(len(w_row))],
                   [tuple(v.numpy() for v in w_row)]), 1e-5)
        assert rmsg == msg
    # CUDA-free: the comparison copies to the host, and a mismatched row
    # count is reported before any value is read
    two = Table([("a", object)], [(got,), (got,)])
    assert t_replan._rows_match(two, _row_table(want), 1e-5) == \
        "row count 2 != 1"


# -- both packages' controllers on one script ------------------------------------

class _StubRuntime:
    """The runtime surface the controller reads and writes, answering
    from a scripted metric store; records every knob the controller
    turns."""

    def __init__(self, net):
        self.net = net
        self.detector_interval_s = 0.05
        self.series = {}
        self.batch_cfg = {}
        self.buckets = {}

    def metrics_snapshot(self, prefix=None):
        keys = [k for k in self.series
                if prefix is None or k.startswith(prefix)]
        return {k: list(self.series[k]) for k in keys}

    def configure_batching(self, dag, node, *, max_batch, batch_wait_ms):
        new = (max_batch, batch_wait_ms)
        changed = self.batch_cfg.get((dag, node)) != new
        self.batch_cfg[(dag, node)] = new
        return changed

    def set_node_buckets(self, dag, node, buckets):
        self.buckets[(dag, node)] = tuple(buckets)


def _stub_deployment(P, batched_lowering):
    model = P.model()
    pre, dec = (P.stage_op(model, None, s, model_name="yi", seq_len=16,
                           cache_len=32, measure=False)
                for s in ("prefill", "decode"))
    fl = P.Flow([("tokens", P.Array)])
    node = fl.apply_op(pre, gpu=True, batching=True)
    for _ in range(STEPS):
        node = node.apply_op(dec, gpu=True, batching=True)
    fl.output = node
    plan = P.pipeline(fusion=True, batched_lowering=batched_lowering).run(
        P.Plan.from_dataflow(fl))
    return types.SimpleNamespace(plan=plan,
                                 dag=P.Dag.from_plan(plan, "ctl"))


R = types.SimpleNamespace(
    name="reference", prof=r_prof, ctl=r_ctl_mod, Flow=RFlow, Plan=RPlan,
    Dag=RDag, Net=RNet, Array=jax.Array, stage_op=r_stage_op,
    model=lambda: r_build_model(dataclasses.replace(
        r_tiny("yi-9b"), dtype="float32")),
    pipeline=lambda **kw: r_pipeline(**kw))
T = types.SimpleNamespace(
    name="port", prof=t_prof, ctl=t_ctl_mod, Flow=Dataflow,
    Plan=PhysicalPlan, Dag=RuntimeDag, Net=NetModel, Array=torch.Tensor,
    stage_op=lambda *a, **k: tdc.model_stage_op(*a, **k),
    model=_model,
    pipeline=lambda **kw: build_pipeline(device="cpu", **kw))


def _script(seed):
    """Per tick: (clock advance before it, arrivals as gaps, errors)."""
    rng = np.random.default_rng(seed)
    return [(1.0, [], 0),                                   # idle
            (0.0, [0.8] * 3, 0),                            # sparse
            (0.0, rng.exponential(0.05, 30).tolist(), 0),   # steady
            (0.0, [0.001] * 16, 0),                         # burst
            (0.0, [0.002] * 40, 12),                        # errors
            (0.5, [0.002] * 40, 12),                        # cooldown
            (30.0, [0.5] * 4, 0)]                           # calm


@pytest.mark.parametrize("batched_lowering", [True, False])
def test_controllers_match_on_a_recorded_script(batched_lowering,
                                                monkeypatch):
    out = {}
    for P in (R, T):
        clock = _RecordedClock()
        monkeypatch.setattr(P.ctl, "_mono", clock)
        dep = _stub_deployment(P, batched_lowering)
        (node,) = [n for n in dep.dag.nodes.values() if n.batching]
        rt = _StubRuntime(P.Net(scale=0.0))
        calls = []

        def handler(proposal, P=P, calls=calls):
            calls.append(proposal.to_dict())
            return P.prof.ReplanReport(dag_name="ctl", ok=False,
                                       phase="canary", reason="drill")

        ctl = P.prof.SLOController(
            rt, dep, slo_p99_s=0.05, min_rate=0.5, window_s=1.0,
            replan_cooldown_s=10.0, on_replan=handler,
            profile=P.prof.FlowProfile(
                curves={node.plan_op_id: P.prof.OpLatencyCurve.from_dict(
                    _saturating_curve(node.plan_op_id).to_dict())}))
        events = []
        for advance, gaps, errors in _script(3):
            clock.t += advance
            for g in gaps:
                clock.t += g
                rt.series.setdefault("dag/ctl/request_t", []).append(clock.t)
            for k in range(errors):
                rt.series.setdefault("dag/ctl/error_t", []).append(
                    clock.t - 1e-4 * k)
            ev = ctl.tick()
            events.append((ev.kind, ev.t, ev.arrival_rate, ev.detail))
        out[P.name] = (events, calls, ctl.applied.to_dict(), rt.batch_cfg,
                       rt.buckets)
    assert out["port"] == out["reference"]
    kinds = [e[0] for e in out["port"][0]]
    assert kinds[0] == "idle" and "apply" in kinds
    if not batched_lowering:
        assert "replan" in kinds and len(out["port"][1]) == 1
