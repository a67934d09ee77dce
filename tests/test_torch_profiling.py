"""The port's profiling layer held to the reference package's on the CPU:
the shared crossover rule and ``ChainProfile``, ``FlowProfile`` curves,
``erlang_c``, the latency estimator and ``propose`` on plans each package
compiles from the same tiny f32 yi-9b cascade, ``profile_plan`` and the
stages' cost hooks on that cascade, the admission gate's estimator
branch, and the cost-based planner's decisions.

Every input comes from a numpy seed and goes through both packages.  The
estimator, optimizer and gate do the same float operations in the same
order in both, so their outputs are compared exactly; ``erlang_c`` to
1e-12.  Timings are never compared, only what the profiler counts.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.lowering as r_low  # noqa: E402
import repro.core.planner as r_planner  # noqa: E402
import repro.profiling as r_prof  # noqa: E402
import repro.profiling.estimator as r_est  # noqa: E402
import repro.serving.admission as r_adm  # noqa: E402
import repro_torch.core.lowering as t_low  # noqa: E402
import repro_torch.core.planner as t_planner  # noqa: E402
import repro_torch.profiling as t_prof  # noqa: E402
import repro_torch.profiling.estimator as t_est  # noqa: E402
import repro_torch.serving.admission as t_adm  # noqa: E402
from repro.configs import get_tiny_config as r_tiny  # noqa: E402
from repro.core.dataflow import Dataflow as RFlow  # noqa: E402
from repro.core.ir import PhysicalPlan as RPlan  # noqa: E402
from repro.core.passes import build_pipeline as r_pipeline  # noqa: E402
from repro.core.table import Table as RTable  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models.registry import model_stage_op as r_stage_op  # noqa: E402
from repro.runtime.netmodel import NetModel as RNet  # noqa: E402
from repro_torch.configs import get_tiny_config as t_tiny  # noqa: E402
from repro_torch.core.dataflow import Dataflow as TFlow  # noqa: E402
from repro_torch.core.ir import PhysicalPlan as TPlan  # noqa: E402
from repro_torch.core.passes import build_pipeline as t_pipeline  # noqa: E402
from repro_torch.core.table import Table as TTable  # noqa: E402
from repro_torch.models import build_model as t_build_model  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.runtime.netmodel import NetModel as TNet  # noqa: E402

SEQ, CACHE, STEPS = 16, 32, 2

REF = types.SimpleNamespace(
    name="reference", low=r_low, prof=r_prof, est=r_est, adm=r_adm,
    planner=r_planner, Flow=RFlow, Plan=RPlan, Table=RTable, Net=RNet,
    Array=jax.Array, ones=lambda n: jnp.ones(n, jnp.float32),
    tokens=lambda a: jnp.asarray(a),
    model=lambda: r_build_model(dataclasses.replace(
        r_tiny("yi-9b"), dtype="float32")),
    init=lambda m: m.init(jax.random.PRNGKey(0)),
    stage_op=r_stage_op, pipeline=r_pipeline)
PORT = types.SimpleNamespace(
    name="port", low=t_low, prof=t_prof, est=t_est, adm=t_adm,
    planner=t_planner, Flow=TFlow, Plan=TPlan, Table=TTable, Net=TNet,
    Array=torch.Tensor, ones=lambda n: torch.ones(n),
    tokens=lambda a: torch.from_numpy(a),
    model=lambda: t_build_model(dataclasses.replace(
        t_tiny("yi-9b"), dtype="float32", use_kernels=True), device="cpu"),
    init=lambda m: m.init(torch.Generator().manual_seed(0)),
    stage_op=t_registry.model_stage_op,
    pipeline=lambda **kw: t_pipeline(device="cpu", **kw))


def _both(fn):
    """``fn(P)`` on each package; asserts the two results are equal and
    returns the port's."""
    got = {P.name: fn(P) for P in (REF, PORT)}
    assert got["port"] == got["reference"]
    return got["port"]


# -- the crossover rule and ChainProfile ---------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_profile_and_crossover_match(seed):
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(80):
        u = rng.random()
        if u < 0.35:
            script.append(("row", float(rng.lognormal(-6.0, 0.6))))
        elif u < 0.8:
            script.append(("batched", int(rng.choice([1, 2, 4, 8, 16])),
                           float(rng.lognormal(-5.5, 0.4))))
        else:
            script.append(("route", int(rng.choice([1, 1, 2, 3, 4, 12]))))
    costs = [(None if rng.random() < 0.2 else float(rng.lognormal(-7, 1)),
              {int(b): float(rng.lognormal(-5, 1))
               for b in rng.choice([1, 2, 4, 8, 16, 32], int(
                   rng.integers(0, 5)), replace=False)},
              int(rng.choice([3, 16, 1024]))) for _ in range(30)]

    def run(P):
        p = P.low.ChainProfile(alpha=0.2 + 0.1 * seed)
        routes = []
        for step in script:
            if step[0] == "row":
                p.note_per_row(step[1])
            elif step[0] == "batched":
                p.note_batched(step[1], step[2])
            else:
                n = step[1]
                routes.append(p.route_per_row(n, P.low.bucket_rows(n)))
        d = p.to_dict()
        back = P.low.ChainProfile.from_dict(json.loads(json.dumps(d)))
        empty = P.low.ChainProfile.from_dict(P.low.ChainProfile().to_dict())
        return (routes, p.crossover_rows(), p.crossover_rows(max_n=3), d,
                back.to_dict(), back.snapshot(), p.snapshot(),
                empty.snapshot(),
                [P.low.crossover_from_costs(a, b, m) for a, b, m in costs])

    got = _both(run)
    assert True in got[0] and False in got[0]
    assert got[1] is not None


# -- FlowProfile curves ----------------------------------------------------------

def _profile_dict(rng, keys, *, with_gaps=True):
    """A random ``FlowProfile.to_dict()``: per key, a per-row cost (or
    None) and a random subset of buckets with increasing means."""
    curves = {}
    for k in keys:
        if with_gaps and rng.random() < 0.15:
            continue
        bs = sorted(int(b) for b in rng.choice(
            [1, 2, 4, 8, 16, 32], int(rng.integers(1, 6)), replace=False))
        base, slope = float(rng.lognormal(-6, 0.5)), float(
            rng.lognormal(-9, 0.5))
        curves[str(k)] = {
            "key": int(k), "name": f"op{k}",
            "per_row_s": (None if rng.random() < 0.3
                          else float(rng.lognormal(-6.5, 0.5))),
            "buckets": {str(b): {"mean_s": base + slope * b,
                                 "p99_s": (base + slope * b)
                                 * float(1 + rng.random()),
                                 "cv": float(rng.random()), "runs": 3,
                                 "out_bytes": int(b * rng.integers(8, 4096))}
                        for b in bs}}
    return {"meta": {"kind": "plan", "runs": 3}, "curves": curves}


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_profile_round_trip_and_curves_match(seed, tmp_path):
    rng = np.random.default_rng(seed)
    d = _profile_dict(rng, range(1, 9), with_gaps=False)
    notes = [(float(rng.lognormal(-6, 0.5)), int(rng.choice([2, 8, 64])),
              float(rng.lognormal(-5, 0.5))) for _ in range(6)]

    def run(P):
        fp = P.prof.FlowProfile.from_dict(json.loads(json.dumps(d)))
        path = tmp_path / f"{P.name}.json"
        fp.save(str(path))
        fp = P.prof.FlowProfile.load(str(path))
        out = [fp.to_dict()]
        for k in sorted(fp.curves):
            c = fp.curves[k]
            out.append([(c.service_s(b), c.p99_s(b), c.row_s(b), c.cv(b),
                         c.out_bytes_per_row(b)) for b in range(1, 65)])
            out.append(c.crossover_rows())
        # live refresh: a ChainProfile folded into one curve
        live = P.low.ChainProfile()
        for pr, b, s in notes:
            live.note_per_row(pr)
            live.note_batched(b, s)
        c = fp.curves[min(fp.curves)]
        out.append((c.merge_chain_profile(live), c.to_dict(),
                    c.merge_chain_profile(live.to_dict())))
        return out

    got = _both(run)
    assert got[0] == json.loads(json.dumps(d))


def test_erlang_c_matches_on_a_grid():
    for c in range(0, 9):
        for a in np.linspace(0.0, 9.0, 37).tolist():
            r, t = r_prof.erlang_c(c, a), t_prof.erlang_c(c, a)
            assert abs(r - t) <= 1e-12, (c, a)


# -- the estimator and the optimizer on the cascade's plans -------------------

def _cascade_plan(P, *, fusion, batching):
    """The tiny f32 yi-9b prefill + ``STEPS`` decode cascade, compiled by
    ``P``'s pass pipeline (no weights: building a plan runs nothing)."""
    model = P.model()
    pre, dec = (P.stage_op(model, None, s, model_name="yi", seq_len=SEQ,
                           cache_len=CACHE, measure=False)
                for s in ("prefill", "decode"))
    fl = P.Flow([("tokens", P.Array)])
    node = fl.apply_op(pre, gpu=True, batching=batching)
    for _ in range(STEPS):
        node = node.apply_op(dec, gpu=True, batching=batching)
    fl.output = node
    return P.pipeline(fusion=fusion).run(P.Plan.from_dataflow(fl))


PLAN_SHAPES = [dict(fusion=True, batching=True),
               dict(fusion=False, batching=True),
               dict(fusion=False, batching=False)]


@pytest.fixture(scope="module", params=PLAN_SHAPES,
                ids=lambda s: "-".join(f"{k}={v}" for k, v in s.items()))
def plans(request):
    got = {P.name: _cascade_plan(P, **request.param) for P in (REF, PORT)}
    ids = [[o.op_id for o in p.ops] for p in got.values()]
    assert ids[0] == ids[1]
    return got


def _config_dict(rng, op_ids):
    return {"slo_p99_s": 0.1, "arrival_rate": 50.0, "notes": [],
            "nodes": {str(i): {"max_batch": int(rng.choice([1, 4, 8])),
                               "batch_buckets": [1, 2, 4, 8],
                               "batch_wait_ms": float(rng.random() * 5),
                               "batched_lowering": bool(rng.random() < .7),
                               "target_replicas": int(rng.integers(1, 3)),
                               "competitive_replicas": 0,
                               "placement": "gpu"} for i in op_ids}}


@pytest.mark.parametrize("rate", [0.5, 40.0, 900.0])
def test_estimator_and_propose_match(plans, rate):
    rng = np.random.default_rng(int(rate))
    op_ids = [o.op_id for o in plans["port"].ops]
    prof = _profile_dict(rng, op_ids)
    cfg = _config_dict(rng, op_ids)

    def run(P):
        plan = plans[P.name]
        fp = P.prof.FlowProfile.from_dict(prof)
        net = P.Net()
        fault = P.est.FaultStats(crash_rate=0.2, wedge_rate=0.1,
                                 retry_rate=0.05 * rate, requeue_rate=0.3,
                                 detection_s=0.05)
        out = []
        for f in (None, fault):
            est = P.prof.LatencyEstimator(fp, net=net, fault=f)
            for c in (P.prof.PlanConfig(), P.prof.PlanConfig.from_dict(cfg)):
                for rows in (1, 2):
                    e = est.estimate(plan, c, P.prof.Workload(rate, rows))
                    out.append((e.summary(), e.meets(0.05),
                                {k: dataclasses.asdict(v)
                                 for k, v in e.nodes.items()}))
        for slo in (0.02, 0.5):
            out.append(P.prof.propose(plan, slo, rate, profile=fp,
                                      net=net).to_dict())
        return out

    _both(run)


# -- profile_plan and the stages' cost hooks on the cascade -------------------

def _row_bytes(model):
    """Bytes of one row of decode state: tok and pos (int32) and every
    cache leaf at batch 1, from the shapes."""
    _, _, leaves = t_registry._cache_layout(model, CACHE)
    return 8 + sum(t.numel() * t.element_size() for t in leaves)


def test_profile_plan_matches_reference_buckets_and_bytes():
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 512, (1, SEQ), dtype=np.int32)
    sizes = (1, 2)
    got = {}
    for P in (REF, PORT):
        model = P.model()
        pre, dec = (P.stage_op(model, P.init(model), s, model_name="yi",
                               seq_len=SEQ, cache_len=CACHE, measure=False)
                    for s in ("prefill", "decode"))
        fl = P.Flow([("tokens", P.Array)])
        node = fl.apply_op(pre, gpu=True, batching=True)
        for _ in range(STEPS):
            node = node.apply_op(dec, gpu=True, batching=True)
        fl.output = node
        plan = P.pipeline(fusion=True).run(P.Plan.from_dataflow(fl))
        sample = P.Table([("tokens", P.Array)], [(P.tokens(toks[0]),)])
        got[P.name] = P.prof.profile_plan(plan, sample, batch_sizes=sizes,
                                          runs=1, warmup=1)
    r, t = got["reference"], got["port"]
    assert t.meta == r.meta
    assert sorted(t.curves) == sorted(r.curves)
    for k in t.curves:
        tc, rc = t.curves[k], r.curves[k]
        assert sorted(tc.buckets) == sorted(rc.buckets) == list(sizes)
        assert {b: (s.out_bytes, s.runs) for b, s in tc.buckets.items()} \
            == {b: (s.out_bytes, s.runs) for b, s in rc.buckets.items()}
        assert tc.per_row_s is not None and rc.per_row_s is not None
    (curve,) = t.curves.values()
    per_row = _row_bytes(PORT.model())
    assert {b: s.out_bytes for b, s in curve.buckets.items()} == \
        {b: b * per_row + 64 for b in sizes}


def test_cost_hooks_seed_the_profile_with_bytes_from_shapes():
    model = PORT.model()
    params = PORT.init(model)
    pre, dec = (t_registry.model_stage_op(
        model, params, s, model_name="yi", seq_len=SEQ, cache_len=CACHE,
        runs=2) for s in ("prefill", "decode"))
    lazy = t_registry.model_stage_op(model, params, "decode",
                                     cache_len=CACHE, measure=False)
    assert lazy.cost_hook is None and dec.cost_hook is not None
    fl = TFlow([("tokens", torch.Tensor)])
    fl.output = fl.apply_op(pre, gpu=True).apply_op(dec, gpu=True)
    plan = PORT.pipeline(fusion=True).run(TPlan.from_dataflow(fl))
    fp = t_prof.profiler.seed_from_model_ops(plan, batch_sizes=(1, 2, 4))
    (curve,) = fp.curves.values()
    per_row = _row_bytes(model)
    for b, st in curve.buckets.items():
        assert st.out_bytes == b * per_row      # the last stage's payload
        assert st.runs == 2 and st.mean_s > 0 and st.p99_s >= 0
    hook = dec.cost_hook(3)
    assert hook["out_bytes"] == 3 * per_row and hook["runs"] == 2


# -- the admission gate's estimator branch --------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for m in (r_adm, t_adm):
        monkeypatch.setattr(m, "_mono", c)
    return c


def _decision(d):
    return (d.action, d.klass, d.reason, d.estimate_s, d.deadline_s,
            None if d.degrade is None else dataclasses.asdict(d.degrade))


def test_admission_estimator_gate_matches(plans, clock):
    """``_estimate_p99`` and ``_bottleneck_cost_s`` with and without a
    config, and the decisions of gates holding the plan and a profile on
    a scripted arrival sequence whose deadlines straddle the estimates."""
    rng = np.random.default_rng(11)
    op_ids = [o.op_id for o in plans["port"].ops]
    prof = _profile_dict(rng, op_ids, with_gaps=False)
    cfg = _config_dict(rng, op_ids)
    script = [(float(rng.exponential(0.004)),
               ["interactive", "batch", "best_effort", None][
                   int(rng.integers(4))],
               [None, 0.02, 0.2, 2.0][int(rng.integers(4))],
               int(rng.integers(0, 6)), bool(rng.integers(0, 8) == 0))
              for _ in range(400)]

    def run(P):
        clock.t = 1000.0
        plan = plans[P.name]
        fp = P.prof.FlowProfile.from_dict(prof)
        depth = [0]
        gates = [P.adm.AdmissionController(plan, fp, net=P.Net(scale=0.0),
                                           queue_depth_fn=lambda: depth[0]),
                 P.adm.AdmissionController(
                     plan, fp, P.prof.PlanConfig.from_dict(cfg),
                     net=P.Net(), queue_depth_fn=lambda: depth[0])]
        out = [[(g._estimate_p99(lam), g._bottleneck_cost_s())
                for lam in (0.0, 0.5, 50.0, 500.0)] for g in gates]
        for gap, klass, deadline, d, hedge in script:
            clock.t += gap
            depth[0] = d
            for g in gates:
                if hedge:
                    out.append(g.note_hedge(klass, deadline_s=deadline))
                else:
                    out.append(_decision(g.admit(klass, deadline)))
        gates[0].update(config=P.prof.PlanConfig.from_dict(cfg))
        out.append((gates[0]._estimate_p99(50.0),
                    gates[0]._bottleneck_cost_s()))
        return out, [sorted(g.snapshot().items()) for g in gates]

    out, _ = _both(run)
    decided = [o for o in out if isinstance(o, tuple) and len(o) == 6]
    reasons = {o[2] for o in decided}
    assert {"admit", "shed"} <= {o[0] for o in decided}
    assert "deadline_risk" in reasons and "ok" in reasons


# -- the cost-based planner ---------------------------------------------------------

def _planner_flow(P):
    A = P.Array

    def pre(x: A) -> A:
        return x * 2.0

    def model(x: A) -> A:
        return x + 1.0

    def score(x: A, table) -> float:
        return float(x.sum())

    fl = P.Flow([("x", A)])
    fl.output = (fl.map(pre, names=["x"], gpu=True)
                 .map(model, names=["x"], gpu=True)
                 .lookup("table")
                 .map(score, names=["s"]))
    return fl


#: per node in sorted order: (mean_s, cv, out_bytes)
PROFILE_SETS = {
    "hop-dominated": [(2e-4, 0.1, 4 << 20), (3e-4, 0.2, 4 << 20),
                      (1e-4, 0.1, 1 << 20), (5e-5, 0.0, 8)],
    "compute-heavy": [(5e-2, 0.1, 1024), (8e-2, 0.9, 1024),
                      (3e-2, 0.1, 512), (2e-2, 0.7, 8)],
    "mixed": [(2e-4, 0.6, 2 << 20), (4e-2, 0.8, 64), (1e-3, 0.1, 128 << 10),
              (1e-2, 0.05, 8)],
}


#: the reference's notes name JAX and XLA where the port's name tensors
NOTE_WORDING = [("gpu jax map edges are XLA-lowerable",
                 "gpu tensor map edges are lowerable"),
                ("vmap over row batches", "batch the row batches")]


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("name", sorted(PROFILE_SETS))
def test_make_plan_matches_with_the_same_profiles(name, rows, monkeypatch):
    def run(P):
        fl = _planner_flow(P)
        nodes = [n for n in fl.sorted_nodes() if n.op is not None]
        order = {n.id: i for i, n in enumerate(nodes)}
        profiles = {n.id: P.planner.OpProfile(mean_s=m, cv=cv,
                                              out_bytes=ob, runs=3)
                    for n, (m, cv, ob) in zip(nodes, PROFILE_SETS[name])}
        monkeypatch.setattr(P.planner, "profile_flow",
                            lambda *a, **k: profiles)
        sample = P.Table([("x", P.Array)], [(P.ones(4),)] * rows)
        plan = P.planner.make_plan(fl, sample, net=P.Net())
        notes = list(plan.notes)
        for ref, port in NOTE_WORDING:
            notes = [s.replace(ref, port) for s in notes]
        for nid, i in order.items():
            notes = [s.replace(f"node {nid} ", f"node #{i} ") for s in notes]
        return (plan.flags, {order[k]: v for k, v in plan.replicas.items()},
                notes, [(n.op.high_variance, n.op.competitive_replicas)
                        for n in nodes])

    flags = _both(run)[0]
    if name == "hop-dominated":
        assert flags["fusion"] and flags["locality"]
    if name == "compute-heavy":
        assert flags["competitive_exec"] and not flags["fusion"]


def _double(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def _inc(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def test_warm_takes_the_batched_path_where_the_router_would_not():
    """``BatchedJittedFuse.warm`` bypasses a router that measured the
    per-row path cheaper, builds the bucket's entry, answers as
    ``apply`` does, and leaves the router as it found it."""
    fl = TFlow([("x", torch.Tensor)])
    fl.output = fl.map(_double, names=["x"], gpu=True).map(
        _inc, names=["x"], gpu=True)
    (op,) = PORT.pipeline(fusion=True).run(TPlan.from_dataflow(fl)).ops
    chain = op.op
    assert isinstance(chain, t_low.BatchedJittedFuse)
    prof = chain.profile()
    prof.note_per_row(1e-6)
    for _ in range(2):
        prof.note_batched(4, 1.0)
    rows = TTable([("x", torch.Tensor)],
                  [(torch.full((3,), float(i)),) for i in range(3)])
    assert chain._route_per_row(3)
    b0, r0 = chain.batch_dispatches, chain.row_dispatches
    built = t_low.EXECUTABLE_CACHE.traces()
    out = chain.warm([rows])
    assert (chain.batch_dispatches - b0, chain.row_dispatches - r0) == (1, 0)
    assert t_low.EXECUTABLE_CACHE.traces() == built + 1
    assert chain.adaptive_routing
    want = [torch.full((3,), 2.0 * i + 1) for i in range(3)]
    assert all(torch.equal(r.values[0], w) for r, w in zip(out.rows, want))
    assert [torch.equal(r.values[0], w)
            for r, w in zip(chain.apply([rows]).rows, want)] == [True] * 3
