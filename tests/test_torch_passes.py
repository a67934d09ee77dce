"""The port's compile-time passes held to the reference package's on the
CPU.

Each case builds one flow twice, once with each package's operators
(the same Python step functions where the annotations allow, twins with
``torch.Tensor``/``jax.Array`` annotations where they do not), runs the
same pass (or pipeline) in each package, and holds the port's plan to the
reference's: op ids, inputs, op kind and name, ``wait_any``, placement,
replicas, hints, locality annotations, lowering annotations and placed
kernels must be equal.  Then: the ``rewrites`` shims, a tiny f32 yi-9b
cascade compiled with competitive execution under a hang fault (tokens
held to the reference's ``reference_decode``), and the locality example
(answers held to the reference example's numpy scores, dispatch to the
executor caching the lookup's key).
"""
import dataclasses
import itertools
import os
import random
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import operators as jops  # noqa: E402
from repro.core import passes as jpasses  # noqa: E402
from repro.core import rewrites as jrewrites  # noqa: E402
from repro.core.dataflow import Dataflow as JFlow  # noqa: E402
from repro.core.ir import PhysicalPlan as JPlan  # noqa: E402
from repro.core.table import Table as JTable  # noqa: E402
from repro.kernels.ops import kernel_step as jkernel_step  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import passes as tpasses  # noqa: E402
from repro_torch.core import rewrites as trewrites  # noqa: E402
from repro_torch.core.dataflow import Dataflow as TFlow  # noqa: E402
from repro_torch.core.ir import PhysicalPlan as TPlan  # noqa: E402
from repro_torch.core.table import Table as TTable  # noqa: E402
from repro_torch.examples import decode_cascade as tdc  # noqa: E402
from repro_torch.examples import recommender as trec  # noqa: E402
from repro_torch.kernels.ops import kernel_step as tkernel_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import NetModel, Runtime  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), os.pardir)

JAX = types.SimpleNamespace(Flow=JFlow, Plan=JPlan, Table=JTable,
                            ops=jops, passes=jpasses, Array=jax.Array,
                            kernel_step=jkernel_step)
TORCH = types.SimpleNamespace(Flow=TFlow, Plan=TPlan, Table=TTable,
                              ops=tops, passes=tpasses, Array=torch.Tensor,
                              kernel_step=tkernel_step)


class StandInConfig:
    """A duck-typed plan config: the same instance drives both packages'
    passes (each package's own ``PlanConfig`` is held to the other in
    ``test_apply_plan_config_pass_matches_reference``)."""

    def __init__(self, placements=None, replicas=None, buckets=None,
                 batched=None, max_batch=None):
        self._placements = dict(placements or {})
        self._replicas = dict(replicas or {})
        self._buckets = dict(buckets or {})
        self._batched = dict(batched or {})
        self._max_batch = dict(max_batch or {})
        self.applied = []

    def placement_overrides(self):
        return dict(self._placements)

    def replica_overrides(self):
        return dict(self._replicas)

    def bucket_overrides(self):
        return dict(self._buckets)

    def batched_overrides(self):
        return dict(self._batched)

    def node(self, op_id):
        return types.SimpleNamespace(max_batch=self._max_batch.get(op_id, 0))

    def apply_runtime(self, runtime, dag):
        self.applied.append(dag.name)


# -- step functions shared by both packages (python values) -----------------

def _inc(a: int, b: int) -> tuple[int, int]:
    return a + 1, b


def _flip(a: int, b: int) -> tuple[int, int]:
    return b, a


def _mix(a: int, b: int) -> tuple[int, int]:
    return a + b, a - b


def _keep(a: int, b: int) -> bool:
    return (a + b) % 3 != 0


def _key_of(a: int, b: int) -> tuple[int, str]:
    return a, f"k{b % 3}"


def _use(a: int, key: str, lookup) -> tuple[int, int]:
    return a, lookup


def _tensor_steps(P):
    """Three tensor steps annotated for package ``P`` (same names)."""
    A = P.Array

    def t_sum(q, k, v):
        return q + k + v

    def t_double(x):
        return x * 2

    def t_neg(x):
        return -x
    t_sum.__annotations__ = {"q": A, "k": A, "v": A, "return": A}
    for f in (t_double, t_neg):
        f.__annotations__ = {"x": A, "return": A}
    return t_sum, t_double, t_neg


def _random_flow(P, rng: random.Random):
    """A random DAG of maps/filters with branches, unions, lookups (by
    column and constant) and hints, built with package ``P``'s
    operators; the same seed gives the same structure in both
    packages."""
    fl = P.Flow([("a", int), ("b", int)])
    frontier = [fl.source]
    for _ in range(rng.randint(2, 8)):
        node = rng.choice(frontier)
        roll = rng.random()
        if roll < 0.45:
            fn = rng.choice([_inc, _flip, _mix])
            hints = {}
            if rng.random() < 0.25:
                hints["competitive_replicas"] = rng.randint(2, 3)
            if rng.random() < 0.2:
                hints["high_variance"] = True
            if rng.random() < 0.2:
                hints["gpu"] = True
            if rng.random() < 0.2:
                hints["batching"] = True
            frontier.append(node.map(fn, names=["a", "b"], **hints))
        elif roll < 0.6:
            frontier.append(node.filter(_keep))
        elif roll < 0.75:
            const = rng.random() < 0.5
            lk = (node.lookup("model", column=False) if const else
                  node.map(_key_of, names=["a", "key"])
                  .lookup("key", column=True))
            frontier.append(lk.map(_use, names=["a", "b"],
                                   gpu=rng.random() < 0.3))
        elif len(frontier) >= 2:
            other = rng.choice([n for n in frontier if n is not node])
            if other is not fl.source and node is not fl.source:
                frontier.append(node.union(other))
    tail = frontier[-1] if frontier[-1] is not fl.source else \
        fl.source.map(_inc, names=["a", "b"])
    if rng.random() < 0.3:
        tail = tail.groupby("a").agg("sum", "b")
    fl.output = tail
    return fl


def _tensor_flow(P, *, kernel: bool, replicas: int = 0):
    """(q, k, v) -> flash_attention step (or a sum) -> double -> neg, all
    on the gpu class, the first op with ``replicas`` competitive
    replicas."""
    t_sum, t_double, t_neg = _tensor_steps(P)
    fl = P.Flow([("q", P.Array), ("k", P.Array), ("v", P.Array)])
    first = (P.kernel_step("flash_attention", causal=True) if kernel
             else t_sum)
    node = fl.map(first, names=["q"], gpu=True,
                  competitive_replicas=replicas)
    fl.output = node.map(t_double, names=["q"], gpu=True).map(
        t_neg, names=["q"], gpu=True, batching=True)
    return fl


def _flow_pair(build, *args, **kw):
    return build(JAX, *args, **kw), build(TORCH, *args, **kw)


def plan_view(plan):
    """What must be equal across the packages, per op in plan order."""
    out = []
    for o in plan.ops:
        op = o.op
        out.append((
            o.op_id, tuple(o.inputs), type(op).__name__, op.name,
            o.wait_any, o.placement, o.replicas, o.high_variance,
            o.batching, o.locality_ref_column, o.locality_const,
            o.batchable, tuple(o.batch_buckets), o.device_resident,
            tuple(o.kernels), getattr(op, "bucket_sizes", None)))
    return (out, plan.output_id)


def _run_pass(P, fl, make_pass):
    plan = P.Plan.from_dataflow(fl)
    return make_pass(P).run(plan, P.passes.PassContext())


def _random_pair(seed):
    rng_j, rng_t = random.Random(seed), random.Random(seed)
    return _random_flow(JAX, rng_j), _random_flow(TORCH, rng_t)


# -- per pass ----------------------------------------------------------------

PASSES = {
    "competitive": lambda P: P.passes.CompetitivePass(default_replicas=3),
    "competitive-0": lambda P: P.passes.CompetitivePass(default_replicas=0),
    "fuse-lookups": lambda P: P.passes.FuseLookupsPass(),
    "fuse-chains": lambda P: P.passes.FuseChainsPass(),
    "fuse-chains-lookup-aware":
        lambda P: P.passes.FuseChainsPass(preserve_lookup_boundaries=True),
    "place-kernels": lambda P: P.passes.PlaceKernelsPass(),
}


@pytest.mark.parametrize("name", sorted(PASSES))
def test_pass_matches_reference_on_random_flows(name):
    for seed in range(12):
        fj, ft = _random_pair(seed)
        pj = _run_pass(JAX, fj, PASSES[name])
        pt = _run_pass(TORCH, ft, PASSES[name])
        assert plan_view(pt) == plan_view(pj), f"seed {seed}"


def test_competitive_pass_makes_replicas_and_a_cpu_anyof():
    fj, ft = _flow_pair(_tensor_flow, kernel=True, replicas=2)
    pj = _run_pass(JAX, fj, PASSES["competitive"])
    pt = _run_pass(TORCH, ft, PASSES["competitive"])
    assert plan_view(pt) == plan_view(pj)
    anyofs = [o for o in pt.ops if o.wait_any]
    assert len(anyofs) == 1 and anyofs[0].placement == "cpu"
    assert isinstance(anyofs[0].op, tops.AnyOf)
    reps = [pt.op(i) for i in anyofs[0].inputs]
    assert len(reps) == 2 and all(r.placement == "gpu" and r.replicas == 0
                                  for r in reps)


def test_fuse_lookups_pass_annotates_for_locality():
    def build(P):
        fl = P.Flow([("a", int), ("b", int)])
        lk = fl.map(_key_of, names=["a", "key"]).lookup("key", column=True)
        const = lk.map(_use, names=["a", "b"]).lookup("model")
        fl.output = const.map(_use, names=["a", "b"])
        return fl
    fj, ft = _flow_pair(build)
    pj = _run_pass(JAX, fj, PASSES["fuse-lookups"])
    pt = _run_pass(TORCH, ft, PASSES["fuse-lookups"])
    assert plan_view(pt) == plan_view(pj)
    refs = sorted(((o.locality_ref_column, o.locality_const)
                   for o in pt.ops if o.locality_key is not None), key=str)
    assert refs == [("key", None), (None, "model")]


@pytest.mark.parametrize("kernel", [False, True])
def test_apply_plan_config_pass_matches_reference(kernel):
    """Each package's own ``PlanConfig``, built from one dict."""
    from repro.profiling import PlanConfig as JPlanConfig
    from repro_torch.profiling import PlanConfig as TPlanConfig
    cfg = {"nodes": {"1": {"placement": "cpu"},
                     "2": {"competitive_replicas": 3,
                           "batched_lowering": False},
                     "3": {"placement": "gpu", "batch_buckets": [1, 4]}}}
    fj, ft = _flow_pair(_tensor_flow, kernel=kernel)
    pj = _run_pass(JAX, fj, lambda P: P.passes.ApplyPlanConfigPass(
        JPlanConfig.from_dict(cfg)))
    pt = _run_pass(TORCH, ft, lambda P: P.passes.ApplyPlanConfigPass(
        TPlanConfig.from_dict(cfg)))
    assert plan_view(pt) == plan_view(pj)
    assert pt.op(1).placement == "cpu"
    assert pt.op(2).replicas == 3 and pt.op(2).high_variance


FLAGS = ("fusion", "competitive_exec", "locality", "jit_fusion",
         "batched_lowering", "place_kernels", "plan_config")


@pytest.mark.parametrize("flags", [
    dict(zip(FLAGS, bits))
    for bits in itertools.product((False, True), repeat=len(FLAGS))],
    ids=lambda f: "".join("1" if f[k] else "0" for k in FLAGS))
def test_build_pipeline_matches_reference(flags):
    kw = dict(flags)
    cfg = StandInConfig(replicas={2: 2}, buckets={3: (1, 2, 8)},
                        batched={4: False}, placements={5: "gpu"})
    kw["plan_config"] = cfg if kw["plan_config"] else None
    jpipe = jpasses.build_pipeline(**kw)
    tpipe = tpasses.build_pipeline(device="cpu", **kw)
    assert [p.name for p in tpipe.passes] == [
        p.name.replace("jax", "torch") for p in jpipe.passes]
    flows = [_flow_pair(_tensor_flow, kernel=k, replicas=r)
             for k, r in ((True, 2), (False, 0))]
    flows += [_random_pair(seed) for seed in (3, 7)]
    for fj, ft in flows:
        pj = jpipe.run(JPlan.from_dataflow(fj))
        pt = tpipe.run(TPlan.from_dataflow(ft))
        assert plan_view(pt) == plan_view(pj)


def test_verified_pipeline_accepts_every_real_pass():
    for fj, ft in [_flow_pair(_tensor_flow, kernel=True, replicas=2),
                   _random_pair(5)]:
        pj = jpasses.build_pipeline(fusion=True, competitive_exec=True,
                                    locality=True, verify=True).run(
            JPlan.from_dataflow(fj))
        pt = tpasses.build_pipeline(fusion=True, competitive_exec=True,
                                    locality=True, verify=True,
                                    device="cpu").run(
            TPlan.from_dataflow(ft))
        assert plan_view(pt) == plan_view(pj)


# -- rewrites ----------------------------------------------------------------

REWRITES = {
    "fuse_chains": lambda R, fl: R.fuse_chains(fl),
    "fuse_chains_lookup_aware":
        lambda R, fl: R.fuse_chains(fl, preserve_lookup_boundaries=True),
    "competitive": lambda R, fl: R.competitive(fl, default_replicas=2),
    "fuse_lookups": lambda R, fl: R.fuse_lookups(fl),
    "apply_rewrites": lambda R, fl: R.apply_rewrites(
        fl, fusion=True, competitive_exec=True, locality=True),
}


def _sorted_dicts(t):
    return sorted(sorted(d.items()) for d in t.to_dicts())


class _KV:
    """A KVS stand-in for ``execute_local``: every key holds 7."""

    def kvs_get(self, key):
        return 7

    kvs = True


@pytest.mark.parametrize("name", sorted(REWRITES))
def test_rewrites_round_trip_like_the_reference(name):
    for seed in range(8):
        fj, ft = _random_pair(seed)
        oj = REWRITES[name](jrewrites, fj)
        ot = REWRITES[name](trewrites, ft)
        vj = plan_view(JPlan.from_dataflow(oj))
        vt = plan_view(TPlan.from_dataflow(ot))
        assert vt == vj, f"seed {seed}"
        rows = [(a, b) for a, b in zip(range(-4, 5), range(3, 12))]
        base = _sorted_dicts(ft.execute_local(
            TTable([("a", int), ("b", int)], rows), _KV()))
        got = _sorted_dicts(ot.execute_local(
            TTable([("a", int), ("b", int)], rows), _KV()))
        assert got == base, f"seed {seed}: the rewrite changed answers"


# -- competitive execution on a model cascade, under a hang fault -----------

class _Jitted:
    def __init__(self, model):
        self.prefill = jax.jit(model.prefill, static_argnums=2)
        self.decode_step = jax.jit(model.decode_step)


def test_competitive_cascade_tokens_match_reference_under_hangs():
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import FaultPlan
    sys.path.insert(0, REPO)
    from examples import decode_cascade as jdc
    n, steps = 4, 2
    jcfg = dataclasses.replace(jdc.get_tiny_config("yi-9b"),
                               dtype="float32")
    jm = jdc.build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (n, tdc.SEQ), dtype=np.int32)
    want = [jdc.reference_decode(_Jitted(jm), jparams,
                                 jnp.asarray(toks[i:i + 1]), steps=steps,
                                 cache_len=tdc.CACHE)[0] for i in range(n)]
    cfg = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32",
                              use_kernels=True)
    model = build_model(cfg, device="cpu")
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    pre, dec = tdc.build_ops(model, params)
    rt = Runtime(n_cpu=1, n_gpu=2, net=NetModel(scale=0.0), device="cpu",
                 tracer=Tracer(sample_rate=1.0), hang_timeout_s=30.0)
    try:
        dep = tdc.build(rt, pre, dec, steps=steps, competitive=2,
                        name="competitive")
        anyof = dep.plan.op(dep.plan.output_id)
        assert anyof.wait_any and anyof.placement == "cpu"
        assert len(anyof.inputs) == 2
        inj = rt.set_fault_plan(FaultPlan(seed=5).hang(
            rate=0.5, hang_s=0.3, classes=("gpu",)))
        got = []
        for i in range(n):
            out = dep.execute(TTable([("tokens", torch.Tensor)],
                                     [(torch.from_numpy(toks[i]),)]))
            got.append(int(out.result(60).rows[0].values[0]))
        assert got == want
        assert inj.counts["hang"] >= 1
        assert rt.pool.fault_counts["wedge"] == 0
    finally:
        rt.stop()


# -- locality ----------------------------------------------------------------

def test_recommender_matches_reference_scores_and_dispatches_locally():
    from repro.runtime import NetModel as JNet
    from repro.runtime import Runtime as JRuntime
    sys.path.insert(0, REPO)
    from examples import recommender as jrec
    users = 8
    jrt = JRuntime(n_cpu=2, net=JNet(scale=0.0))
    try:
        cat = np.random.default_rng(0).random((jrec.PRODUCTS, jrec.DIM))
        for i in range(jrec.N_CATEGORIES):
            jrt.kvs.put(f"cat{i}", cat, charge=False)
        fl = jrec.build_flow()
        fl.deploy(jrt, fusion=True, locality=True)
        want = [tuple(fl.execute(JTable([("user", int), ("clicks", int)],
                                        [(u, u * 7)])).result(60)
                      .rows[0].values) for u in range(users)]
    finally:
        jrt.stop()
    assert [w[0] for w in want] == [a for a, _ in trec.numpy_scores(users)]
    res = trec.run(True, device="cpu", users=users,
                   net=NetModel(scale=0.0))
    assert [a[0] for a in res["answers"]] == [w[0] for w in want]
    np.testing.assert_allclose([a[1] for a in res["answers"]],
                               [w[1] for w in want], rtol=1e-12)
    for key, ex, where in res["dispatch"]:
        assert ex in where, f"{key} ran on {ex}, cached on {where}"
