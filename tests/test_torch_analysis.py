"""The port's static plan verifier held to the reference package's on the
CPU.

One case per diagnostic code, on the plans of the reference's own
``tests/test_analysis.py`` (CF101 through CF502): each flow is built
twice, once with each package's operators (step functions annotated
``jax.Array`` on one side and ``torch.Tensor`` on the other, the same
arithmetic), and the multiset of (code, op id, severity) of the port's
report must equal the reference's.  Messages are not compared.  CF103
checks each package's own kernel rules: the reference's tile
divisibility, the port's CUDA launch rules; the case picks a shape that
breaks both.  Then ``compile_flow(verify=...)`` rejecting before
anything runs, the abstract walk allocating nothing and launching no
kernel, the CLI, and the shipped examples.
"""
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import analysis as janalysis  # noqa: E402
from repro.analysis import cli as jcli  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core import passes as jpasses  # noqa: E402
from repro.core.dataflow import Dataflow as JFlow  # noqa: E402
from repro.core.ir import PhysicalPlan as JPlan  # noqa: E402
from repro.core.table import Table as JTable  # noqa: E402
from repro.kernels.ops import kernel_step as jkernel_step  # noqa: E402
from repro.obs import keys as JK  # noqa: E402
from repro.runtime.runtime import Runtime as JRuntime  # noqa: E402
from repro_torch import analysis as tanalysis  # noqa: E402
from repro_torch.analysis import cli as tcli  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import passes as tpasses  # noqa: E402
from repro_torch.core.compiler import compile_flow  # noqa: E402
from repro_torch.core.dataflow import Dataflow as TFlow  # noqa: E402
from repro_torch.core.ir import PhysicalPlan as TPlan  # noqa: E402
from repro_torch.core.lowering import (EXECUTABLE_CACHE,  # noqa: E402
                                       BatchedJittedFuse, array_annotation)
from repro_torch.core.table import Table as TTable  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.ops import kernel_step as tkernel_step  # noqa: E402
from repro_torch.obs import keys as TK  # noqa: E402
from repro_torch.runtime import NetModel, Runtime  # noqa: E402

J = types.SimpleNamespace(
    name="jax", Flow=JFlow, Plan=JPlan, Table=JTable, ops=jops,
    passes=jpasses, an=janalysis, Array=jax.Array, K=JK,
    kernel_step=lambda: jkernel_step("flash_attention", causal=True,
                                     block_q=48, block_k=32),
    spec=lambda shape: jax.ShapeDtypeStruct(shape, jnp.float32),
    zeros=lambda n: np.zeros(n, np.float32),
    ones=lambda n: jnp.ones((n, n)),
    cat=lambda x: jnp.concatenate([x, x]),
    runtime=lambda **kw: JRuntime(n_cpu=1, **kw))
T = types.SimpleNamespace(
    name="torch", Flow=TFlow, Plan=TPlan, Table=TTable, ops=tops,
    passes=tpasses, an=tanalysis, Array=torch.Tensor, K=TK,
    kernel_step=lambda: tkernel_step("flash_attention", causal=True),
    spec=lambda shape: torch.empty(shape, dtype=torch.float32,
                                   device="meta"),
    zeros=lambda n: torch.zeros(n),
    ones=lambda n: torch.ones((n, n)),
    cat=lambda x: torch.cat([x, x]),
    runtime=lambda **kw: Runtime(n_cpu=1, device="cpu", **kw))


class StandInConfig:
    """A duck-typed plan config driving both packages (the SLO optimizer's
    ``PlanConfig`` is not ported yet): node 2's buckets and merge cap."""

    def __init__(self, buckets=None, max_batch=None):
        self._buckets = dict(buckets or {})
        self._max_batch = dict(max_batch or {})

    def placement_overrides(self):
        return {}

    def replica_overrides(self):
        return {}

    def bucket_overrides(self):
        return dict(self._buckets)

    def batched_overrides(self):
        return {}

    def node(self, op_id):
        return types.SimpleNamespace(max_batch=self._max_batch.get(op_id, 0))


def _fn(P, name, body, nargs=1, ret="array"):
    """A step named ``name`` with ``P``'s array annotations."""
    args = ["x", "k", "v"][:nargs]
    f = body
    f.__name__ = name
    f.__annotations__ = {a: P.Array for a in args}
    if ret == "array":
        f.__annotations__["return"] = P.Array
    elif ret is not None:
        f.__annotations__["return"] = ret
    return f


def steps(P):
    """The reference test's step functions, for package ``P``."""
    def branch(x):
        if x.sum() > 0:                       # data-dependent control flow
            return x
        return -x
    return types.SimpleNamespace(
        jid=_fn(P, "jid", lambda x: x * 2),
        jdot5=_fn(P, "jdot5", lambda x: x @ P.ones(5)),
        jbranch=_fn(P, "jbranch", branch),
        jreshape=_fn(P, "jreshape", lambda x: x.reshape(2, 2)),
        batched=_fn(P, "batched", lambda x: x + 1),
        grow=_fn(P, "grow", lambda x: P.cat(x)),
        pred_unannotated=_fn(P, "pred_unannotated", lambda x: x.sum() > 0,
                             ret=None),
        pred_bool=_fn(P, "pred_bool", lambda x: True, ret=bool))


def _nid(x: np.ndarray) -> np.ndarray:
    return x


def _nneg(x: np.ndarray) -> np.ndarray:
    return -x


def gpu_chain(P, step2="jid"):
    S = steps(P)
    fl = P.Flow([("x", P.Array)])
    fl.output = (fl.map(S.jid, names=["x"], gpu=True)
                 .map(getattr(S, step2), names=["x"], gpu=True))
    return fl


def fanout_flow(P):
    """source -> a -> {b, c} -> union: op 1's edge fans out."""
    fl = P.Flow([("x", np.ndarray)])
    a = fl.map(_nid, names=["x"])
    b = a.map(_nid, names=["x"])
    c = a.map(_nneg, names=["x"])
    fl.output = b.union(c)
    return fl


def big_row_flow(P):
    S = steps(P)
    fl = P.Flow([("x", P.Array)])
    fl.output = (fl.map(S.jid, names=["x"], gpu=True, batching=True)
                 .map(S.grow, names=["x"], gpu=True, batching=True))
    return fl


def batching_flow(P):
    S = steps(P)
    fl = P.Flow([("x", P.Array)])
    fl.output = (fl.map(S.jid, names=["x"], gpu=True, batching=True)
                 .map(S.batched, names=["x"], gpu=True, batching=True))
    return fl


def raw(P, fl):
    return P.Plan.from_dataflow(fl)


def compiled(P, fl, **kw):
    if P is T:
        kw["device"] = "cpu"
    return P.passes.build_pipeline(**kw).run(raw(P, fl),
                                             P.passes.PassContext())


def view(report):
    return sorted((d.code, -1 if d.op_id is None else d.op_id, d.severity)
                  for d in report.diagnostics)


def both(case):
    """Run ``case(P)`` (returning a report) in both packages and hold the
    port's (code, op id, severity) multiset to the reference's."""
    want, got = view(case(J)), view(case(T))
    assert got == want
    return got


# -- one case per code -------------------------------------------------------

def _specs(P, shape):
    return {"x": P.spec(shape)}


CASES = {
    "CF101": lambda P: P.an.analyze(raw(P, gpu_chain(P, "jdot5")),
                                    input_specs=_specs(P, (8,))),
    "CF102": lambda P: P.an.analyze(raw(P, gpu_chain(P, "jbranch")),
                                    input_specs=_specs(P, (8,))),
    "CF104": lambda P: P.an.analyze(raw(P, _filter_flow(
        P, "pred_unannotated"))),
    "CF104-clean": lambda P: P.an.analyze(raw(P, _filter_flow(
        P, "pred_bool"))),
    "CF201": lambda P: P.an.analyze(raw(P, fanout_flow(P)).with_ops([
        o.replace(donate=True) if o.op_id == 1 else o
        for o in raw(P, fanout_flow(P)).ops])),
    "CF202": lambda P: P.an.analyze(_cross_class(P)),
    "CF203-error": lambda P: P.an.analyze(_stamped(P, wait_any=True, at=2)),
    "CF203-warning": lambda P: P.an.analyze(_stamped(P, replicas=3, at=1)),
    "CF204": lambda P: _cf204(P, (1, 2)),
    "CF204-clean": lambda P: _cf204(P, (1, 4, 8)),
    "CF301": lambda P: P.an.analyze(
        compiled(P, big_row_flow(P), fusion=True),
        sample=P.Table([("x", P.Array)], [(P.zeros(1024),)]),
        budget_bytes=64 << 10),
    "CF301-clean": lambda P: P.an.analyze(
        compiled(P, big_row_flow(P), fusion=True),
        sample=P.Table([("x", P.Array)], [(P.zeros(1024),)]),
        budget_bytes=1 << 30),
    "bucket-walk": lambda P: P.an.analyze(
        compiled(P, _reshape_flow(P), fusion=True),
        input_specs=_specs(P, (4,))),
}


def _filter_flow(P, pred):
    S = steps(P)
    fl = P.Flow([("x", P.Array)])
    fl.output = (fl.map(S.jid, names=["x"], gpu=True)
                 .filter(getattr(S, pred), gpu=True))
    return fl


def _reshape_flow(P):
    S = steps(P)
    fl = P.Flow([("x", P.Array)])
    fl.output = (fl.map(S.jid, names=["x"], gpu=True, batching=True)
                 .map(S.jreshape, names=["x"], gpu=True, batching=True))
    return fl


def _stamped(P, *, at, **kw):
    plan = raw(P, gpu_chain(P))
    return plan.with_ops([o.replace(**kw) if o.op_id == at else o
                          for o in plan.ops])


def _cross_class(P):
    plan = compiled(P, gpu_chain(P), plan_config=StandInConfig())
    assert type(plan.op(1).op).__name__ == "BatchedJittedFuse"
    emits, donate = P.an.device_edge_info(plan)[1]
    assert emits and donate
    return plan.with_ops([o.replace(placement="cpu") if o.op_id == 2
                          else o for o in plan.ops])


def _cf204(P, buckets):
    cfg = StandInConfig(buckets={2: buckets}, max_batch={2: 8})
    plan = compiled(P, batching_flow(P), fusion=True, plan_config=cfg)
    return P.an.analyze(plan, plan_config=cfg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagnostics_match_reference(case):
    got = both(CASES[case])
    code = case.split("-")[0]
    if case.endswith("clean") or case == "bucket-walk":
        assert not [g for g in got if g[0] in (code, "CF101")]
    else:
        assert [g[0] for g in got].count(code) >= 1


def test_cf102_is_classified_not_conflated():
    rep = CASES["CF102"](T)
    assert len(rep.by_code("CF102")) == 1 and not rep.by_code("CF101")
    assert "not traceable" in rep.by_code("CF102")[0].message


def _flash_flow(P):
    fl = P.Flow([("q", P.Array), ("k", P.Array), ("v", P.Array)])
    fl.output = fl.map(P.kernel_step(), names=["o"], gpu=True)
    return fl


def test_cf103_fires_on_each_packages_kernel_rule():
    """Row-level q/k/v [2, 64, 12]: the reference's block_q=48 does not
    divide S=64; the port's CUDA kernels need head_dim % 8 == 0."""
    def case(P):
        s = P.spec((2, 64, 12))
        return P.an.analyze(raw(P, _flash_flow(P)),
                            input_specs={"q": s, "k": s, "v": s})
    assert both(case) == [("CF103", 1, "error")]
    msg = case(T).by_code("CF103")[0].message
    assert "head_dim a multiple of 8" in msg


def test_cf103_clean_and_skipped_without_shapes():
    def clean(P):
        s = P.spec((2, 64, 16))
        return P.an.analyze(raw(P, _flash_flow(P)),
                            input_specs={"q": s, "k": s, "v": s})
    rep = clean(T)
    assert rep.ok and rep.kernel_checks == [
        (1, "flash_attention", ((2, 64, 16),) * 3)]
    assert both(lambda P: P.an.analyze(raw(P, _flash_flow(P)))) == []


def test_cf103_placed_twin_is_inferred_through_its_plain_version():
    """After kernel placement the step is the CUDA twin; the walk takes
    the registry's plain version (no wrapper call, no launch)."""
    s = T.spec((2, 64, 12))
    plan = compiled(T, _flash_flow(T))
    assert plan.op(1).kernels
    before = kops.flash_attention.launches
    rep = tanalysis.analyze(plan, input_specs={"q": s, "k": s, "v": s})
    assert view(rep) == [("CF103", 1, "error")]
    assert kops.flash_attention.launches == before


@pytest.mark.parametrize("code,reserve", [("CF205", False),
                                          ("CF206", True)])
def test_cf205_cf206_match_reference(code, reserve):
    def case(P):
        rt = P.runtime(n_gpu=0)
        try:
            if reserve:
                rt.pool.add_executor("gpu", reserved=True)
            return P.an.analyze(raw(P, gpu_chain(P)), runtime=rt)
        finally:
            rt.stop()
    assert both(case) == [(code, 1, "error")]


def test_cf401_matches_reference():
    def inc(x: int) -> int:
        return x + 1

    def case(P):
        fl = P.Flow([("x", int)])
        fl.output = fl.map(inc, names=["x"])
        rt = P.runtime()
        try:
            rt.record_metric(P.K.dag("demo", "latency_s"), 0.01)
            rt.record_metric("bogus/unknown_series", 1.0)
            return P.an.analyze(raw(P, fl), runtime=rt)
        finally:
            rt.stop()
    assert both(case) == [("CF401", -1, "warning")]


class _StampDonateFanOut:
    """A deliberately broken pass: forces donation on fan-out edges."""
    name = "stamp-donate"

    def run(self, plan, ctx):
        fanout = {}
        for o in plan.ops:
            for i in o.inputs:
                fanout[i] = fanout.get(i, 0) + 1
        return plan.with_ops([o.replace(donate=True)
                              if fanout.get(o.op_id, 0) > 1 else o
                              for o in plan.ops])


def _rename_pass(P):
    renamed = _fn(P, "renamed", lambda x: x)

    class Rename:
        name = "rename"

        def run(self, plan, ctx):
            return plan.with_ops([
                o.replace(op=P.ops.Map(renamed, ["y"])) if o.op_id == 2
                else o for o in plan.ops])
    return Rename()


@pytest.mark.parametrize("code", ["CF501", "CF502"])
def test_pipeline_self_verification_matches_reference(code):
    def case(P):
        if code == "CF501":
            pp, fl = P.passes.PassPipeline([_StampDonateFanOut()],
                                           verify=True), fanout_flow(P)
        else:
            pp, fl = P.passes.PassPipeline([_rename_pass(P)],
                                           verify=True), gpu_chain(P)
        with pytest.raises(P.an.VerificationError) as ei:
            pp.run(raw(P, fl), P.passes.PassContext())
        return ei.value.report
    got = both(case)
    assert [g[0] for g in got] == [code]


def test_lookup_and_groupby_chains_do_not_crash_analysis():
    def key_of(x: int) -> tuple[int, str]:
        return x, f"k{x}"

    def use(x: int, key: str, lookup) -> int:
        return x

    def lookup_case(P):
        fl = P.Flow([("x", int)])
        fl.output = (fl.map(key_of, names=["x", "key"])
                     .lookup("key", column=True).map(use, names=["x"]))
        plan = compiled(P, fl, fusion=True, locality=True)
        return P.an.analyze(plan, sample=P.Table([("x", int)], [(1,)]))

    def groupby_case(P):
        tag = _fn(P, "tag", lambda x: (0, x))
        tag.__annotations__["return"] = tuple[int, P.Array]
        fl = P.Flow([("x", P.Array)])
        fl.output = fl.map(tag, names=["g", "x"]).groupby("g").agg(
            "sum", "x")
        return P.an.analyze(compiled(P, fl, fusion=True),
                            input_specs=_specs(P, (4,)))
    assert both(lookup_case) == []
    assert both(groupby_case) == []


def test_array_annotation_is_public():
    assert array_annotation(torch.Tensor)
    assert not array_annotation(np.ndarray)   # numpy steps stay eager
    assert not array_annotation(int)


# -- compile_flow(verify=...) rejects before anything runs ------------------

def test_compile_flow_rejects_donated_fanout_before_anything_runs():
    rt = Runtime(n_cpu=1, device="cpu")
    try:
        pipeline = tpasses.PassPipeline(
            tpasses.build_pipeline(fusion=True, device="cpu").passes
            + [_StampDonateFanOut()])
        t0 = EXECUTABLE_CACHE.traces()
        with pytest.raises(tanalysis.VerificationError) as ei:
            compile_flow(fanout_flow(T), rt, pipeline=pipeline,
                         verify="error", name="donated-fanout")
        assert ei.value.report.by_code("CF201")
        assert EXECUTABLE_CACHE.traces() == t0
        assert "donated-fanout" not in rt.dags
    finally:
        rt.stop()


def test_compile_flow_rejects_over_budget_and_warn_serves():
    rt = Runtime(n_cpu=1, n_gpu=1, net=NetModel(scale=0.0), device="cpu")
    try:
        sample = TTable([("x", torch.Tensor)], [(torch.zeros(1024),)])
        t0 = EXECUTABLE_CACHE.traces()
        with pytest.raises(tanalysis.VerificationError) as ei:
            compile_flow(big_row_flow(T), rt, fusion=True, verify=True,
                         verify_input=sample, verify_budget_bytes=64 << 10,
                         name="over-budget")
        assert ei.value.report.by_code("CF301")
        assert EXECUTABLE_CACHE.traces() == t0
        assert "over-budget" not in rt.dags
        small = TTable([("x", torch.Tensor)], [(torch.zeros(16),)])
        dep = compile_flow(gpu_chain(T), rt, fusion=True, verify="warn",
                           verify_input=small, name="warned")
        assert dep.verification is not None and dep.verification.ok
        assert dep.compile_flags["fusion"] is True
        out = dep.execute(small).result(30)
        np.testing.assert_allclose(np.asarray(out.rows[0].values[0]),
                                   np.zeros(16))
    finally:
        rt.stop()


def test_compile_flow_register_false_and_plan_config():
    class Cfg(StandInConfig):
        def apply_runtime(self, runtime, dag):
            self.applied = dag.name
    rt = Runtime(n_cpu=1, n_gpu=1, net=NetModel(scale=0.0), device="cpu")
    try:
        cfg = Cfg()
        dep = compile_flow(gpu_chain(T), rt, plan_config=cfg,
                           register=False, name="green")
        assert "green" not in rt.dags and not hasattr(cfg, "applied")
        dep = compile_flow(gpu_chain(T), rt, plan_config=cfg, name="blue")
        assert cfg.applied == "blue" and "blue" in rt.dags
        assert all(isinstance(o.op, BatchedJittedFuse)
                   for o in dep.plan.ops)       # bare gpu maps lowered
    finally:
        rt.stop()


def test_model_cascade_verify_allocates_nothing_and_launches_nothing():
    """The tiny f32 cascade with the kernels on: the walk meets both
    attention wrappers inside the model stages on fake tensors, CF103
    checks both, and no kernel counter moves."""
    import dataclasses
    from repro_torch.configs import get_tiny_config
    from repro_torch.examples import decode_cascade as tdc
    from repro_torch.models import build_model
    from repro_torch.models.registry import stage_input_specs
    cfg = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32",
                              use_kernels=True, head_dim=12)
    model = build_model(cfg, device="cpu")
    pre, dec = tdc.build_ops(model, model.init(
        torch.Generator().manual_seed(0)))
    specs = stage_input_specs(model, "prefill", seq_len=tdc.SEQ,
                              cache_len=tdc.CACHE)
    rt = Runtime(n_cpu=1, n_gpu=1, net=NetModel(scale=0.0), device="cpu")
    try:
        counts = {k: getattr(kops, k).launches for k in
                  ("flash_attention", "decode_attention")}
        with pytest.raises(tanalysis.VerificationError) as ei:
            tdc.build(rt, pre, dec, steps=2, verify=True,
                      verify_input=specs, name="bad-head-dim")
        rep = ei.value.report
        kernels = {k for _op, k, _s in rep.kernel_checks}
        assert kernels == {"flash_attention", "decode_attention"}
        assert {d.code for d in rep.errors()} == {"CF103"}
        assert len(rep.by_code("CF103")) == 2        # one rule each
        assert {k: getattr(kops, k).launches for k in counts} == counts
        assert "bad-head-dim" not in rt.dags
    finally:
        rt.stop()


# -- the CLI -----------------------------------------------------------------

def test_cli_list_codes_matches_reference(capsys):
    assert jcli.main(["--list-codes"]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["--list-codes"]) == 0
    assert capsys.readouterr().out == want


_BROKEN_MODULE = '''
import torch
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.table import Table

def _a(x: torch.Tensor) -> torch.Tensor:
    return x * 2

def _b(x: torch.Tensor) -> torch.Tensor:
    return x @ torch.ones((5, 5))

def check_flows():
    fl = Dataflow([("x", torch.Tensor)])
    fl.output = (fl.map(_a, names=["x"], gpu=True)
                 .map(_b, names=["x"], gpu=True))
    return [{"name": "broken", "flow": fl, "compile": {},
             "sample": Table([("x", torch.Tensor)], [(torch.zeros(8),)])}]
'''


def test_cli_exit_codes(tmp_path, capsys):
    mod = tmp_path / "broken_flow.py"
    mod.write_text(_BROKEN_MODULE)
    assert tcli.main([str(mod)]) == 1
    out = capsys.readouterr().out
    assert "CF101" in out and "1 error(s)" in out
    crashy = tmp_path / "crashy.py"
    crashy.write_text("raise RuntimeError('broken import')\n")
    assert tcli.main([str(crashy)]) == 1
    plain = tmp_path / "plain.py"
    plain.write_text("X = 1\n")
    capsys.readouterr()
    assert tcli.main([str(plain)]) == 0
    assert "checked 0 flow(s)" in capsys.readouterr().out


def test_cli_lints_the_port_examples_clean(capsys):
    assert tcli.main([]) == 0
    out = capsys.readouterr().out
    assert "checked 9 flow(s): 0 error(s)" in out
    for name in ("auto-optimize", "cascade", "decode-cascade",
                 "decode-cascade-competitive", "quickstart", "recommender",
                 "recommender-unopt", "serve-batched", "video"):
        assert f"{name}: clean" in out


def test_check_module_runs_as_a_program():
    import subprocess
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    res = subprocess.run([sys.executable, "-m", "repro_torch.check",
                          "--list-codes"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "CF502" in res.stdout
