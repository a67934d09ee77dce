"""Scopes inside a dispatch (``repro_torch.obs.trace.scope``), on the CPU:
the tiny f32 yi-9b cascade (prefill and 3 decode steps) served through
``Runtime``, on the per-row path (one request, no batching) and on the
batched path (two requests merged into one dispatch, routing forced to
the batched callable).

Each kept trace carries the dispatch's ``upload@`` span and one
``step@`` span a chain step beside its ``exec@`` span; under a CPU
``torch.profiler`` recording every thread the same names appear as
ranges nested in the executor's ``exec@`` range; with neither consumer
on, a scope enters no profiler range and allocates nothing."""
import copy
import dataclasses
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.core.lowering import forced_batched_routing  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.examples import decode_cascade as tdc  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import Tracer, attribute  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.runtime import NetModel, Runtime  # noqa: E402
from repro_torch.runtime import runtime as rt_mod  # noqa: E402

STEPS = 3
OPS = ["yi_9b_prefill"] + ["yi_9b_decode"] * STEPS
SCOPED = ("upload", "step")
#: (path, batching hint, requests)
PATHS = [("per_row", False, 1), ("batched", True, 2)]
#: bytes an upload moves on the CPU device: a per-row prompt is already
#: there; the batched path stacks the two prompts into a new table
UPLOADED = {"per_row": 0, "batched": 2 * tdc.SEQ * 4}


@pytest.fixture(scope="module")
def stages():
    cfg = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32",
                              use_kernels=True)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return tdc.build_ops(model, params, cache_len=tdc.CACHE,
                         measure=False)


def _serve(stages, batching, n, tracer):
    """Serve ``n`` one-prompt requests at once; returns (deployment's
    node name, chain, outputs).  A batch is cut only when full, so two
    requests under batching make one dispatch."""
    rt = Runtime(n_cpu=1, n_gpu=1, net=NetModel(scale=0.0), max_batch=n,
                 batch_wait_ms=10_000.0, tracer=tracer, device="cpu")
    try:
        dep = tdc.build(rt, *stages, steps=STEPS, batching=batching,
                        name=f"scope-{batching}")
        chain = dep.plan.ops[-1].op
        toks = torch.randint(0, 256, (n, tdc.SEQ), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1))
        with forced_batched_routing([chain]):
            futs = [dep.execute(Table([("tokens", torch.Tensor)],
                                      [(toks[i],)])) for i in range(n)]
            outs = [f.result(120) for f in futs]
        return dep.function_names[0], chain, outs
    finally:
        rt.stop()


def _kept(tracer, n):
    """The ``n`` kept traces; a trace finishes in the future's own
    callback, which may still run when ``result()`` returns."""
    deadline = time.perf_counter() + 10.0
    while len(tracer.kept()) < n and time.perf_counter() < deadline:
        time.sleep(0.01)
    traces = sorted(tracer.kept(), key=lambda t: t.trace_id)
    assert len(traces) == n
    return traces


@pytest.fixture
def no_range(monkeypatch):
    """Any profiler range entered fails the request."""
    def boom(*a, **k):
        raise AssertionError("a profiler range was entered")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)


@pytest.mark.parametrize("path,batching,n", PATHS,
                         ids=[p[0] for p in PATHS])
def test_scopes_ride_beside_exec(stages, no_range, path, batching, n):
    tracer = Tracer(sample_rate=1.0)
    node, chain, _ = _serve(stages, batching, n, tracer)
    traces = _kept(tracer, n)
    if batching:
        assert chain.batch_dispatches == 1 and chain.row_dispatches == 0
    else:
        assert chain.row_dispatches == 1
    shared = None
    for tr in traces:
        (ex,) = [s for s in tr.spans if s.name == f"exec@{node}"]
        scoped = [s for s in tr.spans if s.kind in SCOPED]
        assert [s.name for s in scoped] == [f"upload@{node}"] + [
            f"step@{node}"] * len(OPS)
        up, steps = scoped[0], scoped[1:]
        assert up.attrs == {"rows": n, "bytes": UPLOADED[path]}
        assert [s.attrs["op"] for s in steps] == OPS
        assert [s.attrs["index"] for s in steps] == list(range(len(OPS)))
        ends = [ex.t0] + [x for s in scoped for x in (s.t0, s.t1)] + [ex.t1]
        assert ends == sorted(ends)          # in order, inside exec@
        assert all(s.link is None for s in scoped)
        # the scope spans follow exec@ directly
        i = tr.spans.index(ex)
        assert tr.spans[i + 1:i + 1 + len(scoped)] == scoped
        if shared is not None:               # batch members share them
            assert all(a is b for a, b in zip(scoped, shared))
        shared = scoped


@pytest.mark.parametrize("path,batching,n", PATHS,
                         ids=[p[0] for p in PATHS])
def test_attribution_ignores_scope_kinds(stages, path, batching, n):
    tracer = Tracer(sample_rate=1.0)
    _serve(stages, batching, n, tracer)
    traces = _kept(tracer, n)
    bare = []
    for tr in traces:
        t = copy.copy(tr)
        t.spans = [s for s in tr.spans if s.kind not in SCOPED]
        assert len(t.spans) < len(tr.spans)
        bare.append(t)
    assert attribute(traces).to_dict() == attribute(bare).to_dict()


def _ranges(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(("exec@", "upload@", "step@"))]


def _profiled(stages, batching, n, tracer):
    from torch.profiler import ProfilerActivity, profile
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=cfg) as prof:
        node, chain, _ = _serve(stages, batching, n, tracer)
    return node, chain, _ranges(prof)


@pytest.mark.parametrize("path,batching,n", PATHS,
                         ids=[p[0] for p in PATHS])
def test_profiler_ranges_nest_in_exec(stages, path, batching, n):
    node, _, ranges = _profiled(stages, batching, n, Tracer(sample_rate=1.0))
    (ex,) = [r for r in ranges if r[0] == f"exec@{node}"]
    inner = sorted((r for r in ranges if r is not ex), key=lambda r: r[1])
    assert [r[0] for r in inner] == [f"upload@{node}"] + [
        f"step@{node}:{op}" for op in OPS]
    assert all(ex[1] <= r[1] <= r[2] <= ex[2] for r in inner)
    assert not any(r[0].startswith("cu") for r in ranges)


def test_profiler_ranges_without_recorder_name_the_chain(stages):
    """A disabled tracer opens no recorder: the executor's range still
    names the node, the chain's own ranges name the chain."""
    node, chain, ranges = _profiled(stages, False, 1, Tracer(enabled=False))
    assert sorted(r[0] for r in ranges) == sorted(
        [f"exec@{node}", f"upload@{chain.name}"]
        + [f"step@{chain.name}:{op}" for op in OPS])


@pytest.mark.parametrize("path,batching,n", PATHS,
                         ids=[p[0] for p in PATHS])
def test_scopes_off_allocate_nothing(stages, no_range, monkeypatch, path,
                                     batching, n):
    def boom(*a, **k):
        raise AssertionError("a span or a live scope was made")
    monkeypatch.setattr(obs_trace, "Span", boom)
    monkeypatch.setattr(obs_trace, "_Scope", boom)
    tracer = Tracer(enabled=False)
    _, chain, outs = _serve(stages, batching, n, tracer)
    assert len(outs) == n and tracer.kept() == []
    assert obs_trace.scope("step", "x", index=0) is obs_trace._NO_SCOPE
    assert not obs_trace.scope("upload", rows=1)


#: run in a fresh interpreter: the modules a profiler's start imports
#: after ``prepare_profiler``, one name a line
_PROFILER_IMPORTS = """
import sys
import torch
from repro_torch.obs import trace
assert "torch._inductor" not in sys.modules
trace.prepare_profiler()
before = set(sys.modules)
with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]):
    pass
print("\\n".join(sorted(set(sys.modules) - before)))
"""


def test_prepare_profiler_leaves_the_profiler_nothing_to_import():
    """After ``prepare_profiler`` a profiler's start imports none of
    torch's compiler or distributed packages (the import that stalled a
    profile started while serving)."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROFILER_IMPORTS],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    late = [m for m in out.stdout.split()
            if m.startswith(("torch._inductor", "torch._dynamo",
                             "torch.distributed"))]
    assert late == []


@pytest.mark.parametrize("device,own_tracer,calls",
                         [("cuda", True, 1), ("cuda", False, 0),
                          ("cpu", True, 0)],
                         ids=["card-tracer", "card-default", "cpu-tracer"])
def test_runtime_prepares_the_profiler_for_its_own_tracer_on_a_card(
        monkeypatch, device, own_tracer, calls):
    seen = []
    monkeypatch.setattr(rt_mod, "prepare_profiler",
                        lambda: seen.append(True))
    monkeypatch.setattr(rt_mod, "resolve_device",
                        lambda d: torch.device(device))
    rt = Runtime(n_cpu=1, net=NetModel(scale=0.0), device=device,
                 tracer=Tracer(sample_rate=1.0) if own_tracer else None)
    rt.stop()
    assert len(seen) == calls
