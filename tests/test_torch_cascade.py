"""The port's main path on the CPU: the prefill -> decode cascade through
``Dataflow`` -> ``compile_flow`` -> ``Runtime``, held token for token to
the reference package's ``reference_decode`` (same params, same prompts,
f32 tiny yi-9b), plus the rules of the port: no JAX import, no silent
move to the CPU, and no fallback that swallows a kernel failure.
"""
import dataclasses
import os
import subprocess
import sys
from typing import Tuple  # noqa: F401  (string annotation below)

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.core.ir import PhysicalPlan  # noqa: E402
from repro_torch.core.lowering import (EXECUTABLE_CACHE,  # noqa: E402
                                       BatchedJittedFuse, JittedFuse)
from repro_torch.core.passes import build_pipeline  # noqa: E402
from repro_torch.core.table import DeviceTable, Table  # noqa: E402
from repro_torch.examples import decode_cascade as tdc  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.build import KernelError  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import NetModel, Runtime  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
PROMPTS, STEPS = 3, 4


class _Jitted:
    """The reference model's serving stages under ``jax.jit`` (the same
    math; one compile instead of one per primitive)."""

    def __init__(self, model):
        self.prefill = jax.jit(model.prefill, static_argnums=2)
        self.decode_step = jax.jit(model.decode_step)


@pytest.fixture(scope="module")
def setup():
    """Reference model + params (made by the JAX example's own
    ``build_model``) and the port's model on the CPU with the same params
    bridged over."""
    sys.path.insert(0, os.path.join(SRC, os.pardir))
    from examples import decode_cascade as jdc
    jcfg = dataclasses.replace(jdc.get_tiny_config("yi-9b"),
                               dtype="float32")
    jm = jdc.build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (PROMPTS, jdc.SEQ), dtype=np.int32)
    want = jdc.reference_decode(_Jitted(jm), jparams, jnp.asarray(toks),
                                steps=STEPS, cache_len=jdc.CACHE)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    rt = Runtime(n_cpu=1, n_gpu=1, net=NetModel(scale=0.0), device="cpu")
    yield {"jdc": jdc, "params": params, "toks": toks, "want": want,
           "rt": rt}
    rt.stop()


def _model(kernels=True):
    cfg = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32",
                              use_kernels=kernels)
    return build_model(cfg, device="cpu")


def _table(toks):
    return Table([("tokens", torch.Tensor)],
                 [(torch.from_numpy(toks[i]),) for i in range(len(toks))])


@pytest.mark.parametrize("kernels", [True, False])
def test_compiled_cascade_matches_reference_decode(setup, kernels):
    model = _model(kernels)
    pre, dec = tdc.build_ops(model, setup["params"], cache_len=tdc.CACHE)
    dep = tdc.build(setup["rt"], pre, dec, steps=STEPS,
                    name=f"cascade-{kernels}")
    out = dep.execute(_table(setup["toks"])).result(120)
    assert [int(r.values[0]) for r in out.rows] == setup["want"]
    # the whole cascade is ONE batched chain; this request was one
    # batched dispatch (3 rows -> bucket 4), no per-row work
    (op,) = dep.plan.ops
    chain = op.op
    assert isinstance(chain, BatchedJittedFuse) and op.device_resident
    assert len(chain.ops) == 1 + STEPS
    assert chain.batch_dispatches == 1 and chain.rows_batched == PROMPTS
    assert chain.row_dispatches == 0
    # the request is on the runtime's plain metric series
    series = setup["rt"].metrics_snapshot(f"dag/cascade-{kernels}/")
    assert len(series[f"dag/cascade-{kernels}/request_t"]) == 1
    assert len(series[f"dag/cascade-{kernels}/latency_s"]) == 1
    # the port's own oracle loop agrees
    assert tdc.reference_decode(model, setup["params"],
                                torch.from_numpy(setup["toks"]),
                                steps=STEPS) == setup["want"]


def test_reregistration_is_trace_free(setup):
    """Recompiling + re-registering the same ops shares chain signatures:
    zero new executable builds, a cache hit per repeat."""
    pre, dec = tdc.build_ops(_model(), setup["params"])
    table = _table(setup["toks"])
    tdc.build(setup["rt"], pre, dec, steps=STEPS, name="rr1").execute(
        table).result(120)
    before = EXECUTABLE_CACHE.stats()
    dep2 = tdc.build(setup["rt"], pre, dec, steps=STEPS, name="rr2")
    out = dep2.execute(table).result(120)
    after = EXECUTABLE_CACHE.stats()
    assert after["traces"] == before["traces"]
    assert after["hits"] == before["hits"] + 1
    assert [int(r.values[0]) for r in out.rows] == setup["want"]


def test_kernel_error_propagates_and_is_not_latched(setup, monkeypatch):
    """A kernel that fails to build or launch surfaces from call_dag; the
    chain does not latch the per-row or interpreted fallback."""
    pre, dec = tdc.build_ops(_model(kernels=True), setup["params"])
    dep = tdc.build(setup["rt"], pre, dec, steps=STEPS, name="kerr")
    chain = dep.plan.ops[0].op

    def broken(*a, **k):
        raise KernelError("decode_attention launch failed: injected")

    monkeypatch.setattr(kops, "decode_attention", broken)
    with pytest.raises(KernelError, match="injected"):
        dep.execute(_table(setup["toks"])).result(120)
    assert not chain._fallback and not chain._vmap_fallback
    monkeypatch.undo()
    out = dep.execute(_table(setup["toks"])).result(120)
    assert [int(r.values[0]) for r in out.rows] == setup["want"]
    assert chain.batch_dispatches == 1 and chain.row_dispatches == 0


# -- fallbacks for untraceable user functions still latch ---------------------

def _branchy(x: torch.Tensor) -> torch.Tensor:
    return x + 1 if float(x.sum()) > 0 else x - 1   # data-dependent


def _double(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def _flow(*fns):
    fl = Dataflow([("x", torch.Tensor)])
    node = fl.source
    for f in fns:
        node = node.map(f, names=["x"], gpu=True)
    fl.output = node
    return fl


def _lower(fl, batched=True):
    return build_pipeline(fusion=True, batched_lowering=batched,
                          device="cpu").run(PhysicalPlan.from_dataflow(fl))


def test_batched_falls_back_for_untraceable_fns():
    """Counterpart of ``test_batched_lowering.py``'s untraceable test:
    ``torch.func.vmap`` refuses data-dependent control flow, and the chain
    latches the per-row path instead of failing the request."""
    plan = _lower(_flow(_branchy, _double))
    op = plan.ops[0].op
    assert isinstance(op, BatchedJittedFuse)
    t = Table([("x", torch.Tensor)], [(torch.ones(4),), (-torch.ones(4),)])
    out = plan.execute_local(t)
    np.testing.assert_allclose(out.rows[0].values[0].numpy(), np.full(4, 4.))
    np.testing.assert_allclose(out.rows[1].values[0].numpy(), np.full(4, -4.))
    assert op._fallback or op._vmap_fallback


def _from_numpy_only(x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(x * 2)     # TypeError unless x is numpy


def test_jit_lowering_falls_back_for_untraceable_fns():
    """Counterpart of ``test_ir_passes.py``'s untraceable test: the
    per-row chain runs eagerly (data-dependent branches are fine), and a
    step that cannot take the composed path's tensors (annotations lied)
    latches the interpreted fallback instead of failing the request."""
    plan = _lower(_flow(_branchy, _double), batched=False)
    assert isinstance(plan.ops[0].op, JittedFuse)
    out = plan.execute_local(Table([("x", torch.Tensor)],
                                   [(torch.ones(4),)]))
    np.testing.assert_allclose(out.rows[0].values[0].numpy(), np.full(4, 4.))
    plan = _lower(_flow(_from_numpy_only, _double), batched=False)
    op = plan.ops[0].op
    out = plan.execute_local(Table([("x", torch.Tensor)],
                                   [(np.ones(4, np.float32),)]))
    assert op._fallback
    np.testing.assert_allclose(np.asarray(out.rows[0].values[0]),
                               np.full(4, 4.0))


def _numpy_only3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> "Tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    return tuple(torch.from_numpy(x) for x in (q, k, v))  # numpy only


def test_chain_with_placed_kernel_never_takes_interpreted_fallback():
    """The interpreted fallback would run the steps on the request's host
    values: a chain holding a placed kernel raises instead of moving the
    kernel's work off the chain's device."""
    step = kops.kernel_step("flash_attention", causal=True)
    fl = Dataflow([("q", torch.Tensor), ("k", torch.Tensor),
                   ("v", torch.Tensor)])
    fl.output = fl.map(_numpy_only3, names=["q", "k", "v"], gpu=True) \
        .map(step, names=["o"], gpu=True)
    plan = _lower(fl, batched=False)
    op = plan.ops[0].op
    assert op._holds_kernels
    assert op.ops[1].fn.__name__ == "kernel_flash_attention"
    q = np.ones((2, 4, 8), np.float32)
    t = Table([("q", torch.Tensor), ("k", torch.Tensor),
               ("v", torch.Tensor)], [(q, q[:1], q[:1])])
    with pytest.raises(TypeError):       # from_numpy(tensor) on the path
        plan.execute_local(t)
    assert not op._fallback


# -- rules of the port -----------------------------------------------------

def test_port_imports_no_jax_and_nothing_of_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "n = sum(1 for k in sys.modules if k.startswith('repro_torch.'))\n"
        "print(n, bad)\n"
        "print(' '.join(sorted(k for k in sys.modules\n"
        "                      if k.startswith('repro_torch.'))))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout
    assert int(res.stdout.split()[0]) >= 72      # every module imported
    walked = set(res.stdout.splitlines()[1].split())
    for mod in ("obs.keys", "obs.metrics", "obs.trace", "obs.attribution",
                "obs.export", "serving.retry", "serving.admission",
                "serving.faults", "serving.batcher", "runtime.executor",
                "runtime.runtime", "runtime.autoscaler",
                "analysis.diagnostics", "analysis.infer", "analysis.checks",
                "analysis.memory", "analysis.cli", "check",
                "check.__main__", "core.rewrites", "examples.recommender",
                "profiling.profiler", "profiling.estimator",
                "profiling.optimizer", "profiling.replan",
                "profiling.controller", "core.planner",
                "examples.auto_optimize"):
        assert f"repro_torch.{mod}" in walked, mod


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    cfg = get_tiny_config("yi-9b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Runtime(n_gpu=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from repro_torch.models.transformer import init_params
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceTable.from_columns([("x", torch.Tensor)], [[np.ones(2)]],
                                 [0], [None])
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.params_from_numpy({"w": np.ones(2)})
    # a lowered chain built without a device resolves it at first use
    plan = build_pipeline(fusion=True).run(PhysicalPlan.from_dataflow(
        _flow(_double, _double)))
    with pytest.raises(RuntimeError, match="CUDA"):
        plan.execute_local(Table([("x", torch.Tensor)],
                                 [(torch.ones(2),), (torch.ones(2),)]))
