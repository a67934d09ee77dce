"""The port's MoE family (arctic-480b, llama4-maverick-400b-a17b), held to
the reference package's model on the CPU.

Tiny configs at float32, the reference's own parameters bridged through
``interop.params_from_numpy`` (int8 expert weights stay int8; the router
and the scales stay f32), the same numpy inputs.  Checked:

* the MoE layer: the served ``moe_apply`` (sorted pairs, grouped
  products) and the plain ``moe_apply_reference`` against the
  reference's ``moe_apply_reference``, output at max abs <= 1e-5 and the
  aux loss at 1e-6; a zero router, where every expert ties and both
  packages take experts 0..k-1; ``expert_quant`` (int8 values equal,
  scales within 1e-7, outputs at 1e-5);
* ``block_layout`` (full and tiny configs, with ``long_context``), the
  param trees and ``input_specs``;
* prefill logits and every cache leaf, and decode steps, at max abs
  <= 1e-4 (both sides compute in f32; products sum in different orders);
* the compiled cascade's greedy tokens against the reference's
  ``reference_decode``, and the static verifier passing the tiny cascade
  with no error diagnostic (the served MoE reads nothing back to the
  host, so no CF102).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_tiny_config as jax_tiny  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_tiny_config  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.examples import decode_cascade as tdc  # noqa: E402
from repro_torch.models import build_model, moe, registry  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import stage_input_specs  # noqa: E402
from repro_torch.runtime import NetModel, Runtime  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
ARCHS = ("arctic-480b", "llama4-maverick-400b-a17b")
ATOL = 1e-4
MOE_ATOL = 1e-5
S, CACHE, STEPS, PROMPTS = 24, 40, 3, 3


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float64)


def _bridge(tree):
    return interop.params_from_numpy(jax.tree.map(np.asarray, tree),
                                     device="cpu")


def _moe_block(specs):
    return str(next(i for i, s in enumerate(specs) if s.is_moe))


class _Side:
    """One arch at f32 on both packages: the reference's params and their
    bridge, and the reference's entry points under ``jax.jit``."""

    def __init__(self, arch, **fields):
        self.jc = dataclasses.replace(jax_tiny(arch), dtype="float32",
                                      **fields)
        self.tc = dataclasses.replace(get_tiny_config(arch), dtype="float32",
                                      **fields)
        jm = jax_build(self.jc)
        self.jm, self.tm = jm, build_model(self.tc, device="cpu")
        self.jp = jm.init(jax.random.PRNGKey(0))
        self.tp = _bridge(self.jp)
        self.blk = _moe_block(jax_tf.block_layout(self.jc)[0])
        rng = np.random.default_rng(0)
        self.toks = rng.integers(0, self.tc.vocab_size, (2, S),
                                 dtype=np.int32)
        self.prefill = jax.jit(lambda p, b, n: jm.prefill(p, b, n),
                               static_argnums=2)
        self.decode_step = jax.jit(jm.decode_step)

    def layer(self, j=0):
        """The MoE params of layer ``j`` of the MoE block, both sides."""
        jl = jax.tree.map(lambda a: a[j], self.jp["blocks"][self.blk]["moe"])
        return jl, _bridge(jl)


@pytest.fixture(scope="module", params=ARCHS)
def side(request):
    return _Side(request.param)


def _hidden(cfg, T=2, L=8, seed=1):
    return (np.random.default_rng(seed).standard_normal(
        (T, L, cfg.d_model)) * 0.5).astype(np.float32)


def _spec_view(specs):
    return [dataclasses.astuple(s) for s in specs]


# -- the MoE layer ------------------------------------------------------------

@pytest.mark.parametrize("fn", ["moe_apply", "moe_apply_reference"])
def test_moe_layer_matches_reference(side, fn):
    jl, tl = side.layer()
    x = _hidden(side.tc)
    want, want_aux = jax_moe.moe_apply_reference(jnp.asarray(x), jl, side.jc)
    got, aux = getattr(moe, fn)(torch.from_numpy(x), tl, side.tc)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=MOE_ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)


def test_zero_router_ties_pick_the_lowest_experts(side):
    """Every probability ties: the reference's ``top_k`` takes experts
    0..k-1, and so must the port (``torch.topk`` leaves ties open)."""
    jl, tl = side.layer()
    jl = dict(jl, router=jnp.zeros_like(jl["router"]))
    tl = dict(tl, router=torch.zeros_like(tl["router"]))
    x = _hidden(side.tc)
    k = side.tc.num_experts_per_tok
    _, jtop, _ = jax_moe._router(jnp.asarray(x.reshape(-1, x.shape[-1])),
                                 jl["router"], k)
    _, ttop, _ = moe._router(torch.from_numpy(x.reshape(-1, x.shape[-1])),
                             tl["router"], k)
    want = np.broadcast_to(np.arange(k), ttop.shape)
    np.testing.assert_array_equal(np.asarray(jtop), want)
    np.testing.assert_array_equal(ttop.numpy(), want)
    jy, _ = jax_moe.moe_apply_reference(jnp.asarray(x), jl, side.jc)
    for fn in (moe.moe_apply, moe.moe_apply_reference):
        ty, _ = fn(torch.from_numpy(x), tl, side.tc)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=MOE_ATOL)


def test_expert_quant_matches_reference(side):
    jl, tl = side.layer()
    jq = jax_moe.quantize_expert_weights(
        jax.tree.map(lambda a: a[None], jl))
    tq = moe.quantize_expert_weights({k: v[None] for k, v in tl.items()})
    for name in ("w_gate", "w_up", "w_down"):
        assert tq[name]["q"].dtype == torch.int8
        np.testing.assert_array_equal(tq[name]["q"].numpy(),
                                      np.asarray(jq[name]["q"]))
        np.testing.assert_allclose(tq[name]["s"].numpy(),
                                   np.asarray(jq[name]["s"]), rtol=1e-7)
    # the same int8 weights on both sides: the layer agrees
    jq0 = jax.tree.map(lambda a: a[0], jq)
    tq0 = _bridge(jq0)
    assert tq0["w_up"]["q"].dtype == torch.int8
    assert tq0["router"].dtype == tq0["w_up"]["s"].dtype == torch.float32
    x = _hidden(side.tc)
    want, _ = jax_moe.moe_apply_reference(jnp.asarray(x), jq0, side.jc)
    for fn in (moe.moe_apply, moe.moe_apply_reference):
        got, _ = fn(torch.from_numpy(x), tq0, side.tc)
        np.testing.assert_allclose(_np(got), _np(want), atol=MOE_ATOL)


def test_moe_apply_drops_no_token_at_any_skew(side):
    """Every token routed to one expert (a router that prefers expert 1
    by far): the served path still gives every token its output, as the
    plain version does (no capacity, no drop)."""
    _, tl = side.layer()
    router = torch.zeros_like(tl["router"])
    router[:, 1] = 1.0
    tl = dict(tl, router=router)
    x = torch.from_numpy(np.abs(_hidden(side.tc)))
    got, _ = moe.moe_apply(x, tl, side.tc)
    want, _ = moe.moe_apply_reference(x, tl, side.tc)
    assert bool((got.abs().amax(-1) > 0).all())
    np.testing.assert_allclose(_np(got), _np(want), atol=MOE_ATOL)


# -- layout, params, specs ----------------------------------------------------

@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_layout_matches_reference(arch, long_context):
    for jcfg, tcfg in ((jax_config(arch), get_config(arch)),
                       (jax_tiny(arch), get_tiny_config(arch))):
        jspecs, jn = jax_tf.block_layout(jcfg, long_context=long_context)
        tspecs, tn = transformer.block_layout(tcfg,
                                              long_context=long_context)
        assert _spec_view(tspecs) == _spec_view(jspecs) and tn == jn
    want = {"arctic-480b": [(0, True, False, True)],
            "llama4-maverick-400b-a17b": [(0, False, False, False),
                                          (0, True, False, True)]}[arch]
    assert _spec_view(tspecs) == want


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch, quant):
    jc = dataclasses.replace(jax_tiny(arch), expert_quant=quant)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jax.eval_shape(lambda: jax_build(jc).init(
                            jax.random.PRNGKey(0))))
    tc = dataclasses.replace(get_tiny_config(arch), expert_quant=quant)
    tp = build_model(tc, device="cpu").init(torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).split(".")[-1]), tp)
    assert got == want


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    long_context = shape == "long_500k"
    jm = jax_build(jax_config(arch), long_context=long_context)
    tm = build_model(get_config(arch), device="cpu",
                     long_context=long_context)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jm.input_specs(JAX_SHAPES[shape]))
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).split(".")[-1]),
                       tm.input_specs(SHAPES[shape]))
    assert got == want


# -- the model ---------------------------------------------------------------

def test_prefill_logits_and_caches_match_reference(side):
    jl, jcache = side.prefill(side.jp, {"tokens": jnp.asarray(side.toks)},
                              CACHE)
    tl, tcache = side.tm.prefill(side.tp,
                                 {"tokens": torch.from_numpy(side.toks)},
                                 CACHE)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    jleaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tleaves = registry._flatten(tcache)
    assert [p[-1].key for p, _ in jleaves] == [p[-1] for p, _ in tleaves]
    for (path, ja), (_, ta) in zip(jleaves, tleaves):
        assert tuple(ta.shape) == ja.shape, path
        np.testing.assert_allclose(_np(ta), _np(ja), atol=ATOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("kernels", [False, True])
def test_decode_steps_match_reference(side, kernels):
    """Decode steps after the prefill, both packages fed the reference's
    greedy tokens; the port's kernel path runs the kernels' plain versions
    on the CPU."""
    tm = build_model(dataclasses.replace(side.tc, use_kernels=kernels),
                     device="cpu")
    jl, jcache = side.prefill(side.jp, {"tokens": jnp.asarray(side.toks)},
                              CACHE)
    _, tcache = tm.prefill(side.tp, {"tokens": torch.from_numpy(side.toks)},
                           CACHE)
    tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    for i in range(STEPS):
        pos = np.full((2,), S + i, np.int32)
        jl, jcache = side.decode_step(side.jp, tok[:, None],
                                      jnp.asarray(pos), jcache)
        tl, tcache = tm.decode_step(
            side.tp, torch.from_numpy(np.array(tok)[:, None]),
            torch.from_numpy(pos), tcache)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL,
                                   err_msg=f"step {i}")
        tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)


# -- the main path ------------------------------------------------------------

class _Jitted:
    def __init__(self, model):
        self.prefill = jax.jit(model.prefill, static_argnums=2)
        self.decode_step = jax.jit(model.decode_step)


@pytest.fixture(scope="module")
def runtime():
    rt = Runtime(n_cpu=1, n_gpu=1, net=NetModel(scale=0.0), device="cpu")
    yield rt
    rt.stop()


def test_cascade_matches_reference_decode(side, runtime):
    sys.path.insert(0, os.path.join(SRC, os.pardir))
    from examples import decode_cascade as jdc
    toks = np.random.default_rng(1).integers(
        0, side.tc.vocab_size, (PROMPTS, tdc.SEQ), dtype=np.int32)
    want = jdc.reference_decode(_Jitted(side.jm), side.jp, jnp.asarray(toks),
                                steps=tdc.STEPS, cache_len=tdc.CACHE)
    model = build_model(dataclasses.replace(side.tc, use_kernels=True),
                        device="cpu")
    pre, dec = tdc.build_ops(model, side.tp, name=side.tc.name)
    dep = tdc.build(runtime, pre, dec, name=f"moe-{side.tc.name}")
    out = dep.execute(Table([("tokens", torch.Tensor)],
                            [(torch.from_numpy(t),) for t in toks])
                      ).result(120)
    assert [int(r.values[0]) for r in out.rows] == want
    assert tdc.reference_decode(model, side.tp, torch.from_numpy(toks)) \
        == want


def test_verifier_passes_moe_cascade(side, runtime):
    model = build_model(dataclasses.replace(side.tc, use_kernels=True),
                        device="cpu")
    pre, dec = tdc.build_ops(model, side.tp, name=side.tc.name,
                             measure=False)
    specs = stage_input_specs(model, "prefill", seq_len=tdc.SEQ,
                              cache_len=tdc.CACHE)
    dep = tdc.build(runtime, pre, dec, verify=True, verify_input=specs,
                    name=f"moe-verify-{side.tc.name}")
    rep = dep.verification
    assert rep is not None and rep.ok and not rep.errors()
    assert not rep.by_code("CF102") and not rep.by_code("CF101")
    assert {k for _op, k, _s in rep.kernel_checks} == {"flash_attention",
                                                       "decode_attention"}
