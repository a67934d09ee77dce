"""The port's recurrent families on the CPU: rwkv6 (``wkv6``) and
recurrentgemma (``rglru_scan``) held to the reference package.

* The kernels' plain versions (what the wrappers run for CPU tensors)
  against the Pallas kernels in interpret mode and the naive oracles, on
  the same numpy inputs (the shapes of ``tests/test_kernels.py``); the
  plain wkv6's final state against the reference model's ``wkv_scan``.
* Tiny rwkv6 and recurrentgemma at float32 with the reference's own
  parameters bridged over: logits, every prefill cache leaf in column
  (``c{i}``) order, and decode steps on the port's cache and on a cache
  the reference built, with the kernels off and on (on: Pallas interpret
  mode on the JAX side).  recurrentgemma's prompt is longer than its
  32-slot window, so its ring cache has wrapped.
* rwkv6 at its full 24 layers (width cut to 256): a last-bit change of
  the f32 weights grows with depth in the reference as in the port, past
  the 0.05 bar in bf16; the port's f32 logits stay within twice the
  reference's own gap under that change (the rule ``chip_smoke.py``
  holds the full-width kernel path to).
* Both cascades through ``compile_flow``: greedy tokens equal the
  unfused loop and the reference's.
* The kernel steps: ``wkv6`` with its bound ``u`` and ``rglru_scan``,
  placed by ``PlaceKernelsPass``, equal the unplaced flow; a failing
  kernel propagates out of the lowered chain and is never latched.

Tolerance: atol 1e-4 at f32 (both sides compute in f32 and sum in
different orders), unless a case says otherwise.
"""
import dataclasses
from typing import Tuple  # noqa: F401  (string annotations below)

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_tiny_config as jax_tiny  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.registry import (  # noqa: E402
    stage_input_specs as jax_specs)
from repro.models.rwkv6 import wkv_scan as jax_wkv_scan  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, get_tiny_config  # noqa: E402
from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.core.ir import PhysicalPlan  # noqa: E402
from repro_torch.core.lowering import BatchedJittedFuse  # noqa: E402
from repro_torch.core.passes import build_pipeline  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.examples import decode_cascade as tdc  # noqa: E402
from repro_torch.examples.depth_gap import nudge_f32  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.build import KernelError  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_plain  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_plain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import registry, rglru, rwkv6  # noqa: E402
from repro_torch.runtime import NetModel, Runtime  # noqa: E402

ATOL = 1e-4
ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b")
#: (prompt length, cache length) per arch: recurrentgemma's prompt is
#: longer than its sliding window (32) so the prefill ring has wrapped
SHAPES = {"rwkv6-1.6b": (12, 16), "recurrentgemma-2b": (40, 48)}
STEPS = 3

jref_wkv6 = jax.jit(jref.wkv6_ref)
jref_rglru = jax.jit(jref.rglru_scan_ref)
jax_wkv_scan_jit = jax.jit(jax_wkv_scan)


def _np(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _decay(shape, seed):
    """A per-step decay in (0.45, 0.95), as the reference's sweep draws."""
    return (1.0 / (1.0 + np.exp(-_np(shape, seed, 1.0))) * 0.5
            + 0.45).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _f(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


# -- the kernels' plain versions ---------------------------------------------

@pytest.mark.parametrize("B,T,H,hd,chunk", [
    (1, 64, 2, 32, 16), (2, 128, 2, 64, 64), (1, 96, 1, 32, 32)])
def test_wkv6_plain_matches_pallas_interpret_and_model_scan(B, T, H, hd,
                                                            chunk):
    r, k, v = (_np((B, T, H, hd), i) for i in range(3))
    w = _decay((B, T, H, hd), 3)
    u = _np((H, hd), 4)
    y, S = wkv6_plain(*map(_t, (r, k, v, w, u)), return_state=True)
    assert y.dtype == S.dtype == torch.float32
    assert tuple(S.shape) == (B, H, hd, hd)
    j = [jnp.asarray(a) for a in (r, k, v, w, u)]
    np.testing.assert_allclose(
        _f(y), _f(jops.wkv6(*j, chunk=chunk, interpret=True)), atol=ATOL)
    np.testing.assert_allclose(_f(y), _f(jref_wkv6(*j)), atol=ATOL)
    jy, jS = jax_wkv_scan_jit(*j, jnp.zeros((B, H, hd, hd), jnp.float32))
    np.testing.assert_allclose(_f(y), _f(jy), atol=ATOL)
    np.testing.assert_allclose(_f(S), _f(jS), atol=ATOL)
    # without return_state the wrapper returns y alone
    np.testing.assert_array_equal(
        _f(kops.wkv6(*map(_t, (r, k, v, w, u)))), _f(y))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,R,chunk,br", [
    (2, 128, 256, 64, 128), (1, 64, 512, 64, 512), (3, 96, 128, 32, 128)])
def test_rglru_plain_matches_pallas_interpret(B, T, R, chunk, br, with_h0):
    a = 1.0 / (1.0 + np.exp(-_np((B, T, R), 0, 1.0)))
    a = a.astype(np.float32)
    x = _np((B, T, R), 1)
    h0 = _np((B, R), 2) if with_h0 else None
    got = rglru_scan_plain(_t(a), _t(x), None if h0 is None else _t(h0))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, R)
    jh0 = None if h0 is None else jnp.asarray(h0)
    want = jops.rglru_scan(jnp.asarray(a), jnp.asarray(x), jh0, chunk=chunk,
                           block_r=br, interpret=True)
    np.testing.assert_allclose(_f(got), _f(want), atol=ATOL)
    np.testing.assert_allclose(
        _f(got), _f(jref_rglru(jnp.asarray(a), jnp.asarray(x), jh0)),
        atol=ATOL)


def test_cpu_wrappers_run_plain_and_launch_nothing():
    r = _t(_np((1, 5, 2, 8), 0))
    w0, g0 = kops.wkv6.launches, kops.rglru_scan.launches
    np.testing.assert_array_equal(
        _f(kops.wkv6(r, r, r, r, r[0, 0])),
        _f(wkv6_plain(r, r, r, r, r[0, 0])))
    a = _t(_np((2, 7, 3), 1))
    np.testing.assert_array_equal(_f(kops.rglru_scan(a, a, a[:, 0])),
                                  _f(rglru_scan_plain(a, a, a[:, 0])))
    assert (kops.wkv6.launches, kops.rglru_scan.launches) == (w0, g0)


# -- the models --------------------------------------------------------------

def _cfgs(arch, kernels, dtype="float32"):
    jc = dataclasses.replace(jax_tiny(arch), dtype=dtype, use_pallas=kernels)
    tc = dataclasses.replace(get_tiny_config(arch), dtype=dtype,
                             use_kernels=kernels)
    return jc, tc


class _Jitted:
    """The reference model's entry points under ``jax.jit`` (the same
    math; one compile instead of one per primitive)."""

    def __init__(self, model):
        self.logits = jax.jit(lambda p, t: model.logits(
            p, {"tokens": t}, remat=False)[0])
        self.prefill = jax.jit(lambda p, t, n: model.prefill(
            p, {"tokens": t}, n), static_argnums=2)
        self.decode_step = jax.jit(model.decode_step)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """One arch's reference params (f32 tiny), bridged to the port, and
    seeded prompts; reference models jitted with and without Pallas."""
    arch = request.param
    jc, _ = _cfgs(arch, False)
    jparams = jax_build(jc).init(jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    seq, cache_len = SHAPES[arch]
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, seq),
                                             dtype=np.int32)
    jms = {kern: _Jitted(jax_build(_cfgs(arch, kern)[0]))
           for kern in (False, True)}
    return {"arch": arch, "jparams": jparams, "tparams": tparams,
            "toks": toks, "cache_len": cache_len, "jms": jms}


def _leaves(tree):
    """Cache leaves in column (``c{i}``) order, as numpy."""
    return [_f(leaf) for _, leaf in registry._flatten(tree)]


def _assert_caches(got, want):
    jl = jax.tree_util.tree_leaves(want)
    tl = _leaves(got)
    assert len(tl) == len(jl)
    for i, (g, w) in enumerate(zip(tl, jl)):
        assert g.shape == w.shape, f"c{i}"
        np.testing.assert_allclose(g, _f(w), atol=ATOL, err_msg=f"c{i}")


@pytest.mark.parametrize("kernels", [False, True])
def test_logits_prefill_decode_match_reference(family, kernels):
    _, tc = _cfgs(family["arch"], kernels)
    jm, tm = family["jms"][kernels], build_model(tc, device="cpu")
    jp, tp, toks = family["jparams"], family["tparams"], family["toks"]
    cache_len = family["cache_len"]
    tt = torch.from_numpy(toks)
    np.testing.assert_allclose(_f(tm.logits(tp, {"tokens": tt})),
                               _f(jm.logits(jp, jnp.asarray(toks))),
                               atol=ATOL)
    jlg, jcache = jm.prefill(jp, jnp.asarray(toks), cache_len)
    tlg, tcache = tm.prefill(tp, {"tokens": tt}, cache_len)
    np.testing.assert_allclose(_f(tlg), _f(jlg), atol=ATOL)
    _assert_caches(tcache, jcache)
    before = _leaves(tcache)
    nxt = np.argmax(_f(jlg)[:, -1], -1).astype(np.int32)[:, None]
    pos = np.full((2,), toks.shape[1], np.int32)
    for _ in range(2):
        jd, jcache = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos),
                                    jcache)
        td, tcache2 = tm.decode_step(tp, torch.from_numpy(nxt),
                                     torch.from_numpy(pos), tcache)
        np.testing.assert_allclose(_f(td), _f(jd), atol=ATOL)
        _assert_caches(tcache2, jcache)
        if before is not None:     # the step left its input cache alone
            for b, a in zip(before, _leaves(tcache)):
                np.testing.assert_array_equal(a, b)
            before = None
        tcache = tcache2
        nxt = np.argmax(_f(jd)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1


def test_decode_step_on_reference_built_cache(family):
    """A cache the reference built drives the port's decode step."""
    _, tc = _cfgs(family["arch"], False)
    jm, tm = family["jms"][False], build_model(tc, device="cpu")
    jp, tp, toks = family["jparams"], family["tparams"], family["toks"]
    _, jcache = jm.prefill(jp, jnp.asarray(toks), family["cache_len"])
    tcache = interop.params_from_numpy(jax.tree.map(np.asarray, jcache),
                                       device="cpu")
    nxt = toks[:, :1].copy()
    pos = np.full((2,), toks.shape[1], np.int32)
    for _ in range(2):
        jd, jcache = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos),
                                    jcache)
        td, tcache = tm.decode_step(tp, torch.from_numpy(nxt),
                                    torch.from_numpy(pos), tcache)
        np.testing.assert_allclose(_f(td), _f(jd), atol=ATOL)
        nxt = np.argmax(_f(jd)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1
    _assert_caches(tcache, jcache)


def _negate_lam(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: -v if k == "lam" else _negate_lam(v) for k, v in tree.items()}


@pytest.mark.parametrize("kernels", [False, True])
def test_recurrentgemma_live_decay_matches_reference(kernels):
    """The reference's init puts a = sigmoid(-lam)^4 below 3e-8, so a*h
    vanishes against x and h_t = x_t: the tests above cannot see the
    recurrence.  With lam negated (a = sigmoid(lam)^4 in (0.949, 0.9995))
    logits, every prefill cache leaf and a decode step still match."""
    arch = "recurrentgemma-2b"
    jc, tc = _cfgs(arch, kernels)
    jp = _negate_lam(jax_build(jc).init(jax.random.PRNGKey(0)))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    # the decay at the gates' init (r = 1/2), as rglru._rglru_gates has it
    a = torch.exp(-rglru.C_SCALE * torch.nn.functional.softplus(
        tp["blocks"]["0"]["rec"]["lam"]) / 2)
    assert 0.9 < float(a.min()) and float(a.max()) < 1
    jm, tm = _Jitted(jax_build(jc)), build_model(tc, device="cpu")
    seq, cache_len = SHAPES[arch]
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, seq),
                                             dtype=np.int32)
    jlg, jcache = jm.prefill(jp, jnp.asarray(toks), cache_len)
    tlg, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                             cache_len)
    np.testing.assert_allclose(_f(tlg), _f(jlg), atol=ATOL)
    _assert_caches(tcache, jcache)
    nxt = np.argmax(_f(jlg)[:, -1], -1).astype(np.int32)[:, None]
    pos = np.full((2,), seq, np.int32)
    jd, jcache = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos),
                                jcache)
    td, tcache = tm.decode_step(tp, torch.from_numpy(nxt),
                                torch.from_numpy(pos), tcache)
    np.testing.assert_allclose(_f(td), _f(jd), atol=ATOL)
    _assert_caches(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_bridge_keep_reference_types(arch):
    """The port's own init has the reference's shapes and (mixed f32 /
    bf16) types, and the bridge keeps every leaf's type."""
    jc, tc = _cfgs(arch, False, dtype="bfloat16")
    jmodel = jax_build(jc)
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           jax.eval_shape(lambda: jmodel.init(
                               jax.random.PRNGKey(0))))
    mod = {"ssm": rwkv6, "hybrid": rglru}[tc.family]
    tp = mod.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    as_spec = lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1])
    assert jax.tree.map(as_spec, tp) == jshapes
    dtypes = {s[1] for s in jax.tree_util.tree_leaves(
        jshapes, is_leaf=lambda x: isinstance(x, tuple))}
    assert {"float32", "bfloat16"} <= dtypes        # mixed types
    bridged = interop.params_from_numpy(
        jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        device="cpu")
    assert jax.tree.map(as_spec, bridged) == jshapes


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_specs_and_cache_columns_match_reference(arch):
    """Column ``c{i}`` is the reference's cache leaf ``i`` (nested caches
    flatten with sorted keys at every level)."""
    jc, tc = _cfgs(arch, False)
    for stage in ("prefill", "decode"):
        want = jax_specs(jax_build(jc), stage, seq_len=16, cache_len=48)
        got = registry.stage_input_specs(build_model(tc, device="cpu"),
                                         stage, seq_len=16, cache_len=48)
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def test_full_configs_keep_published_shapes():
    rw, rg = get_config("rwkv6-1.6b"), get_config("recurrentgemma-2b")
    assert (rw.num_layers, rw.d_model, rw.num_rwkv_heads, rw.d_ff) == \
        (24, 2048, 32, 7168)
    pattern, n_blocks, rest = rglru.layout(rg)
    assert (pattern, n_blocks, rest) == (["rec", "rec", "attn"], 8,
                                         ["rec", "rec"])
    assert rglru.layer_types(rg).count("rec") == 18


# -- rwkv6 at full depth -----------------------------------------------------

#: rwkv6-1.6b's 24 layers and head_dim 64 at width 256, so the reference
#: runs on the CPU; 2 prompts of 32 tokens
DEEP = {"d_model": 256, "d_ff": 896, "vocab_size": 512}
DEPTHS = (1, 24)


def _deep_gaps(dtype):
    """Per depth, the logits rel err of: the reference against itself
    with every f32 weight scaled by 1 + 2^-20, the port likewise, and the
    port against the reference (same params, bridged)."""
    def rel(got, want):
        got, want = _f(got).astype(np.float64), _f(want).astype(np.float64)
        return float(np.abs(got - want).max() / np.abs(want).max())

    toks = np.random.default_rng(1).integers(0, DEEP["vocab_size"], (2, 32),
                                             dtype=np.int32)
    tt = torch.from_numpy(toks)
    gaps = {}
    for depth in DEPTHS:
        jc = dataclasses.replace(jax_config("rwkv6-1.6b"), num_layers=depth,
                                 dtype=dtype, **DEEP)
        tc = dataclasses.replace(get_config("rwkv6-1.6b"), num_layers=depth,
                                 dtype=dtype, **DEEP)
        jm, tm = _Jitted(jax_build(jc)), build_model(tc, device="cpu")
        jp = jax_build(jc).init(jax.random.PRNGKey(0))
        jp_nudged = jax.tree.map(
            lambda x: x * (1 + 2**-20) if x.dtype == jnp.float32 else x, jp)
        tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")
        want = jm.logits(jp, jnp.asarray(toks))
        got = tm.logits(tp, {"tokens": tt})
        gaps[depth] = {
            "reference": rel(jm.logits(jp_nudged, jnp.asarray(toks)), want),
            "port": rel(tm.logits(nudge_f32(tp), {"tokens": tt}), got),
            "port vs reference": rel(got, want)}
        print(f"rwkv6 width 256 {dtype} {depth} layers: {gaps[depth]}")
    return gaps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_depth_amplifies_a_last_bit_change(dtype):
    """Random-weight rwkv6 amplifies a 2^-20 change of its f32 weights
    layer by layer, in the reference as in the port: in f32 by more than
    100x from 1 layer to 24, in bf16 (where the change flips roundings)
    past the 0.05 bar that two correct runs meet at 1 layer.  At 24 f32
    layers the port stays within twice the reference's own gap."""
    gaps = _deep_gaps(dtype)
    for side in ("reference", "port"):
        shallow, deep = gaps[DEPTHS[0]][side], gaps[DEPTHS[-1]][side]
        if dtype == "float32":
            assert 0 < 100 * shallow < deep, (side, gaps)
        else:
            assert shallow < 0.05 < deep, (side, gaps)
    if dtype == "float32":
        full = gaps[DEPTHS[-1]]
        assert full["port vs reference"] <= 2 * full["reference"], gaps


# -- the cascades through compile_flow -------------------------------------

@pytest.fixture(scope="module")
def rt():
    r = Runtime(n_cpu=1, n_gpu=1, net=NetModel(scale=0.0), device="cpu")
    yield r
    r.stop()


def _table(toks):
    return Table([("tokens", torch.Tensor)],
                 [(torch.from_numpy(toks[i]),) for i in range(len(toks))])


def _jax_reference_decode(jm, jp, toks, cache_len, steps):
    lg, cache = jm.prefill(jp, jnp.asarray(toks), cache_len)
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
    pos = jnp.full((toks.shape[0],), toks.shape[1], jnp.int32)
    for _ in range(steps):
        lg, cache = jm.decode_step(jp, tok[:, None], pos, cache)
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
        pos = pos + 1
    return [int(t) for t in tok]


def test_compiled_cascade_matches_unfused_loop(family, rt):
    arch, cache_len = family["arch"], family["cache_len"]
    _, tc = _cfgs(arch, True)
    model = build_model(tc, device="cpu")
    pre, dec = tdc.build_ops(model, family["tparams"], cache_len=cache_len,
                             name=arch)
    dep = tdc.build(rt, pre, dec, steps=STEPS, name=f"cascade-{arch}")
    out = dep.execute(_table(family["toks"])).result(120)
    got = [int(r.values[0]) for r in out.rows]
    (op,) = dep.plan.ops
    assert isinstance(op.op, BatchedJittedFuse) and op.device_resident
    assert op.op.batch_dispatches == 1 and op.op.row_dispatches == 0
    assert got == tdc.reference_decode(
        model, family["tparams"], torch.from_numpy(family["toks"]),
        steps=STEPS, cache_len=cache_len)
    assert got == _jax_reference_decode(family["jms"][True],
                                        family["jparams"], family["toks"],
                                        cache_len, STEPS)


@pytest.mark.parametrize("kernel,arch", [("wkv6", "rwkv6-1.6b"),
                                         ("rglru_scan", "recurrentgemma-2b")])
def test_kernel_error_propagates_and_is_not_latched(kernel, arch, rt,
                                                    monkeypatch):
    """A recurrent kernel that fails to build or launch surfaces from
    call_dag; the chain does not latch the per-row or interpreted
    fallback (the decode_attention case is in test_torch_cascade.py)."""
    _, tc = _cfgs(arch, True)
    model = build_model(tc, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(2).integers(0, tc.vocab_size, (2, 6),
                                             dtype=np.int32)
    pre, dec = tdc.build_ops(model, params, cache_len=16, name=arch)
    dep = tdc.build(rt, pre, dec, steps=2, name=f"kerr-{kernel}")
    chain = dep.plan.ops[0].op

    def broken(*a, **k):
        raise KernelError(f"{kernel} launch failed: injected")

    monkeypatch.setattr(kops, kernel, broken)
    with pytest.raises(KernelError, match="injected"):
        dep.execute(_table(toks)).result(120)
    assert not chain._fallback and not chain._vmap_fallback
    monkeypatch.undo()
    out = dep.execute(_table(toks)).result(120)
    assert [int(r.values[0]) for r in out.rows] == tdc.reference_decode(
        model, params, torch.from_numpy(toks), steps=2, cache_len=16)
    assert chain.batch_dispatches == 1 and chain.row_dispatches == 0


# -- the kernel steps, placed and not ----------------------------------------

T, H, HD, R = 8, 2, 8, 8
_WKV_U = torch.from_numpy(_np((H, HD), 9))   # one object: bound identity


def _gate4(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor
           ) -> "Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]":  # noqa: E501
    return r * 0.5, k, v, w


def _gate2(a: torch.Tensor, x: torch.Tensor
           ) -> "Tuple[torch.Tensor, torch.Tensor]":
    return a, x * 0.5


def _flow_and_rows(kernel, n):
    if kernel == "wkv6":
        step = kops.kernel_step("wkv6", bound={"u": _WKV_U})
        cols, gate = ["r", "k", "v", "w"], _gate4
        data = [_np((n, T, H, HD), i) for i in range(3)] + \
            [_decay((n, T, H, HD), 3)]
    else:
        step = kops.kernel_step("rglru_scan")
        cols, gate = ["a", "x"], _gate2
        data = [_decay((n, T, R), 0), _np((n, T, R), 1)]
    fl = Dataflow([(c, torch.Tensor) for c in cols])
    fl.output = fl.map(gate, names=cols, gpu=True).map(step, names=["o"],
                                                       gpu=True)
    rows = Table([(c, torch.Tensor) for c in cols],
                 [tuple(_t(d[i]) for d in data) for i in range(n)])
    return fl, rows


@pytest.mark.parametrize("kernel", ["wkv6", "rglru_scan"])
def test_placed_kernel_step_matches_unplaced_flow(kernel):
    fl, rows = _flow_and_rows(kernel, 3)
    outs = {}
    for place in (True, False):
        plan = build_pipeline(fusion=True, place_kernels=place,
                              device="cpu").run(
            PhysicalPlan.from_dataflow(fl))
        chain = plan.ops[0].op
        names = [s.fn.__name__ for s in chain.ops]
        assert (f"kernel_{kernel}" in names) == place
        outs[place] = [_f(r.values[0]) for r in plan.execute_local(rows).rows]
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    # and the unplaced step is the oracle on the gated rows
    first = rows.rows[0].values
    gated = [first[0] * 0.5, *first[1:]] if kernel == "wkv6" else \
        [first[0], first[1] * 0.5]
    batch1 = [jnp.asarray(_f(c)[None]) for c in gated]
    want = (jref_wkv6(*batch1, jnp.asarray(_f(_WKV_U))) if kernel == "wkv6"
            else jref_rglru(*batch1))[0]
    np.testing.assert_allclose(outs[False][0], _f(want), atol=ATOL)
