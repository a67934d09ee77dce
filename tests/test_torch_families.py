"""The port's gemma2 and vlm transformer and the int8 KV cache, held to the
reference package's model on the CPU.

Tiny configs at float32, the reference's own parameters bridged through
``interop.params_from_numpy``, the same numpy prompts (and, for the vlm,
the same numpy media).  Checked at max abs <= 1e-4 (both sides compute in
f32; matmuls and softmaxes sum in different orders) unless stated:

* block layouts (with ``long_context``), param trees and ``input_specs``;
* prefill logits and every cache leaf;
* a decode step after prefills of S in {48, 64, 80, 128} tokens, against
  the full forward's logits at position S.  gemma2's local window is 64:
  at S = 80 the prefill's ring layout (positions 16..79 at slots 0..63)
  and the decode step's slot ``80 % 64 = 16`` disagree, so the step
  overwrites position 32, still inside the window.  Both packages then
  stand off the full forward by the same amount: the reference's ring
  defect, which the port keeps for parity (ROADMAP.md §3) and which is
  pinned here;
* gemma2's kernel path (the kernels' plain versions) against the
  reference's ``use_pallas=True`` run in Pallas interpret mode;
* the vlm with its cross gates opened (the reference initialises them to
  0, so ``tanh(0)`` would hide the media), media given, and the ``ck``/
  ``cv`` cache leaves;
* ``kv_quant``: int8 values equal and scales within 1e-7 on the same
  inputs, the cache leaves in ``tree_flatten`` order, and greedy decode
  tokens equal on tiny yi and gemma2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_tiny_config as jax_tiny  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_tiny_config  # noqa: E402
from repro_torch.models import build_model, layers, registry  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ATOL = 1e-4
ARCHS = ("gemma2-9b", "llama-3.2-vision-11b")
SEQS = (48, 64, 80, 128)
CACHE = 144
#: the cross gates' value for the checks with media
GATE = 0.5
#: decode logits over an int8 ring: each step quantizes a key that the
#: two packages computed a last bit apart, and a rounding tie moves one
#: value by a whole step (about max|k| / 127), so a logit moves by up to
#: about 1e-3 where f32 logits agree to 1e-4
KV_QUANT_ATOL = 1e-3


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float64)


def _open_gates(jparams):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.full_like(a, GATE) if p[-1].key == "gate" else a,
        jparams)


class _Side:
    """One arch at f32 on both packages: the reference's params (gates
    opened), their bridge, prompts of ``max(SEQS) + 1`` tokens, media,
    and the reference's entry points under ``jax.jit``."""

    def __init__(self, arch, **fields):
        self.jc = dataclasses.replace(jax_tiny(arch), dtype="float32",
                                      **fields)
        self.tc = dataclasses.replace(get_tiny_config(arch), dtype="float32",
                                      **fields)
        jm = jax_build(self.jc)
        self.jm, self.tm = jm, build_model(self.tc, device="cpu")
        jp = jm.init(jax.random.PRNGKey(0))
        self.jp = _open_gates(jp) if self.jc.family == "vlm" else jp
        self.tp = interop.params_from_numpy(
            jax.tree.map(np.asarray, self.jp), device="cpu")
        rng = np.random.default_rng(0)
        self.toks = rng.integers(0, self.tc.vocab_size,
                                 (2, max(SEQS) + 1), dtype=np.int32)
        self.media = None
        if self.tc.family == "vlm":
            self.media = (0.1 * rng.standard_normal(
                (2, self.tc.num_media_tokens, self.tc.d_model))
            ).astype(np.float32)
        self.logits = jax.jit(lambda p, b: jm.logits(p, b, remat=False)[0])
        self.prefill = jax.jit(lambda p, b, n: jm.prefill(p, b, n),
                               static_argnums=2)
        self.decode_step = jax.jit(jm.decode_step)

    def batches(self, S):
        jb = {"tokens": jnp.asarray(self.toks[:, :S])}
        tb = {"tokens": torch.from_numpy(self.toks[:, :S].copy())}
        if self.media is not None:
            jb["media"] = jnp.asarray(self.media)
            tb["media"] = torch.from_numpy(self.media)
        return jb, tb


@pytest.fixture(scope="module", params=ARCHS)
def side(request):
    return _Side(request.param)


@pytest.fixture(scope="module")
def full_logits(side):
    """Both packages' full-forward logits over all the prompt's tokens."""
    jb, tb = side.batches(side.toks.shape[1])
    jl = side.logits(side.jp, jb)
    tl = side.tm.logits(side.tp, tb)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    return _np(jl), _np(tl)


def _spec_view(specs):
    return [(s.window, s.has_cross) for s in specs]


@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_layout_matches_reference(arch, long_context):
    for jcfg, tcfg in ((jax_config(arch), get_config(arch)),
                       (jax_tiny(arch), get_tiny_config(arch))):
        jspecs, jn = jax_tf.block_layout(jcfg, long_context=long_context)
        tspecs, tn = transformer.block_layout(tcfg,
                                              long_context=long_context)
        assert _spec_view(tspecs) == _spec_view(jspecs) and tn == jn
    if arch == "gemma2-9b":        # [local, global]; windowed globals
        want = get_tiny_config(arch).sliding_window if long_context else 0
        assert _spec_view(tspecs) == [(64, False), (want, False)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    jc = jax_tiny(arch)            # bf16, the config's own dtype
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jax.eval_shape(lambda: jax_build(jc).init(
                            jax.random.PRNGKey(0))))
    tp = build_model(get_tiny_config(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).split(".")[-1]), tp)
    assert got == want
    if arch != "gemma2-9b":
        gate = tp["blocks"]["1"]["cross"]["gate"]
        assert gate.dtype == torch.float32 and not gate.any()


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    long_context = shape == "long_500k"
    jm = jax_build(jax_config(arch), long_context=long_context)
    tm = build_model(get_config(arch), device="cpu",
                     long_context=long_context)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jm.input_specs(JAX_SHAPES[shape]))
    specs = tm.input_specs(SHAPES[shape])
    assert all(t.device.type == "meta"
               for t in jax.tree.leaves(specs))
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).split(".")[-1]), specs)
    assert got == want


def test_prefill_logits_and_caches_match_reference(side):
    S = 80
    jb, tb = side.batches(S)
    jl, jcache = side.prefill(side.jp, jb, CACHE)
    tl, tcache = side.tm.prefill(side.tp, tb, CACHE)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    jleaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tleaves = registry._flatten(tcache)
    assert [p[-1].key for p, _ in jleaves] == [p[-1] for p, _ in tleaves]
    if side.tc.family == "vlm":
        assert {"ck1", "cv1"} <= set(tcache)
    for (path, ja), (_, ta) in zip(jleaves, tleaves):
        assert tuple(ta.shape) == ja.shape, path
        assert str(ta.dtype).split(".")[-1] == str(ja.dtype), path
        if ja.dtype == jnp.int32:
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        else:
            np.testing.assert_allclose(_np(ta), _np(ja), atol=ATOL,
                                       err_msg=str(path))


@pytest.mark.parametrize("S", SEQS)
def test_decode_step_matches_reference_and_pins_ring_defect(side,
                                                           full_logits, S):
    jb, tb = side.batches(S)
    _, jcache = side.prefill(side.jp, jb, CACHE)
    _, tcache = side.tm.prefill(side.tp, tb, CACHE)
    nxt = side.toks[:, S:S + 1]
    pos = np.full((2,), S, np.int32)
    jd, _ = side.decode_step(side.jp, jnp.asarray(nxt), jnp.asarray(pos),
                             jcache)
    td, _ = side.tm.decode_step(side.tp, torch.from_numpy(nxt.copy()),
                                torch.from_numpy(pos), tcache)
    np.testing.assert_allclose(_np(td), _np(jd), atol=ATOL)
    jfull, tfull = full_logits
    gap_ref = float(np.abs(_np(jd)[:, 0] - jfull[:, S]).max())
    gap_port = float(np.abs(_np(td)[:, 0] - tfull[:, S]).max())
    W = side.tc.sliding_window if side.tc.local_global_pattern else 0
    if W and S > W and S % W:
        # the ring defect: both packages off the full forward, alike
        assert gap_ref > 1e-2 and gap_port > 1e-2
        assert abs(gap_port - gap_ref) <= ATOL
    else:
        assert gap_ref <= ATOL and gap_port <= ATOL


def test_gemma2_kernel_path_matches_reference_interpret():
    """``use_kernels=True`` (the kernels' plain versions on the CPU)
    against the reference's ``use_pallas=True`` (Pallas interpret mode):
    prefill logits and caches at 80 tokens past the 64-token window, and
    a decode step on that ring."""
    kern = _Side("gemma2-9b", **{})
    jc = dataclasses.replace(kern.jc, use_pallas=True)
    tc = dataclasses.replace(kern.tc, use_kernels=True)
    jm, tm = jax_build(jc), build_model(tc, device="cpu")
    S = 80
    jb, tb = kern.batches(S)
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, CACHE))(kern.jp, jb)
    tl, tcache = tm.prefill(kern.tp, tb, CACHE)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    for key, ja in jcache.items():
        np.testing.assert_allclose(_np(tcache[key]), _np(ja), atol=ATOL,
                                   err_msg=key)
    nxt, pos = kern.toks[:, S:S + 1], np.full((2,), S, np.int32)
    jd, _ = jax.jit(jm.decode_step)(kern.jp, jnp.asarray(nxt),
                                    jnp.asarray(pos), jcache)
    td, _ = tm.decode_step(kern.tp, torch.from_numpy(nxt.copy()),
                           torch.from_numpy(pos), tcache)
    np.testing.assert_allclose(_np(td), _np(jd), atol=ATOL)


def test_vlm_media_moves_logits_only_through_open_gates():
    vlm = _Side("llama-3.2-vision-11b")
    jb, tb = vlm.batches(24)
    text_j = {"tokens": jb["tokens"]}
    text_t = {"tokens": tb["tokens"]}
    # gates opened: the media change the logits, in both packages alike
    moved_j = _np(vlm.logits(vlm.jp, jb)) - _np(vlm.logits(vlm.jp, text_j))
    moved_t = _np(vlm.tm.logits(vlm.tp, tb)) - _np(vlm.tm.logits(vlm.tp,
                                                                  text_t))
    assert np.abs(moved_t).max() > 1e-3
    np.testing.assert_allclose(moved_t, moved_j, atol=ATOL)
    # the reference's init (gates at 0): tanh(0) = 0, the media change
    # nothing
    closed = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 0 if p[-1].key == "gate" else a, vlm.tp)
    np.testing.assert_array_equal(
        _np(vlm.tm.logits(closed, tb)), _np(vlm.tm.logits(closed, text_t)))


# -- the int8 KV cache ------------------------------------------------------

def test_kv_quantize_matches_reference():
    x = np.random.default_rng(1).standard_normal((3, 7, 2, 32)) * 2.0
    x[0, 0, 0, :4] = [254.0, 1.0, 3.0, -5.0]   # x / scale = 127, .5, 1.5,
    x[0, 0, 0, 4:] = 0.0                       # -2.5: ties to even
    x = x.astype(np.float32)
    jq, js = jax_layers.kv_quantize(jnp.asarray(x))
    tq, ts = layers.kv_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tq[0, 0, 0, :4].numpy(), [127, 0, 2, -2])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-7)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_allclose(
            _np(layers.kv_dequantize(tq, ts, tdt)),
            _np(np.asarray(jax_layers.kv_dequantize(jq, js, jdt),
                           np.float32)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-9b"])
def test_kv_quant_cache_leaves_in_tree_flatten_order(arch):
    jc = dataclasses.replace(jax_tiny(arch), kv_quant=True)
    tc = dataclasses.replace(get_tiny_config(arch), kv_quant=True)
    jcache = jax_tf.init_cache(jc, None, 2, 16)
    tm = build_model(tc, device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    paths, axes, meta = registry._cache_layout(tm, 16)
    assert [p[-1] for p in paths] == [p[-1].key for p, _ in jleaves]
    assert axes == [1] * len(paths)
    tcache = tm.init_cache(2, 16)
    for (path, ja), (_, ta) in zip(jleaves, registry._flatten(tcache)):
        assert str(ta.dtype).split(".")[-1] == str(ja.dtype), path
        np.testing.assert_array_equal(_np(ta), _np(np.asarray(ja)))
    assert {f"ks{i}" for i in range(len(transformer.block_layout(tc)[0]))} \
        <= set(tcache)


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-9b"])
def test_kv_quant_prefill_and_decode_tokens_match_reference(arch):
    """Prefill caches: the int8 values of both packages' rings, quantized
    from keys that differ in the last bits, are equal but for a rare
    rounding tie (never more than one step), their scales within 1e-7;
    then greedy decode tokens past the window are equal, and the decode
    logits agree within ``KV_QUANT_ATOL``."""
    q = _Side(arch, kv_quant=True)
    S, steps = 80, 6
    jb, tb = q.batches(S)
    jl, jcache = q.prefill(q.jp, jb, 96)
    tl, tcache = q.tm.prefill(q.tp, tb, 96)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    for key, ja in jcache.items():
        ta = tcache[key]
        assert str(ta.dtype).split(".")[-1] == str(ja.dtype), key
        if ja.dtype == jnp.int8:
            diff = np.abs(_np(ta) - _np(np.asarray(ja)))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, key
        elif ja.dtype == jnp.float32:
            np.testing.assert_allclose(_np(ta), _np(ja), rtol=0,
                                       atol=1e-7, err_msg=key)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], -1).to(torch.int32)
    got, want = [], []
    for i in range(steps):
        pos = np.full((2,), S + i, np.int32)
        jd, jcache = q.decode_step(q.jp, jtok[:, None], jnp.asarray(pos),
                                   jcache)
        td, tcache = q.tm.decode_step(q.tp, ttok[:, None],
                                      torch.from_numpy(pos), tcache)
        np.testing.assert_allclose(_np(td), _np(jd), atol=KV_QUANT_ATOL)
        jtok = jnp.argmax(jd[:, -1], -1).astype(jnp.int32)
        ttok = torch.argmax(td[:, -1], -1).to(torch.int32)
        want.append(np.asarray(jtok).tolist())
        got.append(ttok.tolist())
    assert got == want
