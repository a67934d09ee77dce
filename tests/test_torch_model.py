"""The port's dense transformer held to the reference package's model on
the CPU: tiny yi-9b at float32, the reference's own parameters bridged
through ``interop.params_from_numpy``, the same numpy prompts.

Checked at max abs <= 1e-4 (both sides compute in f32; matmuls and
softmaxes sum in different orders): full-sequence logits, prefill, a
decode step on the port's own cache, and a decode step on the cache the
reference built.  ``use_kernels=True`` runs the kernels' plain versions
here, held to the reference with ``use_pallas=True`` (Pallas interpret
mode on the CPU).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_tiny_config as jax_tiny  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ATOL = 1e-4
SEQ, CACHE = 12, 16


def _cfgs(arch, kernels):
    jc = dataclasses.replace(jax_tiny(arch), dtype="float32",
                             use_pallas=kernels)
    tc = dataclasses.replace(get_tiny_config(arch), dtype="float32",
                             use_kernels=kernels)
    return jc, tc


@pytest.fixture(scope="module")
def yi():
    jc, tc = _cfgs("yi-9b", False)
    jm = jax_build(jc)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (2, SEQ),
                                             dtype=np.int32)
    return jparams, tparams, toks


class _Jitted:
    """The reference model's entry points under ``jax.jit`` (the same
    math; one compile instead of one per primitive)."""

    def __init__(self, model):
        self.logits = jax.jit(lambda p, t: model.logits(
            p, {"tokens": t}, remat=False)[0])
        self.prefill = jax.jit(lambda p, t, n: model.prefill(
            p, {"tokens": t}, n), static_argnums=2)
        self.decode_step = jax.jit(model.decode_step)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


def test_params_bridge_keeps_stacked_layout(yi):
    jparams, tparams, _ = yi
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(jl) == len(jax.tree_util.tree_leaves(tparams))
    for path, leaf in jl:
        t = tparams
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_bf16_leaves_bridge_exactly():
    a = np.asarray(jnp.asarray([1.0, -2.5, 3.1415, 1e-3], jnp.bfloat16))
    t = interop.params_from_numpy({"w": a}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_init_params_matches_reference_shapes_and_scales():
    _, tc = _cfgs("yi-9b", False)
    jc = dataclasses.replace(jax_tiny("yi-9b"), dtype="bfloat16")
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           jax.eval_shape(lambda: jax_build(jc).init(
                               jax.random.PRNGKey(0))))
    tc = dataclasses.replace(tc, dtype="bfloat16")
    tp = transformer.init_params(tc, torch.Generator().manual_seed(3),
                                 device="cpu")
    tshapes = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).split(".")[-1]), tp)
    assert tshapes == jshapes
    w = tp["blocks"]["0"]["mlp"]["w_down"].float()
    assert abs(float(w.std()) * np.sqrt(tc.d_ff) - 1.0) < 0.05
    assert float(tp["blocks"]["0"]["ln1"]["scale"].abs().max()) == 0.0


@pytest.mark.parametrize("kernels", [False, True])
def test_logits_prefill_decode_match_reference(yi, kernels):
    jparams, tparams, toks = yi
    jc, tc = _cfgs("yi-9b", kernels)
    jm, tm = _Jitted(jax_build(jc)), build_model(tc, device="cpu")
    tt = torch.from_numpy(toks)
    # full-sequence logits
    jl = jm.logits(jparams, jnp.asarray(toks))
    np.testing.assert_allclose(_np(tm.logits(tparams, {"tokens": tt})),
                               np.asarray(jl), atol=ATOL)
    # prefill -> one decode step on each side's own cache
    jlg, jcache = jm.prefill(jparams, jnp.asarray(toks), CACHE)
    tlg, tcache = tm.prefill(tparams, {"tokens": tt}, CACHE)
    np.testing.assert_allclose(_np(tlg), np.asarray(jlg), atol=ATOL)
    for k in jcache:
        np.testing.assert_allclose(_np(tcache[k]), np.asarray(jcache[k]),
                                   atol=ATOL)
    nxt = np.argmax(np.asarray(jlg)[:, -1], -1).astype(np.int32)[:, None]
    pos = np.full((2,), SEQ, np.int32)
    jd, jcache2 = jm.decode_step(jparams, jnp.asarray(nxt),
                                 jnp.asarray(pos), jcache)
    td, tcache2 = tm.decode_step(tparams, torch.from_numpy(nxt),
                                 torch.from_numpy(pos), tcache)
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=ATOL)
    for k in jcache2:
        np.testing.assert_allclose(_np(tcache2[k]), np.asarray(jcache2[k]),
                                   atol=ATOL)
    # the step left its input cache alone (functional, like .at[].set)
    np.testing.assert_array_equal(_np(tcache["pos0"]),
                                  np.asarray(jcache["pos0"]))


def test_decode_step_on_reference_built_cache(yi):
    """A cache the reference built (ring wrap-around included: the
    prompt is longer than the cache) drives the port's decode step."""
    jparams, tparams, toks = yi
    jc, tc = _cfgs("yi-9b", False)
    jm, tm = _Jitted(jax_build(jc)), build_model(tc, device="cpu")
    cache_len = 8                                  # < SEQ: ring wraps
    _, jcache = jm.prefill(jparams, jnp.asarray(toks), cache_len)
    tcache = interop.params_from_numpy(jax.tree.map(np.asarray, jcache),
                                       device="cpu")
    nxt = toks[:, :1].copy()
    pos = np.full((2,), SEQ, np.int32)
    for _ in range(2):
        jd, jcache = jm.decode_step(jparams, jnp.asarray(nxt),
                                    jnp.asarray(pos), jcache)
        td, tcache = tm.decode_step(tparams, torch.from_numpy(nxt),
                                    torch.from_numpy(pos), tcache)
        np.testing.assert_allclose(_np(td), np.asarray(jd), atol=ATOL)
        nxt = np.argmax(np.asarray(jd)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1
    for k in jcache:
        np.testing.assert_allclose(_np(tcache[k]), np.asarray(jcache[k]),
                                   atol=ATOL)


def test_stage_specs_and_cache_columns_match_reference():
    """The decode stage's row-level input columns (batch axis of every
    cache leaf found by the B=1 vs B=2 probe) equal the reference's."""
    from repro.models.registry import stage_input_specs as jax_specs
    from repro_torch.models.registry import stage_input_specs
    jc, tc = _cfgs("yi-9b", False)
    for stage in ("prefill", "decode"):
        want = jax_specs(jax_build(jc), stage, seq_len=SEQ,
                         cache_len=CACHE)
        got = stage_input_specs(build_model(tc, device="cpu"), stage,
                                seq_len=SEQ, cache_len=CACHE)
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
            assert got[k].device.type == "meta"


def test_granite_mqa_ungated_logits_match_reference():
    """granite-34b tiny: MQA (one kv head) and a 2-matrix gelu MLP."""
    jc, tc = _cfgs("granite-34b", False)
    jm = jax_build(jc)
    jparams = jm.init(jax.random.PRNGKey(1))
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (1, 8),
                                             dtype=np.int32)
    jl = _Jitted(jm).logits(jparams, jnp.asarray(toks))
    tl = build_model(tc, device="cpu").logits(
        tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
