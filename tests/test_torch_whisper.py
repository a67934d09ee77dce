"""The port's audio family (whisper-medium), held to the reference
package's model on the CPU.

The tiny config at float32, the reference's own parameters bridged
through ``interop.params_from_numpy``, the same numpy prompts and stub
frame embeddings.  Checked at max abs <= 1e-4 (both sides compute in f32;
products and softmaxes sum in different orders):

* the param tree, ``_divisor_chunk`` and ``input_specs`` (frames for
  train and prefill);
* ``encode`` over frames;
* ``forward`` with frames, and without (zero frames, as the reference);
* the prefill's five cache leaves ``ck``, ``cv``, ``k``, ``pos``, ``v``
  (a cache shorter than the prompt too: the reference's ring layout);
* decode steps after the prefill;
* the compiled cascade's greedy tokens against the reference's
  ``reference_decode`` (its stages run the encoder over zero frames);
* ``ServingEngine.generate`` with frames against the reference's engine;
* frames change the logits, as the reference's
  ``test_whisper_encoder_frames_affect_decoder`` has it.
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
from repro.models import whisper as jax_whisper  # noqa: E402
from repro.serving.engine import make_engine as jax_engine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_tiny_config  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.examples import decode_cascade as tdc  # noqa: E402
from repro_torch.models import build_model, registry, whisper  # noqa: E402
from repro_torch.runtime import NetModel, Runtime  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
ARCH = "whisper-medium"
ATOL = 1e-4
S, CACHE, STEPS, NEW = 24, 40, 3, 5


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float64)


@pytest.fixture(scope="module")
def side():
    jc = dataclasses.replace(jax_tiny(ARCH), dtype="float32")
    tc = dataclasses.replace(get_tiny_config(ARCH), dtype="float32")
    jm = jax_build(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tc.vocab_size, (2, S), dtype=np.int32)
    frames = (0.1 * rng.standard_normal(
        (2, tc.encoder_seq, tc.d_model))).astype(np.float32)
    return {"jc": jc, "tc": tc, "jm": jm, "jp": jp,
            "tm": build_model(tc, device="cpu"),
            "tp": interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu"),
            "toks": toks, "frames": frames,
            "prefill": jax.jit(lambda p, b, n: jm.prefill(p, b, n),
                               static_argnums=2),
            "decode_step": jax.jit(jm.decode_step)}


def _batches(side, frames=True):
    jb = {"tokens": jnp.asarray(side["toks"])}
    tb = {"tokens": torch.from_numpy(side["toks"])}
    if frames:
        jb["frames"] = jnp.asarray(side["frames"])
        tb["frames"] = torch.from_numpy(side["frames"])
    return jb, tb


def test_param_tree_matches_reference():
    jc = jax_tiny(ARCH)            # bf16, the config's own dtype
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jax.eval_shape(lambda: jax_build(jc).init(
                            jax.random.PRNGKey(0))))
    tp = build_model(get_tiny_config(ARCH), device="cpu").init(
        torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).split(".")[-1]), tp)
    assert got == want


@pytest.mark.parametrize("s", [1500, 64, 24, 7, 1024, 2048])
def test_divisor_chunk_matches_reference(s):
    assert whisper._divisor_chunk(s) == jax_whisper._divisor_chunk(s)
    assert whisper._divisor_chunk(1500) == 750


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_match_reference(shape):
    jm = jax_build(jax_config(ARCH))
    tm = build_model(get_config(ARCH), device="cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jm.input_specs(JAX_SHAPES[shape]))
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).split(".")[-1]),
                       tm.input_specs(SHAPES[shape]))
    assert got == want
    if shape in ("train_4k", "prefill_32k"):
        assert got["frames"] == ((SHAPES[shape].global_batch, 1500, 1024),
                                 "bfloat16")


def test_encode_matches_reference(side):
    want = jax_whisper.encode(side["jp"], jnp.asarray(side["frames"]),
                              side["jc"], None)
    got = whisper.encode(side["tp"], torch.from_numpy(side["frames"]),
                         side["tc"])
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


@pytest.mark.parametrize("frames", [True, False])
def test_forward_matches_reference(side, frames):
    jb, tb = _batches(side, frames)
    want, _ = side["jm"].logits(side["jp"], jb, remat=False)
    got = side["tm"].logits(side["tp"], tb)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


@pytest.mark.parametrize("cache_len", [CACHE, S - 8])
def test_prefill_caches_match_reference(side, cache_len):
    jb, tb = _batches(side)
    jl, jcache = side["prefill"](side["jp"], jb, cache_len)
    tl, tcache = side["tm"].prefill(side["tp"], tb, cache_len)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    jleaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tleaves = registry._flatten(tcache)
    names = [p[-1] for p, _ in tleaves]
    assert names == [p[-1].key for p, _ in jleaves] == \
        ["ck", "cv", "k", "pos", "v"]
    for (path, ja), (_, ta) in zip(jleaves, tleaves):
        assert tuple(ta.shape) == ja.shape, path
        assert str(ta.dtype).split(".")[-1] == str(ja.dtype), path
        np.testing.assert_allclose(_np(ta), _np(ja), atol=ATOL,
                                   err_msg=str(path))


def test_decode_steps_match_reference(side):
    jb, tb = _batches(side)
    jl, jcache = side["prefill"](side["jp"], jb, CACHE)
    _, tcache = side["tm"].prefill(side["tp"], tb, CACHE)
    tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    for i in range(STEPS):
        pos = np.full((2,), S + i, np.int32)
        jl, jcache = side["decode_step"](side["jp"], tok[:, None],
                                         jnp.asarray(pos), jcache)
        ck = tcache["ck"]
        tl, tcache = side["tm"].decode_step(
            side["tp"], torch.from_numpy(np.array(tok)[:, None]),
            torch.from_numpy(pos), tcache)
        assert tcache["ck"] is ck           # never written, never copied
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL,
                                   err_msg=f"step {i}")
        tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)


class _Jitted:
    def __init__(self, model):
        self.prefill = jax.jit(model.prefill, static_argnums=2)
        self.decode_step = jax.jit(model.decode_step)


def test_cascade_matches_reference_decode(side):
    sys.path.insert(0, os.path.join(SRC, os.pardir))
    from examples import decode_cascade as jdc
    toks = np.random.default_rng(1).integers(
        0, side["tc"].vocab_size, (3, tdc.SEQ), dtype=np.int32)
    want = jdc.reference_decode(_Jitted(side["jm"]), side["jp"],
                                jnp.asarray(toks), steps=tdc.STEPS,
                                cache_len=tdc.CACHE)
    rt = Runtime(n_cpu=1, n_gpu=1, net=NetModel(scale=0.0), device="cpu")
    try:
        pre, dec = tdc.build_ops(side["tm"], side["tp"], name=ARCH)
        dep = tdc.build(rt, pre, dec, name="whisper-cascade")
        out = dep.execute(Table([("tokens", torch.Tensor)],
                                [(torch.from_numpy(t),) for t in toks])
                          ).result(120)
    finally:
        rt.stop()
    assert [int(r.values[0]) for r in out.rows] == want
    # the whole cascade is one batched chain
    (op,) = dep.plan.ops
    assert op.op.batch_dispatches == 1 and op.op.row_dispatches == 0


def test_generate_with_frames_matches_reference(side):
    je = jax_engine(side["jc"], cache_len=CACHE)
    jb, tb = _batches(side)
    want = je.generate(side["jp"], jb, NEW)
    got = ServingEngine(side["tm"], cache_len=CACHE).generate(
        side["tp"], tb, NEW)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_frames_change_the_logits(side):
    tb = {"tokens": torch.ones((1, 8), dtype=torch.int32)}
    fa = torch.zeros((1, side["tc"].encoder_seq, side["tc"].d_model))
    fb = torch.from_numpy(side["frames"][:1])
    la = side["tm"].logits(side["tp"], dict(tb, frames=fa))
    lb = side["tm"].logits(side["tp"], dict(tb, frames=fb))
    assert float((la - lb).abs().max()) > 1e-3     # cross-attn is ungated
    # and no frames are zero frames
    np.testing.assert_array_equal(
        _np(side["tm"].logits(side["tp"], tb)), _np(la))
