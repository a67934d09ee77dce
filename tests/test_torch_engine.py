"""The port's serving engine, ``logits`` stage and video pipeline, held to
the reference package's on the CPU.

Tiny f32 configs with the reference's own parameters bridged
(``interop.params_from_numpy``) and the same numpy prompts:

* ``ServingEngine.generate``'s greedy tokens equal the reference's for
  yi-9b, gemma2-9b (prompts past its window), gemma2-9b with the int8
  cache and llama-3.2-vision-11b with media (cross gates opened: the
  reference initialises them to 0).  Sampling draws from a
  ``torch.Generator`` and cannot match ``jax.random``: it is held to
  itself;
* the ``logits`` stage's op against the reference's (max abs <= 1e-4),
  per row and natively batched, its cost hook, and ``stage_input_specs``;
* the vlm's ``prefill`` stage returns two columns fewer than its names,
  in both packages (its prefill gets no media, so it builds no
  ``ck``/``cv`` leaves);
* the tiny video pipeline: each frame's label counts equal the
  reference's, with the detector's parameters and the heads' weights
  bridged.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_tiny_config as jax_tiny  # noqa: E402
from repro.models.registry import model_stage_op as jax_stage_op  # noqa: E402
from repro.models.registry import stage_input_specs as jax_specs  # noqa: E402
from repro.serving.engine import make_engine as jax_engine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.examples import video_pipeline as tvp  # noqa: E402
from repro_torch.models.registry import model_stage_op, stage_input_specs  # noqa: E402
from repro_torch.serving import ServingEngine, make_engine  # noqa: E402

ATOL = 1e-4
SEQ, CACHE, NEW = 80, 64, 6
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"

#: (arch, config overrides, with media)
CASES = {
    "yi-9b": ("yi-9b", {}, False),
    "gemma2-9b": ("gemma2-9b", {}, False),
    "gemma2-9b+kv_quant": ("gemma2-9b", {"kv_quant": True}, False),
    "llama-3.2-vision-11b+media": ("llama-3.2-vision-11b", {}, True),
}


def _bridge(jparams):
    return interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")


def _pair(arch, **fields):
    """(reference engine, its params, port engine, bridged params), f32,
    the vlm's cross gates opened."""
    jc = dataclasses.replace(jax_tiny(arch), dtype="float32", **fields)
    tc = dataclasses.replace(get_tiny_config(arch), dtype="float32",
                             **fields)
    je = jax_engine(jc, cache_len=CACHE)
    jp = je.model.init(jax.random.PRNGKey(0))
    if jc.family == "vlm":
        jp = jax.tree_util.tree_map_with_path(
            lambda p, a: a + 0.5 if p[-1].key == "gate" else a, jp)
    te = make_engine(tc, cache_len=CACHE, device="cpu")
    return je, jp, te, _bridge(jp)


def _batches(cfg, media: bool, S=SEQ, B=2):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if media:
        m = (0.1 * rng.standard_normal(
            (B, cfg.num_media_tokens, cfg.d_model))).astype(np.float32)
        jb["media"], tb["media"] = jnp.asarray(m), torch.from_numpy(m)
    return jb, tb


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_greedy_matches_reference(case):
    arch, fields, media = CASES[case]
    je, jp, te, tp = _pair(arch, **fields)
    jb, tb = _batches(te.model.cfg, media)
    want = je.generate(jp, jb, max_new_tokens=NEW)
    got = te.generate(tp, tb, max_new_tokens=NEW)
    assert isinstance(got, np.ndarray) and got.shape == (2, NEW)
    np.testing.assert_array_equal(got, want)


def test_generate_sampled_follows_its_generator():
    _, _, te, tp = _pair("yi-9b")
    _, tb = _batches(te.model.cfg, False, S=8, B=1)

    def sample(seed):
        return te.generate(tp, tb, max_new_tokens=4, temperature=1.0,
                           generator=torch.Generator().manual_seed(seed))

    a = sample(1)
    assert a.shape == (1, 4) and a.max() < te.model.cfg.padded_vocab
    np.testing.assert_array_equal(a, sample(1))
    greedy = te.generate(tp, tb, max_new_tokens=4)
    # temperature without a generator is greedy, as in the reference
    np.testing.assert_array_equal(
        te.generate(tp, tb, max_new_tokens=4, temperature=1.0), greedy)


@pytest.mark.parametrize("arch", ["gemma2-9b", "llama-3.2-vision-11b"])
def test_logits_stage_matches_reference(arch):
    je, jp, te, tp = _pair(arch)
    jop = jax_stage_op(je.model, jp, "logits", model_name=arch, seq_len=16,
                       cache_len=CACHE, measure=False)
    top = model_stage_op(te.model, tp, "logits", model_name=arch,
                         seq_len=16, cache_len=CACHE, measure=False)
    assert top.names == jop.names == ["logits"]
    assert top.stage == jop.stage == "logits"
    toks = np.random.default_rng(2).integers(
        0, te.model.cfg.vocab_size, (3, 16), dtype=np.int32)
    rows = [top.fn(torch.from_numpy(t)) for t in toks]
    for t, row in zip(toks, rows):
        np.testing.assert_allclose(row.numpy(), np.asarray(jop.fn(
            jnp.asarray(t))), atol=ATOL)
    batched = top.fn.__batched__(torch.from_numpy(toks))
    np.testing.assert_allclose(batched.numpy(), torch.stack(rows).numpy(),
                               atol=ATOL)


def test_logits_stage_cost_hook_and_input_specs():
    je, jp, te, tp = _pair("yi-9b")
    op = model_stage_op(te.model, tp, "logits", seq_len=16, runs=1)
    d = op.cost_hook(2)
    assert {"mean_s", "p99_s", "cv", "runs", "out_bytes"} <= set(d)
    assert d["runs"] == 1 and d["p99_s"] >= d["mean_s"] > 0
    assert d["out_bytes"] == 2 * te.model.cfg.padded_vocab * 4
    for stage in ("logits", "prefill", "decode"):
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            jax_specs(je.model, stage, seq_len=16,
                                      cache_len=CACHE))
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in stage_input_specs(te.model, stage, seq_len=16,
                                             cache_len=CACHE).items()}
        assert got == want, stage
    with pytest.raises(ValueError, match="logits"):
        stage_input_specs(te.model, "train")


def test_vlm_prefill_stage_returns_fewer_columns_than_names():
    """The reference's vlm prefill stage passes no media, so its cache
    has no ``ck``/``cv`` leaves: the op yields 8 columns against 10
    names (tiny vlm: one plain and one cross layer a block).  The port
    copies it; both yield the same 8 columns."""
    je, jp, te, tp = _pair("llama-3.2-vision-11b")
    jop = jax_stage_op(je.model, jp, "prefill", seq_len=16,
                       cache_len=CACHE, measure=False)
    top = model_stage_op(te.model, tp, "prefill", seq_len=16,
                         cache_len=CACHE, measure=False)
    assert top.names == jop.names and len(top.names) == 10
    toks = np.random.default_rng(3).integers(
        0, te.model.cfg.vocab_size, (16,), dtype=np.int32)
    want = jop.fn(jnp.asarray(toks))
    got = top.fn(torch.from_numpy(toks))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.float()), np.asarray(w),
                                   atol=ATOL)


def _reference_video():
    spec = importlib.util.spec_from_file_location(
        "_ref_video_pipeline", EXAMPLES / "video_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_video_pipeline_counts_match_reference():
    """The reference example's own detector (tiny llama-3.2-vision, bf16,
    ``PRNGKey(0)``) and heads (``PRNGKey(1)``), bridged into the port's
    pipeline: each frame's label counts are the reference's."""
    from repro.runtime import NetModel, Runtime
    from repro.core.table import Table

    ref = _reference_video()
    frames = 4
    rt = Runtime(n_cpu=4, n_gpu=1, net=NetModel(scale=0.0))
    try:
        dep = ref.build(rt)
        rng = np.random.default_rng(0)
        want = [dep.execute(Table([("tokens", jax.Array)],
                                  [ref._frame(rng)])).result(60).to_dicts()
                for _ in range(frames)]
    finally:
        rt.stop()
    cfg = jax_tiny(tvp.ARCH)
    jp = ref.build_model(cfg).init(jax.random.PRNGKey(0))
    kp, kv = jax.random.split(jax.random.PRNGKey(1))
    v = cfg.vocab_size
    heads = tuple(torch.from_numpy(np.array(
        jax.random.normal(k, (v, 8), jnp.float32) * 0.1)) for k in (kp, kv))
    got = tvp.run(frames=frames, device="cpu", params=_bridge(jp),
                  heads=heads, controller=False)
    assert got["counts"] == want
    assert got["frames"] == frames and got["labels_per_frame"] == 2


def test_video_pipeline_controller_tick():
    r = tvp.run(frames=2, device="cpu")
    assert r["frames"] == 2 and r["labels_per_frame"] > 0
    assert r["controller"] in ("apply", "steady"), r
    assert len(r["frame_ms"]) == 2 and r["median_ms"] < 60_000


def test_engine_is_exported_and_defaults_to_the_card(monkeypatch):
    import repro_torch.serving as serving

    assert serving.ServingEngine is ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(get_tiny_config("yi-9b"))
