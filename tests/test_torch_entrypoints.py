"""The port's serving entry points held to the reference package's on
the CPU: ``launch.serve.build_flow`` (and ``serve_batched.run`` on it),
the quickstart ensemble, the image cascade, and ``DeviceTable``'s
``from_table`` / ``reset_host_copies`` / ``ColumnBatch``.

Both packages run their tiny configs at float32 (each module's
``get_tiny_config`` is patched to add ``dtype="float32"``: the reference
builds its models inside its flows), with the reference's own
``Model.init(PRNGKey(seed))`` parameters bridged through
``interop.params_from_numpy``:

* serving completions are token-exact (greedy decode, same f32 ops);
* the quickstart's winning confidence is within 1e-5 (the softmax of one
  position over the same logits, summed in another order) and every
  member's label is equal;
* the cascade's labels and confident-answer counts are equal, with the
  escalation chain on its batched path (the forward closures' batch
  forms) and, one image a request as the reference sends them, on its
  per-row path.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.launch.serve as jax_serve  # noqa: E402
from repro.configs import get_tiny_config as jax_tiny  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.runtime import NetModel as JaxNet  # noqa: E402
from repro.runtime import Runtime as JaxRuntime  # noqa: E402
from repro.core.table import Table as JaxTable  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.core.table import (HOST_COPIES, ColumnBatch,  # noqa: E402
                                    DeviceTable, Table, reset_host_copies)
from repro_torch.examples import image_cascade as tic  # noqa: E402
from repro_torch.examples import quickstart as tqs  # noqa: E402
from repro_torch.examples import serve_batched as tsb  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TEXTS = ["request 0", "hello, world", "the quick brown fox", "zz"]


def _f32(get):
    return lambda arch: dataclasses.replace(get(arch), dtype="float32")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_params(arch, seed):
    """The reference's own f32 tiny params for ``arch`` from
    ``PRNGKey(seed)`` (as its flows draw them), and the bridged copy."""
    jp = jax_build(_f32(jax_tiny)(arch)).init(jax.random.PRNGKey(seed))
    return interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu")


@pytest.fixture
def f32(monkeypatch):
    """Both packages' entry points build their tiny models at f32."""
    monkeypatch.setattr(jax_serve, "get_tiny_config", _f32(jax_tiny))
    for mod in (tserve, tqs, tic):
        monkeypatch.setattr(mod, "get_tiny_config", _f32(get_tiny_config))


def _serve_ref(texts, new_tokens):
    flow, _ = jax_serve.build_flow("yi-9b", max_new_tokens=new_tokens)
    rt = JaxRuntime(n_cpu=2, net=JaxNet(scale=0.0))
    try:
        flow.deploy(rt, fusion=True)
        futs = [flow.execute(JaxTable([("text", str)], [(t,)]))
                for t in texts]
        return [f.result(timeout=300).to_dicts()[0]["completion"]
                for f in futs]
    finally:
        rt.stop()


def test_serve_build_flow_matches_reference(f32):
    want = _serve_ref(TEXTS, 4)
    flow, engine = tserve.build_flow("yi-9b", max_new_tokens=4,
                                     device="cpu",
                                     params=_ref_params("yi-9b", 0))
    assert engine.model.cfg.use_kernels and engine.cache_len == 128
    rt = tserve.Runtime(n_cpu=2, net=tserve.NetModel(scale=0.0),
                        device="cpu")
    try:
        flow.deploy(rt, fusion=True)
        futs = [flow.execute(Table([("text", str)], [(t,)])) for t in TEXTS]
        got = [f.result(timeout=300).to_dicts()[0]["completion"]
               for f in futs]
    finally:
        rt.stop()
    assert got == want
    assert len(set(want)) > 1      # the prompts lead to different tokens


def test_serve_batched_run_batches_and_matches_generate(f32):
    """The headless run cuts a burst into runtime batches, and each
    completion equals ``ServingEngine.generate`` on its own prompt."""
    params = _ref_params("yi-9b", 0)
    r = tsb.run(6, device="cpu", params=params, new_tokens=3)
    assert r["requests"] == 6 and sum(r["batch_sizes"]) == 6
    assert max(r["batch_sizes"]) > 1 and r["wedges"] == 0
    assert 0 < r["p50_ms"] <= r["p99_ms"]
    _, engine = tserve.build_flow("yi-9b", device="cpu", params=params)
    vocab = engine.model.cfg.vocab_size
    for i, c in enumerate(r["completions"]):
        text = f"request {i}".encode()[:16].ljust(16)
        toks = torch.as_tensor(np.frombuffer(text, np.uint8).astype(
            np.int32) % vocab)[None]
        want = engine.generate(params, {"tokens": toks}, 3)[0]
        assert c == " ".join(str(int(t)) for t in want)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: tserve.build_flow("yi-9b"),
                 lambda: tqs.load_model("yi-9b", 0),
                 lambda: tic._forward(*tic.SIMPLE),
                 lambda: DeviceTable.from_table(_table())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_quickstart_matches_reference(f32, monkeypatch):
    ref = _load("quickstart")
    monkeypatch.setattr(ref, "get_tiny_config", _f32(jax_tiny))
    members = [ref.load_model(arch, seed) for arch, seed in tqs.MODELS]
    fl = ref.build_flow(members)
    rt = JaxRuntime(n_cpu=4, net=JaxNet(scale=0.0))
    try:
        fl.deploy(rt, fusion=True)
        want = [fl.execute(JaxTable([("url", str)], [(u,)])).result(60)
                .to_dicts()[0] for u in tqs.URLS]
    finally:
        rt.stop()
    want_members = [[m(tqs.preproc(u)) for m in members] for u in tqs.URLS]
    params = {arch: _ref_params(arch, seed) for arch, seed in tqs.MODELS}
    got = tqs.run(device="cpu", params=params)
    for g, w in zip(got["answers"], want):
        assert g["group"] is None and abs(g["max"] - w["max"]) < 1e-5
    port = [tqs.load_model(arch, seed, device="cpu", params=params[arch])
            for arch, seed in tqs.MODELS]
    got_members = [[m(tqs.preproc(u)) for m in port] for u in tqs.URLS]
    for g, w, ans in zip(got_members, want_members, got["answers"]):
        assert [lab for lab, _ in g] == [lab for lab, _ in w]
        assert max(conf for _, conf in g) == ans["max"]
        assert (max(g, key=lambda p: p[1])[0]
                == max(w, key=lambda p: p[1])[0])


@pytest.mark.parametrize("per_request", [3, 1])
def test_image_cascade_matches_reference(f32, monkeypatch, per_request):
    ref = _load("image_cascade")
    monkeypatch.setattr(ref, "get_tiny_config", _f32(jax_tiny))
    want = ref.run(images=3)
    params = {tic.SIMPLE[0]: _ref_params(tic.SIMPLE[0], tic.SIMPLE[1]),
              tic.COMPLEX[0]: _ref_params(tic.COMPLEX[0], tic.COMPLEX[1])}
    got = tic.run(3, device="cpu", per_request=per_request, params=params)
    assert got["labels"] == want["labels"]
    assert got["escalated"] == want["escalated"]
    assert not got["vmap_fallback"] and not got["fallback"]
    if per_request > 1:
        # one batched dispatch of the escalation chain, nothing per row
        assert (got["batch_dispatches"], got["row_dispatches"]) == (1, 0)
    else:
        assert (got["batch_dispatches"], got["row_dispatches"]) == (0, 3)


def test_cascade_escalation_lowers_to_one_masked_chain():
    """The escalation branch is one BatchedJittedFuse whose steps are the
    filter and the complex model, the filter riding as a mask column."""
    from repro_torch.core import operators as ops
    from repro_torch.runtime import NetModel, Runtime

    rt = Runtime(n_cpu=1, n_gpu=1, net=NetModel(scale=0.0), device="cpu")
    try:
        dep = tic.build(rt)
        chain = tic.escalation_chain(dep)
        assert [type(m) for m in chain.ops] == [ops.Filter, ops.Map]
        assert chain._has_filter
        assert all(hasattr(m.fn, "__batched__") for m in chain.ops
                   if isinstance(m, ops.Map))
    finally:
        rt.stop()


# -- DeviceTable.from_table (cases of the reference's table tests) ----------

def _table(n=3, dim=4):
    return Table([("x", torch.Tensor)],
                 [(torch.ones(dim) * (i + 1),) for i in range(n)])


def test_device_table_roundtrip_preserves_identity():
    t = _table()
    t.rows[1].group = "g"
    dt = DeviceTable.from_table(t, pad_to=4, device="cpu")
    assert len(dt) == 3 and dt.cap == 4 and dt.donatable
    assert dt.column_index("x") == 0 and dt.device == torch.device("cpu")
    back = dt.to_table()
    assert [r.row_id for r in back.rows] == [r.row_id for r in t.rows]
    assert back.rows[1].group == "g"
    for a, b in zip(back.rows, t.rows):
        torch.testing.assert_close(a.values[0], b.values[0])
    assert ColumnBatch is DeviceTable


def test_device_table_from_numpy_rows():
    t = Table([("x", np.ndarray), ("n", int)],
              [(np.arange(3, dtype=np.float32) + i, i) for i in range(2)])
    dt = DeviceTable.from_table(t, device="cpu")
    assert [tuple(c.shape) for c in dt.columns] == [(2, 3), (2,)]
    assert dt.columns[0].dtype == torch.float32
    torch.testing.assert_close(dt.columns[1], torch.tensor([0, 1]))


@pytest.mark.parametrize("rows", [
    [(torch.ones(4),), (torch.ones(8),)],                    # ragged shape
    [(torch.ones(4),), (torch.ones(4, dtype=torch.int32),)],  # mixed dtype
    [("a",), ("b",)],                                         # not numeric
])
def test_device_table_rejects_unstackable_rows(rows):
    with pytest.raises(ValueError):
        DeviceTable.from_table(Table([("x", object)], rows), device="cpu")


def test_device_table_take_pads_and_masks():
    t = _table(n=4)
    dt = DeviceTable.from_table(t, pad_to=4, device="cpu")
    part = dt.take([1, 2], pad_to=4)       # re-padded to the bucket
    assert part.nrows == 2 and part.cap == 4 and part.mask is not None
    out = part.to_table()
    assert [r.row_id for r in out.rows] == [t.rows[1].row_id,
                                            t.rows[2].row_id]
    torch.testing.assert_close(out.rows[0].values[0], torch.full((4,), 2.0))


def test_device_table_host_copy_accounting():
    reset_host_copies()
    assert HOST_COPIES == {"stacks": 0, "gathers": 0}
    dt = DeviceTable.from_table(_table(), pad_to=4, device="cpu")
    assert HOST_COPIES == {"stacks": 1, "gathers": 0}
    dt.take([0, 1])                        # device-side: no host copy
    assert HOST_COPIES == {"stacks": 1, "gathers": 0}
    dt.to_table()
    assert HOST_COPIES == {"stacks": 1, "gathers": 1}
    reset_host_copies()
    assert HOST_COPIES == {"stacks": 0, "gathers": 0}


def _lowered_chain():
    from repro_torch.core.dataflow import Dataflow
    from repro_torch.core.ir import PhysicalPlan
    from repro_torch.core.passes import build_pipeline

    def f1(x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x * 1.01 + 0.1)

    def f2(x: torch.Tensor) -> torch.Tensor:
        return x * x - 0.5 * x

    fl = Dataflow([("x", torch.Tensor)])
    fl.output = fl.source.map(f1, names=["x"], gpu=True).map(
        f2, names=["x"], gpu=True)
    plan = build_pipeline(fusion=True, device="cpu").run(
        PhysicalPlan.from_dataflow(fl))
    return plan.ops[0].op, (f1, f2)


def test_device_chain_consumes_a_donated_input():
    """A donatable DeviceTable handed to a chain is consumed (its
    ``donatable`` flag cleared, so it cannot be donated twice) and the
    output batch is donatable; a shared (non-donatable) input keeps its
    flag and its values."""
    op, (f1, f2) = _lowered_chain()
    t = Table([("x", torch.Tensor)],
              [(torch.linspace(-1.0, 1.0, 8) * (i + 1),) for i in range(4)])
    dt = DeviceTable.from_table(t, pad_to=4, device="cpu")
    assert dt.donatable
    out = op.apply_batched([dt], emit_device=True, donate_out=True)
    assert len(out) == 4 and not dt.donatable and out.donatable
    for r, o in zip(t.rows, out.to_table().rows):
        torch.testing.assert_close(o.values[0], f2(f1(r.values[0])))
    dt2 = DeviceTable.from_table(t, pad_to=4, device="cpu")
    dt2.donatable = False
    before = dt2.columns[0].clone()
    op.apply_batched([dt2])
    assert not dt2.donatable
    torch.testing.assert_close(dt2.columns[0], before)
