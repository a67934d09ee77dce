"""DeepSeekMoE-16B in the port (``configs/deepseek_moe_16b.py``): a dense
first layer, then MoE layers of fine-grained routed experts plus shared
experts, routing without renormalisation and an untied head.  The
reference package has no such model, so the port is held to the plain
float32 forward of ``repro_torch/reference/deepseek_moe.py``, on seeded
random weights at a tiny size (1 dense layer, 2 MoE layers of 8 experts,
top 3, shared experts of 128).

* A prefill and decode steps through the cache against the reference's
  full forward: float32 within 1e-4 relative with every route the same,
  bfloat16 within the reference package's bar of 0.05 relative.
* The router without renormalisation is a plain top-k of the softmax;
  with it (arctic, llama4) the weights are the renormalised ones, as
  before.
* The shared experts' one SwiGLU of 2F is the two experts of F summed.
* The glue kernels run in the dense layer and the shared experts (their
  equality with the eager glue is a case of the glue tests'
  ``test_glue_kernels_equal_the_eager_glue``).
* The dense prefix leaves yi-9b's, gemma2-9b's, arctic-480b's and
  llama4's layouts, weight trees and caches as the reference package has
  them, key for key and shape for shape.
* ``moe_apply_grouped.calls``/``.pairs`` count MoE layers x (1 + steps)
  and tokens x k; each MoE call is one ``moe@`` profiler range.
"""
import ast
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_tiny_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import (build_model, layer_ops, moe,  # noqa: E402
                                 transformer)
from repro_torch.reference import deepseek_moe as ref  # noqa: E402

ARCH = "deepseek-moe-16b"
N, S, STEPS, CACHE = 2, 12, 4, 32
REF_FILE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src",
                        "repro_torch", "reference", "deepseek_moe.py")


def _tiny(**over):
    return dataclasses.replace(get_tiny_config(ARCH), **over)


def _setup(dtype="float32", seed=0, **over):
    cfg = _tiny(dtype=dtype, **over)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    toks = torch.randint(0, cfg.vocab_size, (N, S + STEPS),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed + 1))
    return cfg, model, params, toks


def _served(model, params, toks):
    """Logits [N, STEPS + 1, V] of a prefill of the first S tokens and
    STEPS decode steps fed the rest, and the routes the program took (a
    list of experts [T, k] a MoE call)."""
    with moe.recorded_routes() as routes:
        logits, cache = model.prefill(params, {"tokens": toks[:, :S]},
                                      CACHE)
        out = [logits[:, -1]]
        for t in range(STEPS):
            lg, cache = model.decode_step(
                params, toks[:, S + t:S + t + 1],
                torch.full((N,), S + t, dtype=torch.int32), cache)
            out.append(lg[:, -1])
    return torch.stack(out, 1).float(), routes


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_prefill_and_decode_match_the_plain_reference_f32():
    cfg, model, params, toks = _setup()
    got, routes = _served(model, params, toks)
    want_routes = []
    want = ref.logits_at(params, dataclasses.asdict(cfg), toks,
                         range(S - 1, S + STEPS), routes=want_routes)
    assert _rel(got, want) < 1e-4
    n_moe = cfg.num_layers - cfg.first_k_dense
    assert len(want_routes) == n_moe and len(routes) == n_moe * (1 + STEPS)
    for layer, (experts, _, _) in enumerate(want_routes):
        experts = experts.reshape(N, S + STEPS, -1)
        assert torch.equal(routes[layer].reshape(N, S, -1),
                           experts[:, :S])
        for t in range(STEPS):
            assert torch.equal(routes[n_moe * (1 + t) + layer],
                               experts[:, S + t])


def test_prefill_and_decode_within_the_bf16_bar():
    cfg, model, params, toks = _setup("bfloat16")
    got, _ = _served(model, params, toks)
    want = ref.logits_at(params, dataclasses.asdict(cfg), toks,
                         range(S - 1, S + STEPS))
    assert _rel(got, want) < 0.05


@pytest.mark.parametrize("seed", [0, 1])
def test_router_without_renormalisation_is_a_plain_topk_of_softmax(seed):
    g = torch.Generator().manual_seed(seed)
    xf, w = torch.randn(16, 32, generator=g), torch.randn(32, 8, generator=g)
    probs = torch.softmax(xf @ w, dim=-1)
    top_w, top_i, _ = moe._router(xf, w, 3, renorm=False)
    want_w, want_i = torch.topk(probs, 3, dim=-1)
    assert torch.equal(top_i, want_i)
    assert torch.equal(top_w, want_w)
    # arctic and llama4 keep the renormalised weights, as before
    top_r, top_ri, _ = moe._router(xf, w, 3)
    assert torch.equal(top_ri, want_i)
    assert torch.equal(top_r, want_w / torch.clamp_min(
        want_w.sum(-1, keepdim=True), 1e-9))


def test_only_deepseek_routes_without_renormalisation():
    assert get_config(ARCH).norm_topk_prob is False
    for arch in ("arctic-480b", "llama4-maverick-400b-a17b"):
        assert get_config(arch).norm_topk_prob is True


@pytest.mark.parametrize("fused", [False, True])
def test_shared_experts_as_one_swiglu_equal_the_two_summed(fused):
    cfg = _tiny(dtype="float32", use_kernels=fused)
    F = cfg.shared_expert_d_ff // 2
    g = torch.Generator().manual_seed(3)
    D = cfg.d_model

    def expert():
        return {"w_gate": torch.randn(D, F, generator=g) / D ** 0.5,
                "w_up": torch.randn(D, F, generator=g) / D ** 0.5,
                "w_down": torch.randn(F, D, generator=g) / F ** 0.5}
    a, b = expert(), expert()
    both = {"w_gate": torch.cat([a["w_gate"], b["w_gate"]], 1),
            "w_up": torch.cat([a["w_up"], b["w_up"]], 1),
            "w_down": torch.cat([a["w_down"], b["w_down"]], 0)}
    x = torch.randn(2, 5, D, generator=g)
    ops = layer_ops.layer_ops(cfg, None)
    got = transformer._mlp(x, both, cfg, ops)
    want = transformer._mlp(x, a, cfg, ops) + transformer._mlp(
        x, b, cfg, ops)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_glue_kernels_run_in_the_dense_layer_and_the_shared_experts(
        monkeypatch):
    counts = {}
    card_of = build.card_of

    def counting(name, tensors):
        counts[name] = counts.get(name, 0) + 1
        return card_of(name, tensors)

    monkeypatch.setattr(build, "card_of", counting)
    cfg, model, params, toks = _setup(use_kernels=True)
    logits, cache = model.prefill(params, {"tokens": toks[:, :S]}, CACHE)
    L = cfg.num_layers
    # each MoE layer's call routes, places, activates and combines
    # through the MoE kernels' wrappers too
    n_moe = L - cfg.first_k_dense
    moe_calls = {"moe_route": n_moe, "moe_permute": n_moe,
                 "moe_combine": n_moe}
    assert counts == {"add_rmsnorm": 2 * L + 1, "rope": L,
                      "flash_attention": L, "gated_act": L + n_moe,
                      **moe_calls}
    counts.clear()
    model.decode_step(params, toks[:, S:S + 1],
                      torch.full((N,), S, dtype=torch.int32), cache)
    assert counts == {"add_rmsnorm": 2 * L + 1, "rope_cache_write": L,
                      "decode_attention": L, "gated_act": L + n_moe,
                      **moe_calls}


def test_first_layer_is_the_dense_one_the_check_reads():
    """``blocks/0`` holds layer 0 (dense), stacked over one layer, and the
    cache's ``v0[0]`` its value vectors at slot = position."""
    cfg, model, params, toks = _setup()
    b0, b1 = params["blocks"]["0"], params["blocks"]["1"]
    assert "mlp" in b0 and "moe" not in b0
    assert b0["attn"]["wv"].shape[0] == 1 and b0["ln1"]["scale"].shape[0] == 1
    assert b0["mlp"]["w_up"].shape == (1, cfg.d_model, cfg.d_ff)
    assert "moe" in b1 and b1["moe"]["router"].shape[0] == cfg.num_layers - 1
    assert b1["aux_mlp"]["w_up"].shape[-1] == cfg.shared_expert_d_ff
    assert params["head"].shape == params["embed"].shape
    _, cache = model.prefill(params, {"tokens": toks[:, :S]}, CACHE)
    assert sorted(cache) == ["k0", "k1", "pos0", "pos1", "v0", "v1"]
    emb = params["embed"][toks[:, :S].long()]
    h = ref.rmsnorm(emb, b0["ln1"]["scale"][0])
    v = (h @ b0["attn"]["wv"][0]).reshape(N, S, cfg.num_kv_heads, -1)
    torch.testing.assert_close(cache["v0"][0, :, :S], v, rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(cache["pos0"][0, 0, :S],
                       torch.arange(S, dtype=torch.int32))


def test_untied_head_is_the_head_leaf():
    cfg, model, params, toks = _setup()
    params["head"] = torch.zeros_like(params["head"])
    assert not model.logits(params, {"tokens": toks}).any()
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    assert "head" not in build_model(tied, device="meta").init()


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-9b", "arctic-480b",
                                  "llama4-maverick-400b-a17b"])
def test_other_layouts_trees_and_caches_are_the_reference_s(arch):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro.models import transformer as jax_tf
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert transformer.layer_groups(cfg) == [
        (0, *transformer.block_layout(cfg))]
    specs, n = transformer.block_layout(cfg)
    jspecs, jn = jax_tf.block_layout(jcfg)
    assert n == jn and [dataclasses.astuple(s) for s in specs] == [
        dataclasses.astuple(s) for s in jspecs]

    def flat(tree, pre=()):
        if isinstance(tree, dict):
            return {kp: v for k in tree
                    for kp, v in flat(tree[k], pre + (k,)).items()}
        return {pre: tuple(tree.shape)}
    port = flat(build_model(cfg, device="meta").init())
    want = flat(jax.tree.map(lambda s: s, jax.eval_shape(
        jax_build(jcfg).init, jax.random.PRNGKey(0))))
    assert port == want
    port_cache = flat(transformer.init_cache(cfg, 2, 16, device="meta"))
    want_cache = flat(jax.eval_shape(
        lambda: jax_tf.init_cache(jcfg, None, 2, 16)))
    assert port_cache == want_cache


def test_moe_counters_count_calls_and_routed_pairs():
    cfg, model, params, toks = _setup()
    moe.moe_apply_grouped.calls = moe.moe_apply_grouped.pairs = 0
    _served(model, params, toks)
    n_moe, k = cfg.num_layers - cfg.first_k_dense, cfg.num_experts_per_tok
    assert moe.moe_apply_grouped.calls == n_moe * (1 + STEPS)
    assert moe.moe_apply_grouped.pairs == n_moe * (N * S + STEPS * N) * k


def test_each_moe_call_is_one_moe_range():
    from torch.profiler import ProfilerActivity, profile
    cfg, model, params, toks = _setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _served(model, params, toks)
    names = [e.name for e in prof.events()]
    n_moe = cfg.num_layers - cfg.first_k_dense
    assert names.count("moe@-") == n_moe * (1 + STEPS)


def test_loss_and_its_gradient_run_over_both_groups():
    cfg, model, params, toks = _setup()
    for t in params["blocks"]["0"]["mlp"].values():
        t.requires_grad_(True)
    loss, parts = model.loss(params, {"tokens": toks})
    loss.backward()
    assert torch.isfinite(loss) and parts["aux"] > 0
    assert params["blocks"]["0"]["mlp"]["w_up"].grad.abs().sum() > 0


def test_the_reference_imports_neither_jax_nor_the_port():
    with open(REF_FILE) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods <= {"__future__", "contextlib", "typing", "torch"}


def test_full_size_counts():
    cfg = get_config(ARCH)
    assert cfg.param_count() == 16_375_726_080
    # active a token without the embedding lookup
    assert cfg.active_param_count() - cfg.padded_vocab * cfg.d_model == \
        2_618_933_248
    assert transformer.layer_groups(cfg)[0][2] == 1
    assert transformer.layer_groups(cfg)[1][2] == 27
