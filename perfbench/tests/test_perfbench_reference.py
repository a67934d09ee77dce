"""The plain references against the program (``repro_torch``) on tiny
configurations on the CPU, at float32: the same weights (drawn by the
benchmark) and prompts give the same logits.  And the check reads the
served tokens back from the program's answers."""
import pytest
import torch

from conftest import tiny
from perfbench.lib import check, system, weights
from perfbench.reference import llama


def _setup(config, seed=5):
    from repro_torch.models import build_model
    res = tiny(config)
    cfg = res["config"]
    params = weights.draw(system.meta_tree(cfg), cfg["weights"], seed,
                          torch.device("cpu"))
    model = build_model(system.model_config(cfg), device="cpu")
    toks = torch.randint(0, cfg["model"]["vocab_size"], (3, 12),
                         generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)
    return cfg, params, model, toks


def test_llama_matches_the_program():
    cfg, params, model, toks = _setup("yi-9b")
    want = model.logits(params, {"tokens": toks})
    got = llama.logits_at(params, cfg["model"], toks, range(12))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want.float(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("config,dtype", [("yi-9b", "float32"),
                                        ("yi-9b", "bfloat16")])
def test_served_tokens_read_back_from_the_answer(config, dtype):
    """The decode steps' input tokens, identified from the answer's
    layer-0 cache slots, are the tokens fed in."""
    from perfbench.lib import window
    from repro_torch.models import build_model
    from repro_torch.models.registry import model_stage_op
    res = tiny(config, dtype=dtype)
    cfg = res["config"]
    params = weights.draw(system.meta_tree(cfg), cfg["weights"], 9,
                          torch.device("cpu"))
    model = build_model(system.model_config(cfg), device="cpu")
    pre = model_stage_op(model, params, "prefill", cache_len=64,
                         measure=False).fn
    dec = model_stage_op(model, params, "decode", cache_len=64,
                         measure=False).fn
    prompt = torch.randint(0, 512, (16,), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    fed = [3, 500, 7, 7]
    vals = pre(prompt)
    for t in fed:
        vals = dec(torch.tensor(t, dtype=torch.int32), *vals[1:])
    obs = window.observer(cfg["check"]["observe"], 16, 4)(vals)
    ids = check.nearest(check.features(params, cfg, cfg["check"][
        "observe"]), obs)
    assert ids.tolist() == fed
