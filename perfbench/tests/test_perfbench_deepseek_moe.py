"""The ``deepseek-moe-16b`` configuration and the ``dsmoe16b-poisson1k``
cell's pieces on the CPU, at a tiny size that keeps the structure: a dense
first layer, then MoE layers of 8 experts (top 3) with shared experts, an
untied head.

* The benchmark's plain reference (``perfbench/reference/deepseek_moe.py``)
  gives the program's logits, and the port's own copy's.
* The check reads every fed token back from the program's answer through
  the configuration's ``check.observe`` (layer 0's values, column c4).
* A whole run of the cell on the CPU is correct, and its float8 control
  reads far above the program.
* Each fault of ``test_perfbench_faults.FAULTS`` planted under the timed
  path makes the run incorrect at this layout too (the dense group's
  ``blocks/0`` and cache ``k0``/``v0``, then the MoE group's).
* The new readers (``moe_launch_ms``, ``moe_launches_per_req``,
  ``expert_decode_roofline``) read hand-worked values from a hand-built
  trace, and None from one without ``moe@`` ranges or grouped kernels."""
import copy
import gc
import time
import types

import numpy as np
import pytest
import torch

from conftest import resolve
from perfbench.lib import cells, check, harness, moe_flops, system, weights
from perfbench.lib import window
from perfbench.lib.profile import DeviceOp, Profile
from perfbench.reference import deepseek_moe
from test_perfbench_faults import FAULTS

CONFIG, TRAFFIC = "deepseek-moe-16b", "poisson-1k"
#: the tiny shapes: every width cut, the tree's and the cache's structure
#: kept (1 dense layer, 2 MoE layers)
TINY = dict(num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
            head_dim=32, d_ff=256, expert_d_ff=64, shared_expert_d_ff=128,
            vocab_size=512, num_experts=8, num_experts_per_tok=3)
CPU = torch.device("cpu")


def tiny(dtype="float32", limit=1e-3, load=8.0, prompt_len=16, steps=4,
         sample=8):
    res = copy.deepcopy(resolve(CONFIG, TRAFFIC))
    cfg = res["config"]
    cfg["model"].update(TINY, dtype=dtype)
    cfg["serving"]["cache_len"] = 64
    cfg["knee_req_per_s"] = load / res["mix"]["load_of_knee"]
    cfg["check"].update(gap_limit=limit, sample=sample)
    res["mix"].update(prompt_len=prompt_len, decode_steps=steps)
    return res


def _setup(seed=5, dtype="float32"):
    from repro_torch.models import build_model
    cfg = tiny(dtype)["config"]
    params = weights.draw(system.meta_tree(cfg), cfg["weights"], seed, CPU)
    model = build_model(system.model_config(cfg), device="cpu")
    return cfg, params, model


def test_the_reference_matches_the_program():
    from repro_torch.reference import deepseek_moe as port_ref
    cfg, params, model = _setup()
    toks = torch.randint(0, 512, (3, 12), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5))
    want = model.logits(params, {"tokens": toks})
    got = deepseek_moe.logits_at(params, cfg["model"], toks, range(12))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want.float(), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, port_ref.logits_at(params, cfg["model"], toks,
                                               range(12)))


def test_float8_control_differs():
    cfg, params, _ = _setup()
    toks = torch.randint(0, 512, (2, 12), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(6))
    a = deepseek_moe.logits_at(params, cfg["model"], toks, range(12))
    b = deepseek_moe.logits_at(params, cfg["model"], toks, range(12),
                               quant="fp8")
    assert (a - b).abs().max() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_tokens_read_back_from_the_answer(dtype):
    from repro_torch.models.registry import model_stage_op
    cfg, params, model = _setup(9, dtype)
    assert cfg["check"]["observe"] == {"kind": "values", "column": "c4",
                                       "layer": 0}
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


def test_a_run_of_the_cell_on_the_cpu_is_correct():
    res = tiny(limit=1e-3, load=16.0, sample=8)
    out = harness.run(res, 2 ** 31 + 11, 0.5, False, CPU,
                      time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert {"throughput", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault, monkeypatch):
    from repro_torch.models.registry import Model
    name, make = FAULTS[fault]
    monkeypatch.setattr(Model, name, make(getattr(Model, name)))
    # an open loop in a dense burst, so that batches of several rows form
    res = tiny(limit=1e-3, load=60.0, sample=64)
    out = harness.run(res, 2 ** 31 + 77, 0.5, False, CPU,
                      time.perf_counter())
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [1, 2])
def test_control_reads_far_above_the_program_on_cpu(seed):
    res = tiny(dtype="bfloat16", limit=0.5, load=20.0, sample=16)
    s = harness.setup(res, seed, CPU)
    try:
        w = harness.measure(s, 0.5, seed)
    finally:
        s.system.stop()
    params = s.system.params
    del s.system
    gc.collect()
    v = harness.judge(harness.Setup(res, seed, CPU, None), w, params,
                      quant="fp8")
    assert v["correct"], v["checks"]
    assert v["control_gap"] > 3 * v["checks"]["logit_gap"]["value"]


# -- the readers over a hand-built trace --------------------------------------

MODEL = {"num_layers": 3, "first_k_dense": 1, "moe_layer_period": 1,
         "num_experts": 8, "num_experts_per_tok": 2, "d_model": 64,
         "d_ff": 512, "expert_d_ff": 32, "gated_mlp": True}
GROUPED = "cutlass::device_kernel<GemmUniversal<GroupProblemShape<...>>>"
#: host ranges of the traced part [0, 10]: two MoE calls inside, one cut
#: by the window's close; launches inside and outside them
HOST = [("exec@n", 0.5, 9.0), ("moe@-", 1.0, 1.5),
        ("cudaLaunchKernel", 1.1, 1.11), ("cuLaunchKernel", 1.2, 1.21),
        ("cudaLaunchKernel", 1.7, 1.71), ("moe@-", 2.0, 3.0),
        ("cudaLaunchKernelExC", 2.5, 2.51), ("moe@-", 9.5, 10.5),
        ("cudaLaunchKernel", 9.6, 9.61)]


def _profile(host=HOST, kernels=()):
    return Profile(0.0, 10.0, list(kernels), [], 0,
                   [h[0] for h in host],
                   np.array([h[1] for h in host], dtype=np.float64),
                   np.array([h[2] for h in host], dtype=np.float64), [])


def _ctx(profile):
    return types.SimpleNamespace(profile=profile, model=MODEL,
                                 requests_done_in_profile=lambda: 2)


def test_moe_launch_ms_and_launches_per_req_by_hand():
    ctx = _ctx(_profile())
    assert cells.reader("moe_launch_ms").read(ctx) == pytest.approx(
        (500.0 + 1000.0) / 2)
    # 1.1, 1.2, 2.5 and 9.6 lie inside moe@ ranges; 1.7 does not
    assert cells.reader("moe_launches_per_req").read(ctx) == 4 / 2


def _stream(spec):
    """Kernels one after another from (name, seconds) pairs."""
    out, t = [], 0.0
    for name, sec in spec:
        out.append(DeviceOp(name, t, t + sec, None))
        t += sec + 1e-4
    return out


def test_expert_decode_roofline_by_hand():
    """A decode call is the grouped kernels between a decode attention
    kernel and the next attention kernel; a prefill call's, a call cut
    by the traced part's start and the dense layer's are left out."""
    dec, pre = "decode_split_kernel<bf16>", "tc::flash_wgmma_kernel<128>"
    other = "nvjet_tst_64x8"
    ks = _stream(
        [(GROUPED, 5.0)]                       # a call cut by the start
        + [(pre, 1.0), (GROUPED, 7.0), (GROUPED, 7.0), (GROUPED, 7.0)]
        + [(dec, 0.1), (other, 0.1)]           # the dense layer
        + [(dec, 0.1), ("decode_combine_kernel", 0.1), (other, 0.1),
           (GROUPED, 1e-3), ("prepare_grouped_gemm_data", 1e-4),
           (GROUPED, 2e-3), (GROUPED, 3e-3), (other, 0.1)]
        + [(dec, 0.1), (GROUPED, 4e-3), (GROUPED, 4e-3), (GROUPED, 4e-3)]
        + [(dec, 0.1), (GROUPED, 9.0)])        # cut by the end
    got = cells.reader("expert_decode_roofline").read(
        _ctx(_profile(kernels=ks)))
    least = moe_flops.expert_products(1, 64, 32, 2, 3)["seconds"]
    want = 2 * least / (6e-3 + 12e-3) * 100
    assert got == pytest.approx(want)
    assert least == pytest.approx(2 * (2 * 3 * 64 * 32 + 2 * 64) / 3.35e12)


@pytest.mark.parametrize("name", ["moe_launch_ms", "moe_launches_per_req",
                                  "expert_decode_roofline"])
def test_new_readers_return_none_without_moe_ranges_or_kernels(name):
    """A program without the ``moe@`` scope (the parent) or a trace with
    no grouped kernel gives nothing to read, and neither does a run
    without a device trace."""
    other = [h for h in HOST if not h[0].startswith("moe@")]
    kernels = _stream([("decode_split_kernel", 0.1),
                       ("nvjet_tst_128x8", 0.1)] * 3)
    assert cells.reader(name).read(_ctx(_profile(
        host=other, kernels=kernels))) is None
    assert cells.reader(name).read(_ctx(None)) is None


def test_moe_layers_of_the_configurations():
    assert moe_flops.moe_layers(resolve(CONFIG, TRAFFIC)["config"][
        "model"]) == 27
    assert moe_flops.moe_layers(resolve("yi-9b")["config"]["model"]) == 0
