"""The control of the correctness check: the plain reference in float8 put
in the program's place (the gap of the token float8 puts first, at each
position of the same prompts and served tokens) must come out as not
correct.  On the CPU at a tiny bf16 size the control's widest gap lies
well above the program's; on the card, at each cell's own size, above the
cell's limit, which lies above the program's (``calibrate.py`` reads the
same numbers over more seeds)."""
import gc
import time

import pytest
import torch

from conftest import CONFIGS, tiny
from perfbench.lib import cells, harness


def _readings(res, seed, device, seconds):
    s = harness.setup(res, seed, device)
    try:
        w = harness.measure(s, seconds, seed)
    finally:
        s.system.stop()
    params = s.system.params
    del s.system
    gc.collect()
    return harness.judge(harness.Setup(res, seed, device, None), w, params,
                         quant="fp8")


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("config", CONFIGS)
def test_control_reads_far_above_the_program_on_cpu(config, seed):
    res = tiny(config, dtype="bfloat16", limit=0.5, load=20.0, sample=16)
    v = _readings(res, seed, torch.device("cpu"), 0.5)
    assert v["correct"], v["checks"]
    assert v["control_gap"] > 3 * v["checks"]["logit_gap"]["value"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(cell, cuda):
    res = cells.resolve(cell)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        t = time.perf_counter()
        v = _readings(res, seed, cuda, 15.0)
        limit = res["config"]["check"]["gap_limit"]
        assert v["checks"]["logit_gap"]["value"] <= limit
        assert v["control_gap"] > limit, (seed, v)
        assert time.perf_counter() - t < 300
